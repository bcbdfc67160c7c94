"""Sea-ice 0-layer thermodynamics, in PyTorch.

Port of ``uvic_tpu.models.ice.thermo`` (source/ice/therm.F, the
Parkinson & Washington 1979 / Hibler 1979 zero-layer scheme): surface
energy balance over ice solved by a 10-trip Newton loop over all cells
at once, ice/snow growth-melt bookkeeping, and the flux adjustments
handed to the ocean.
Land-snow thermodynamics (the land branch, therm.F:110-245) is included
for the non-MTLM surface.

All quantities CGS; fluxes erg/cm^2/s; thickness cm (ice), snow as
physical thickness.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ...constants import EPSLN, SECDAY
from ..embm import constants as C


@dataclass
class IceState:
    hice: torch.Tensor   # (jmt, imt) mean ice thickness [cm]
    aice: torch.Tensor   # ice area fraction
    hsno: torch.Tensor   # snow thickness [cm]
    tice: torch.Tensor   # ice/snow surface temperature [C]
    uice: torch.Tensor   # (2, jmt, imt) ice velocity [cm/s]
    # EVP triangle stress tensor (4 triangles x {s11, s12, s22}), carried
    # across steps (evp.h sig11n..sig12w, the elastic closure's memory)
    sig: torch.Tensor    # (4, 3, jmt, imt)

    def replace(self, **kw) -> "IceState":
        return replace(self, **kw)


def init_ice_state(jmt, imt, dtype, device="cpu"):
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return IceState(hice=z(jmt, imt), aice=z(jmt, imt), hsno=z(jmt, imt),
                    tice=z(jmt, imt), uice=z(2, jmt, imt),
                    sig=z(4, 3, jmt, imt))


ICE_CALB = 0.25   # UVic_ESCM.F:1579 — NOTE: reference uses *coalbedo* names
SNO_CALB = 0.2    # UVic_ESCM.F:1580
DAMPICE = 5.0     # days, under-ice restoring timescale (UVic_ESCM.F:1571)
AMIN = 0.15
H0 = 1.0          # open-water demarcation thickness factor (therm.F ho)


def freezing_point(sss_psu):
    """Seawater freezing point [C] from salinity (gasbc.F:308)."""
    s = sss_psu
    return -0.0575 * s + 1.71e-3 * s ** 1.5 - 2.155e-4 * s ** 2


def _qsat_ice(t):
    return C.CSSH * torch.exp(21.8746 * t / (t + 265.5))


def ice_thermodynamics(ice: IceState, atm_sat, atm_shum, rh, sst, frzpt,
                       solins, aca, wspd, elev, tmsk,
                       dnswr, uplwr, upsens, upltnt, evap,
                       dts, zw1, aicel=None):
    """One thermodynamic ice step (therm.F).

    Inputs are the EMBM flux fields at tau (modified here for the
    ice-covered fraction) plus ocean SST/freezing point.  Returns the
    updated IceState, adjusted flux fields, and the ocean flux
    adjustments (heat, freshwater) from ice growth/melt.
    """
    dtype = atm_sat.dtype
    fa = dts / (C.RHOICE * C.FLICE)
    fb = 0.94 * C.RHOATM * C.CPATM
    fd = C.RHOATM / C.RHOICE
    fe = C.RHOATM * C.SLICE
    ff = C.RHOICE * C.FLICE
    fh = 21.8746 * 265.5
    fas = dts / (C.RHOSNO * C.FLICE)
    fds = C.RHOATM / C.RHOSNO
    ffs = C.RHOSNO * C.FLICE
    sla = zw1 * SECDAY / DAMPICE / 2.389e-8
    fptf = 0.0

    hice2, aice2, hsno2 = ice.hice, ice.aice, ice.hsno

    # snow/ice coalbedo: linear transition below 25 cm snow (therm.F:92-96)
    a_s = torch.clamp(hsno2 * 0.04 / (aice2 + EPSLN), max=1.0)
    ca = ICE_CALB * (1.0 - a_s) + SNO_CALB * a_s
    dswr = solins * aca * C.PASS * ca

    ai = aice2
    ao = 1.0 - ai
    tair_o = atm_sat
    tair_l = atm_sat - elev * C.RLAPSE
    fm_o = C.ESATM * (tair_o + C.C2K) ** 4
    fm_l = C.ESATM * (tair_l + C.C2K) ** 4

    # ---------------- ocean branch (therm.F:250-470) -------------------
    ftopo = dnswr - uplwr - upsens - upltnt
    fbot = sla * (frzpt - sst)
    dho = fa * (fbot - ftopo)     # open-water growth

    tcdh = C.CONDICE / (hice2 + 6.5 * hsno2 + EPSLN)
    qair = atm_shum
    fl = fe * C.DALT_I * wspd
    dusens = fb * C.DALT_I * wspd

    ti = ice.tice
    for _ in range(10):
        qice = _qsat_ice(ti)
        wet = qice > qair
        ultnt = torch.where(wet, fl * (qice - qair), 0.0)
        dultnt = torch.where(wet, fl * qice * fh / (ti + 265.5) ** 2, 0.0)
        usens = dusens * (ti - tair_o)
        ulwr = C.ESICE * (ti + C.C2K) ** 4 - fm_o
        dulwr = 4.0 * C.ESICE * (ti + C.C2K) ** 3
        f = dswr - ultnt - usens - ulwr - tcdh * (ti - frzpt)
        df = dultnt + dusens + dulwr + tcdh
        ti = ti + f / df
    ti = torch.clamp(ti, max=fptf)
    qice = _qsat_ice(ti)
    sub0 = torch.clamp(C.DALT_I * wspd * (qice - qair), min=0.0)
    ultnt_i = fe * sub0
    fcond = tcdh * (ti - frzpt)
    snowy = hsno2 > 0.0
    sub_vol = torch.where(snowy, fds * sub0, fd * sub0)  # thickness rate
    dha = -dts * sub_vol
    sub_ai = sub_vol * ai
    sub_mass = torch.where(snowy, sub_ai * C.RHOSNO, sub_ai * C.RHOICE)
    usens_i = dusens * (ti - tair_o)
    ulwr_i = C.ESICE * (ti + C.C2K) ** 4 - fm_o
    ftopi = dswr - ulwr_i - usens_i - ultnt_i

    has_ice = ai > 0.0
    tice_o = torch.where(has_ice, ti, sst)
    ftopi = torch.where(has_ice, ftopi, 0.0)
    fcond = torch.where(has_ice, fcond, 0.0)
    dha = torch.where(has_ice, dha, 0.0) * ai

    # blended fluxes over the cell (ice fraction + open fraction)
    dnswr_o = dnswr * ao + dswr * ai
    upltnt_o = upltnt * ao + ultnt_i * ai
    upsens_o = upsens * ao + usens_i * ai
    uplwr_o = uplwr * ao + ulwr_i * ai
    evap_o = evap * ao + torch.where(has_ice, sub_mass, 0.0)
    fw_sublim = dts * torch.where(has_ice, sub_mass, 0.0)

    # growth/melt bookkeeping (therm.F:370-420)
    dhi_ns = ai * fa * (fbot - ftopi) + ao * dho          # no snow case
    dh_ns = torch.maximum(-hice2, dhi_ns + dha)
    dhflxi_ns = dh_ns - dha
    dhs_ns = torch.zeros_like(dh_ns)
    dhflxs_ns = torch.zeros_like(dh_ns)

    dhi_s = ai * fa * (fbot - fcond)                      # snow case
    dhs_s = torch.where(tice_o >= fptf, ai * fas * (fcond - ftopi), 0.0)
    dhs_s = dhs_s + dha
    over = -dhs_s > hsno2
    dhi_s = torch.where(over,
                      dhi_s + C.RHOSNO / C.RHOICE * (dhs_s + hsno2),
                      dhi_s)
    dhs_s = torch.where(over, -hsno2, dhs_s)
    dhi_s = dhi_s + ao * dho
    dhflxs_s = dhs_s - dha
    dh_s = torch.maximum(-hice2, dhi_s)
    dhflxi_s = dh_s

    dh = torch.where(snowy, dh_s, dh_ns)
    dhi = torch.where(snowy, dhi_s, dhi_ns)
    dhs = torch.where(snowy, dhs_s, dhs_ns)
    dhflxi = torch.where(snowy, dhflxi_s, dhflxi_ns)
    dhflxs = torch.where(snowy, dhflxs_s, dhflxs_ns)

    # new area/thickness (therm.F:424-447)
    ai_div = torch.clamp(aice2, min=AMIN)
    aice3 = aice2 + ((1.0 - ai_div) * torch.clamp(dho, min=0.0) / H0
                     + 0.5 * torch.clamp(dhi, max=0.0) * ai_div
                     / (hice2 + EPSLN))
    hice3 = hice2 + dh
    hsno3 = hsno2 + dhs
    aice3 = torch.minimum(aice3, hice3)
    aice3 = torch.maximum(aice3, hice3 * 0.001)
    aice3 = torch.clamp(aice3, 0.0, 1.0)
    lost = aice3 == 0.0
    dhflxs = torch.where(lost, dhflxs - hsno3, dhflxs)
    hsno3 = torch.where(lost, 0.0, hsno3)

    # snow-to-ice conversion below the waterline (therm.F:449-459)
    zintfc = hice3 - (C.RHOSNO * hsno3 + C.RHOICE * hice3) / C.RHOOCN
    dhss = torch.where(zintfc < 0.0, C.RHOICE / C.RHOSNO * zintfc, 0.0)
    dhss = torch.maximum(dhss, -hsno3)
    hice3 = hice3 - C.RHOSNO / C.RHOICE * dhss
    hsno3 = torch.clamp(hsno3 + dhss, min=0.0)

    # ocean flux adjustments (therm.F:462-467): heat + freshwater
    dflux_sat = ff * dhflxi + ffs * dhflxs
    dflux_shum = -C.RHOICE * dhflxi - C.RHOSNO * dhflxs + fw_sublim

    # ---------------- land branch (snow on land, therm.F:110-245) ------
    as_l = torch.clamp(hsno2 / 1000.0, 0.0, 1.0)  # snow-masking fraction
    if aicel is not None:
        # continental ice sheets take full snow cover (therm.F:134 aice3
        # = max(aice3, aicel)): their surface runs the snow branch
        as_l = torch.maximum(as_l, torch.where(aicel > 0.5, 1.0, 0.0))
    fls = fe * C.DALT_I * wspd
    qair_l = rh * C.CSSH * torch.exp(17.67 * tair_l / (tair_l + 243.5))

    tl = ice.tice
    for _ in range(10):
        qice_l = _qsat_ice(tl)
        wet = qice_l > qair_l
        ultnt = torch.where(wet, fls * (qice_l - qair_l), 0.0)
        dultnt = torch.where(wet, fls * qice_l * fh / (tl + 265.5) ** 2, 0.0)
        usens = dusens * (tl - tair_l)
        ulwr = C.ESICE * (tl + C.C2K) ** 4 - fm_l
        dulwr = 4.0 * C.ESICE * (tl + C.C2K) ** 3
        tl = tl + (dswr - ultnt - usens - ulwr) / (dultnt + dusens + dulwr)
    tl = torch.clamp(tl, max=fptf)
    has_snow_l = as_l > 0.0
    qice_l = _qsat_ice(tl)
    sub_l = torch.clamp(fds * C.DALT_I * wspd * (qice_l - qair_l),
                        min=0.0)
    dha_l = torch.maximum(-hsno2, -dts * sub_l * as_l)
    ultnt_l = C.RHOSNO * C.SLICE * (-dha_l / (dts * as_l + EPSLN))
    usens_l = dusens * (tl - tair_l)
    ulwr_l = C.ESICE * (tl + C.C2K) ** 4 - fm_l
    ftopi_l = dswr - ulwr_l - usens_l - ultnt_l
    dhs_l = torch.where((tl >= fptf) & (ftopi_l > 0.0),
                      -as_l * fas * ftopi_l, 0.0)
    dhs_l = torch.clamp(torch.maximum(-(hsno2 + dha_l), dhs_l), max=0.0)
    hsno3_l = hsno2 + dhs_l + dha_l
    dflux_shum_land = dhs_l * C.RHOSNO / dts

    al = 1.0 - as_l
    dnswr_l = torch.where(has_snow_l, dnswr * al + dswr * as_l, dnswr)
    upltnt_l2 = torch.where(has_snow_l, upltnt * al + ultnt_l * as_l, upltnt)
    uplwr_l2 = torch.where(has_snow_l, uplwr * al + ulwr_l * as_l, uplwr)
    upsens_l2 = dnswr_l - upltnt_l2 - uplwr_l2 \
        + torch.where(has_snow_l, dhs_l * ffs / dts, 0.0)
    tice_l = torch.where(has_snow_l, tl, 0.0)

    # ---------------- blend ocean/land results -------------------------
    ocean = tmsk
    new = IceState(
        hice=ocean * hice3,
        aice=ocean * aice3 + (1 - ocean) * as_l,
        hsno=ocean * hsno3 + (1 - ocean) * hsno3_l,
        tice=ocean * tice_o + (1 - ocean) * tice_l,
        uice=ice.uice,
        sig=ice.sig,
    )
    fluxes = dict(
        dnswr=ocean * dnswr_o + (1 - ocean) * dnswr_l,
        uplwr=ocean * uplwr_o + (1 - ocean) * uplwr_l2,
        upsens=ocean * upsens_o + (1 - ocean) * upsens_l2,
        upltnt=ocean * upltnt_o + (1 - ocean) * upltnt_l2,
        evap=ocean * evap_o + (1 - ocean) * evap,
    )
    # per-category brine masses for O_convect_brine (therm.F:440-460
    # cbf/cba accumulators): brine_open, open-water (lead) formation (dho
    # only where positive: negative dho over ice-free water is melt of
    # ice that is not there); brine_ice, under-ice growth/melt and
    # snow-ice changes; [g/cm^2 a step], negative = freshwater removed
    # (salt rejected); brine_ao/brine_ai the open and ice fractions
    brine_open = ocean * (-C.RHOICE) * ao * torch.clamp(dho, min=0.0)
    brine_ice = ocean * (-C.RHOICE * dhflxi - C.RHOSNO * dhflxs) \
        - brine_open
    ocean_flux_adj = dict(
        heat=ocean * dflux_sat,
        freshwater=ocean * dflux_shum + (1 - ocean) * dflux_shum_land * dts,
        brine_open=brine_open,
        brine_ice=brine_ice * ocean,
        brine_ao=ocean * ao,
        brine_ai=ocean * ai,
    )
    return new, fluxes, ocean_flux_adj


def ice_advection(field, uice, vice, g, dts, niats=1, cyclic=True):
    """Upstream advection of an ice field on the B-grid (iceadv.F
    advupb).  ``field`` is (..., jmt, imt): leading axes (the categories
    and layers of ``cpts``) advect independently."""
    from ...ops.stencil import E, N, S, W, setbcx
    dt = dts / niats
    dyu_j = g.dyu[:, None]
    dxu_i = g.dxu[None, :]
    out = field
    for _ in range(niats):
        t = setbcx(out, cyclic)
        ue = (S(uice) * S(dyu_j) + uice * dyu_j) * g.dyt2r[:, None]
        vn = (W(vice) * W(dxu_i) + vice * dxu_i) * g.dxt2r[None, :]
        afe = ue * (t + E(t)) + torch.abs(ue) * (t - E(t))
        afn = vn * (t + N(t)) + torch.abs(vn) * (t - N(t))
        csu_j = g.csu[:, None]
        out = t - dt * g.cstr[:, None] * (
            (afe - W(afe)) * g.dxt2r[None, :]
            + (afn * csu_j - S(afn) * S(csu_j)) * g.dyt2r[:, None])
        z = torch.zeros_like(out[..., :1, :])
        out = torch.cat([z, out[..., 1:-1, :], z], dim=-2)
        out = setbcx(out, cyclic)
    return out
