"""Multi-category sea ice: energy-conserving thermodynamics and ridging,
in PyTorch.

Port of ``uvic_tpu.models.ice.cpts`` (source/ice/cpts.F): the Bitz &
Lipscomb (1999) multi-layer, brine-pocket enthalpy thermodynamics over
a Thorndike et al. (1975) ice-thickness distribution with mechanical
redistribution (ridging), as configured by O_ice_cpts3/5/10
(source/ice/cpts.h:5-17, category bounds source/embm/setembm.F:492-530).
The reference's design is kept:

- every category carries ``nlay`` layers, so the distribution is one
  dense ``(ncat, nlay, jmt, imt)`` tensor and every solve vectorizes
  over all categories and cells at once;
- the temperature iteration is two Picard passes of a tridiagonal solve
  over the (<= 8) layers, a Thomas sweep written out layer by layer with
  the reference's own EPSLN/TINY guards (not ``ops/tridiag``): every loop
  has a fixed trip count, so a stage that calls it captures into a CUDA
  graph;
- ridging and re-binning are (ncat, ncat) transfer tensors computed in
  closed form from the static category bounds, applied as small
  contractions.

State is kept as "effective" (per grid-cell area) quantities: heff =
A*hi, hseff = A*hs, E(layer) = per-cell-area energy of melt (negative,
erg/cm^2), cpts.F:1054-1105.  All units CGS.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ...constants import EPSLN
from ..embm import constants as C
from .thermo import ice_advection

# ---- thermodynamic constants (source/ice/thermo.h, setembm.F:608-626) ----
CPICE = 2.054e7                  # fresh-ice heat capacity [erg/g/K]
RCPICE = C.RHOICE * CPICE        # [erg/cm^3/K]
RFLICE = C.RHOICE * C.FLICE      # volumetric latent heat of fusion
RFLSNO = C.RHOSNO * C.FLICE
RSLICE = C.RHOICE * C.SLICE      # volumetric latent heat of sublimation
ALPHA = 0.054                    # melting point depression [K/ppt]
GAMMA = RFLICE * ALPHA           # brine heat-capacity parameter
KAPPAI = 2.0340e5                # fresh-ice conductivity [erg/cm/s/K]
KAPPAS = 0.3100e5                # snow conductivity
KIMIN = 0.1000e5                 # floor on ice conductivity
BETA_K = 0.1172e5                # conductivity salinity parameter [erg/cm/s]
SALNEW = 5.0                     # new-ice salinity [ppt] (setembm.F:589)
SALTMAX = 5.0
TINY = 1.0e-10
GSTAR = 0.15                     # ridging participation cutoff (cpts.h)
CK = 1.0e2 * 100.0               # max ridged thickness param [cm] (cpts.h cK)
# lateral melt, Maykut & Perovich (thermo.h:70-75)
M1_LAT, M2_LAT = 3.0e-4, 1.36

# category thickness bounds hstar [cm] (setembm.F:498-530); index 0 is the
# open-water/new-ice demarcation, the last bound effectively infinite
HSTAR = {
    1: np.array([10.0, 2.0e5]),
    3: np.array([10.0, 50.0, 250.0, 2.0e5]),
    5: np.array([10.0, 40.0, 90.0, 200.0, 350.0, 2.0e5]),
    10: np.array([10.0, 25.0, 50.0, 75.0, 100.0, 140.0, 190.0, 330.0,
                  500.0, 700.0, 2.0e5]),
}
CPTS_FIELDS = ("A", "heff", "hseff", "Ts", "E", "uice")


def salinity_profile(nlay, dtype=np.float64):
    """Per-layer salinity [ppt] (setembm.F:594-598 sinusoidal profile)."""
    k = np.arange(1, nlay + 1)
    zrel = (k - 0.5) / nlay
    s = SALTMAX * 0.5 * (1.0 + np.sin(
        np.pi * (zrel ** (0.40706205 / (zrel + 0.57265966)) - 0.5)))
    return np.asarray(s, dtype=dtype)


@dataclass
class CptsState:
    """Thickness-distribution state ("effective" per-cell-area units)."""
    A: torch.Tensor      # (ncat, jmt, imt) area fraction per category
    heff: torch.Tensor   # (ncat, jmt, imt) ice volume per area [cm]
    hseff: torch.Tensor  # (ncat, jmt, imt) snow volume per area [cm]
    Ts: torch.Tensor     # (ncat, jmt, imt) surface temperature [C]
    E: torch.Tensor      # (ncat, nlay, jmt, imt) melt energy [erg/cm^2]
    uice: torch.Tensor   # (2, jmt, imt) shared dynamics velocity [cm/s]

    def replace(self, **kw) -> "CptsState":
        return replace(self, **kw)


def init_cpts_state(ncat, nlay, jmt, imt, dtype, device="cpu"):
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return CptsState(A=z(ncat, jmt, imt), heff=z(ncat, jmt, imt),
                     hseff=z(ncat, jmt, imt), Ts=z(ncat, jmt, imt),
                     E=z(ncat, nlay, jmt, imt), uice=z(2, jmt, imt))


def _hstar(hstar, like):
    """The category bounds as a tensor like ``like``.  The coupled model
    passes them as a tensor on its device, so that a captured stage
    copies nothing from the host."""
    return torch.as_tensor(hstar, dtype=like.dtype, device=like.device)


def _bounds(hstar, like):
    """(lower, upper) thickness bounds of the categories as tensors like
    ``like``: category k spans [lo_k, hi_k), thin ice kept in the first."""
    h = _hstar(hstar, like)
    return torch.cat([torch.zeros_like(h[:1]), h[1:-1]]), h[1:]


# ---------------------------------------------------------------------------
# enthalpy <-> temperature (cpts.F energ :676, getTmp :692, quad :717)
# ---------------------------------------------------------------------------

def energy_of_melt(T, S):
    """Volumetric energy of melting (negative) [erg/cm^3] at temp T [C]."""
    Tm = -ALPHA * S
    Tsafe = torch.clamp(T, max=-TINY)
    return -RFLICE - RCPICE * (Tm - Tsafe) - GAMMA * S / Tsafe


def temp_from_energy(q, S):
    """Invert energy_of_melt: midpoint temperature from q [erg/cm^3]."""
    qq = q + RFLICE - RCPICE * ALPHA * S
    B = -qq / RCPICE
    Cc = -GAMMA * S / RCPICE
    disc = torch.clamp(B * B * 0.25 - Cc, min=0.0)
    return torch.clamp(-B * 0.5 - torch.sqrt(disc), max=-TINY)


def _conductivity(T, S):
    """Untersteiner conductivity ki = kappai + beta*S/T (thermo.h:55-63)."""
    return torch.clamp(KAPPAI + BETA_K * S / torch.clamp(T, max=-TINY),
                       min=KIMIN)


def _qsat_ice(t):
    return C.CSSH * torch.exp(21.8746 * t / (t + 265.5))


# ---------------------------------------------------------------------------
# vertical heat transport in one category (tstm, cpts.F:2218-2677)
# ---------------------------------------------------------------------------

def _vertical_solve(Ts, Ti, hi, hs, saltz, fnet0, dfnet_dts, io_pen,
                    tbot, dt, nlay, has_ice):
    """Implicit conduction solve for (Ts, Ti[1..nlay]).

    fnet0/dfnet_dts: net atmospheric flux into the surface and its
    derivative w.r.t. Ts, linearized about the entering Ts.  io_pen:
    shortwave transmitted below the surface (absorbed in the top layer).
    Returns new (Ts, Ti, fcond_top, condb).
    """
    dz = torch.clamp(hi, min=0.1) / nlay        # layer thickness [cm]
    melt_ts = torch.zeros_like(Ts)              # the surface melts at 0C

    def picard(Ts_c, Ti_c):
        ki = _conductivity(Ti_c, saltz)          # (..., nlay)
        # interface conductivities (harmonic), top couples through snow
        k_int = 2.0 * ki[..., :-1] * ki[..., 1:] / (
            ki[..., :-1] + ki[..., 1:] + EPSLN) / dz[..., None]
        # surface <-> first layer: snow slab (zero heat capacity) in series
        k_top = 1.0 / (dz[..., None] * 0.5 / ki[..., :1]
                       + (hs / KAPPAS)[..., None])
        k_top = k_top[..., 0]
        k_bot = 2.0 * ki[..., -1] / dz           # last layer <-> bottom (Tw)
        cp_eff = RCPICE + GAMMA * saltz / (
            torch.clamp(Ti_c, max=-TINY) * torch.clamp(Ti, max=-TINY))
        rho_cp_dz = cp_eff * dz[..., None]

        # Ts eliminated through the linearized surface balance (the
        # caller passes fnet0 = -F0, F0 the net flux INTO the surface):
        #   Ts = (k_top*T1 + F0 - dfnet*Ts_in) / (k_top - dfnet)
        denom = k_top - dfnet_dts
        ts_new = (k_top * Ti_c[..., 0] - fnet0 - dfnet_dts * Ts) / (
            denom + EPSLN)
        ts_new = torch.minimum(ts_new, melt_ts)
        lower = torch.cat([-k_top[..., None], -k_int], dim=-1)
        upper = torch.cat([-k_int, -k_bot[..., None]], dim=-1)
        diag = rho_cp_dz / dt - lower - upper
        rhs = rho_cp_dz / dt * Ti
        rhs = torch.cat([rhs[..., :1] + (k_top * ts_new + io_pen)[..., None],
                         rhs[..., 1:]], dim=-1)
        rhs = torch.cat([rhs[..., :-1],
                         rhs[..., -1:] + (k_bot * tbot)[..., None]], dim=-1)

        # Thomas over the layers, batched over every (category, j, i)
        cp = torch.zeros_like(Ts)
        dp = torch.zeros_like(Ts)
        cps, dps = [], []
        for k in range(nlay):
            a, b = lower[..., k], diag[..., k]
            m = 1.0 / (b - a * cp + EPSLN)
            cp, dp = upper[..., k] * m, (rhs[..., k] - a * dp) * m
            cps.append(cp)
            dps.append(dp)
        x = dps[-1] - 0.0 * dps[-1]
        sol = [dps[-1]]
        for k in range(nlay - 2, -1, -1):
            x = dps[k] - cps[k] * x
            sol.append(x)
        Ti_new = torch.stack(sol[::-1], dim=-1)
        return ts_new, torch.clamp(Ti_new, min=-60.0, max=-TINY)

    Ts_n, Ti_n = picard(Ts, Ti)
    Ts_n, Ti_n = picard(Ts_n, Ti_n)
    ki = _conductivity(Ti_n, saltz)
    k_top = 1.0 / (dz[..., None] * 0.5 / ki[..., :1]
                   + (hs / KAPPAS)[..., None])[..., 0]
    fcond_top = k_top * (Ts_n - Ti_n[..., 0])     # into the interior
    # conductive flux up through the bottom interface (cpts.F:2652:
    # positive when the ice is colder than the water, the congelation
    # direction)
    condb = 2.0 * ki[..., -1] / dz * (tbot - Ti_n[..., -1])
    Ts_n = torch.where(has_ice, Ts_n, tbot)
    Ti_n = torch.where(has_ice[..., None], Ti_n, tbot[..., None])
    return Ts_n, Ti_n, torch.where(has_ice, fcond_top, 0.0), \
        torch.where(has_ice, condb, 0.0)


# ---------------------------------------------------------------------------
# conservative layer remapping after growth/melt (adjust, cpts.F:411-531)
# ---------------------------------------------------------------------------

def _remap_layers(q, hi_old, dht, dhb, q_new_bot, nlay, q_new_top=None):
    """Remap per-volume energies q (..., nlay) after the column changed by
    dht at the top (melt<0, or flood growth>0 with energy q_new_top) and
    dhb at the bottom (growth>0 with new-ice energy q_new_bot, or melt<0).
    Returns (q_new, hi_new), conserving the column's energy (the overlap
    integral is exact for piecewise-constant layer energies)."""
    hi_new = torch.clamp(hi_old + dht + dhb, min=0.0)
    # old material occupies [0, hi_old] in old coordinates; grown bottom
    # ice [hi_old, hi_old+dhb] with energy q_new_bot; flooded top ice
    # (dht>0) [-dht, 0] with energy q_new_top.  The new uniform grid in
    # old coordinates, origin at the new top surface:
    top_off = -dht
    grow = torch.clamp(dhb, min=0.0)
    grow_t = torch.clamp(dht, min=0.0)
    bot_edge = hi_old + torch.clamp(dhb, max=0.0)   # bottom melt trims
    lay = torch.arange(nlay + 1, dtype=q.dtype, device=q.device)
    new_edges = top_off[..., None] + hi_new[..., None] * lay / nlay
    old_edges = hi_old[..., None] * lay / nlay

    # overlap of new layer k with old layer m: (nlay, nlay) per cell
    nl = new_edges[..., :-1, None]
    nr = new_edges[..., 1:, None]
    ol = old_edges[..., None, :-1]
    orr = torch.minimum(old_edges[..., None, 1:], bot_edge[..., None, None])
    ov = torch.clamp(torch.minimum(nr, orr) - torch.maximum(nl, ol), min=0.0)
    e_from_old = torch.einsum("...km,...m->...k", ov, q)
    # overlap with the grown bottom slab [hi_old, hi_old+grow]
    gl = hi_old[..., None]
    gr = (hi_old + grow)[..., None]
    ovg = torch.clamp(torch.minimum(nr[..., 0], gr)
                      - torch.maximum(nl[..., 0], gl), min=0.0)
    e_new = e_from_old + ovg * q_new_bot[..., None]
    if q_new_top is not None:
        # overlap with the flooded top slab [-grow_t, 0]
        tl = (-grow_t)[..., None]
        ovt = torch.clamp(torch.clamp(nr[..., 0], max=0.0)
                          - torch.maximum(nl[..., 0], tl), min=0.0)
        e_new = e_new + ovt * q_new_top
    dz_new = torch.clamp(hi_new[..., None] / nlay, min=EPSLN)
    return e_new / dz_new, hi_new


# ---------------------------------------------------------------------------
# per-category thermodynamics (thermo, cpts.F:1541-2217; dh :1-210)
# ---------------------------------------------------------------------------

def cpts_thermo(st: CptsState, atm_sat, atm_shum, sst, frzpt,
                solins, aca, wspd, tmsk, dts, saltz, hstar,
                dnswr_ow, uplwr_ow, upsens_ow, upltnt_ow, evap_ow):
    """One thermodynamic step of the thickness distribution over ocean
    cells.  The *_ow arguments are the open-water fluxes of the EMBM flux
    routine (positive up except dnswr).  Returns the new state, the
    cell-blended fluxes (the contract of thermo.ice_thermodynamics), the
    ocean heat/freshwater adjustments and the total ice area."""
    nlay = st.E.shape[1]
    A, heff, hseff = st.A, st.heff, st.hseff
    has = A > TINY
    ai = torch.where(has, A, 1.0)
    hi = torch.where(has, heff / ai, 0.0)
    hs = torch.where(has, hseff / ai, 0.0)
    q = st.E / torch.clamp(heff[:, None] / nlay, min=EPSLN)   # per volume
    q = torch.clamp(q, max=-TINY)
    q_last_axis = torch.movedim(q, 1, -1)                    # (ncat,j,i,nlay)
    Ti = temp_from_energy(q_last_axis, saltz)

    # ---- per-category surface fluxes (thermo, cpts.F:1620-1800) -------
    tair = atm_sat
    fm = C.ESATM * (tair + C.C2K) ** 4
    snowpatch = torch.clamp(hs * 0.04, max=1.0)
    ca = 0.25 * (1.0 - snowpatch) + 0.2 * snowpatch        # coalbedos
    dswr = solins * aca * C.PASS * ca                      # (ncat,j,i)
    io_pen = 0.0 * dswr                                    # all absorbed
    qair = atm_shum
    fl = C.RHOATM * C.SLICE * C.DALT_I * wspd
    dusens = 0.94 * C.RHOATM * C.CPATM * C.DALT_I * wspd
    Ts0 = torch.clamp(st.Ts, max=0.0)
    qice = _qsat_ice(Ts0)
    wet = qice > qair
    ultnt = torch.where(wet, fl * (qice - qair), 0.0)
    dultnt = torch.where(wet, fl * qice * 21.8746 * 265.5
                         / (Ts0 + 265.5) ** 2, 0.0)
    usens = dusens * (Ts0 - tair)
    ulwr = C.ESICE * (Ts0 + C.C2K) ** 4 - fm
    dulwr = 4.0 * C.ESICE * (Ts0 + C.C2K) ** 3
    fnet0 = dswr - io_pen - ultnt - usens - ulwr           # at Ts0, into sfc
    dfnet = -(dultnt + dusens + dulwr)

    # ---- interior conduction solve ------------------------------------
    tbot = torch.broadcast_to(frzpt, A.shape)
    Ts_n, Ti_n, fcond_top, condb = _vertical_solve(
        Ts0, Ti, hi, hs, saltz, -fnet0, dfnet, io_pen * 0 + dswr * 0.0,
        tbot, dts, nlay, has)

    # surface fluxes at the solved Ts for the atmosphere budget
    qice_n = _qsat_ice(Ts_n)
    ultnt_n = torch.where(qice_n > qair, fl * (qice_n - qair), 0.0)
    usens_n = dusens * (Ts_n - tair)
    ulwr_n = C.ESICE * (Ts_n + C.C2K) ** 4 - fm
    fnet_n = dswr - ultnt_n - usens_n - ulwr_n

    # ---- growth / melt (dh, cpts.F:1-210) ------------------------------
    # ocean->ice heat flux (thermal relaxation, thermo.h Steele param)
    fbot = C.RHOOCN * 0.9576e7 * 0.0058 * 1.0 * (sst - frzpt)[None]
    fbot = torch.broadcast_to(fbot, A.shape)
    q_last = q_last_axis[..., -1]
    q_new = energy_of_melt(torch.clamp(tbot, max=-0.1), SALNEW)
    # bottom: growth if conduction exceeds the ocean's supply
    growth = (condb - fbot) * dts
    dhb = torch.where(growth > 0, growth / (-q_new),
                      growth / torch.clamp(q_last, max=-RFLICE * 0.05))
    # top: the residual surface imbalance melts snow, then ice
    fmelt = torch.clamp(fnet_n - fcond_top, min=0.0) * (Ts_n >= -TINY)
    dhs_melt = -torch.minimum(fmelt * dts / RFLSNO, hs)
    fmelt_i = torch.clamp(fmelt - (-dhs_melt) * RFLSNO / dts, min=0.0)
    q_top = q_last_axis[..., 0]
    dht = -fmelt_i * dts / torch.clamp(-q_top, min=RFLICE * 0.05)
    dht = torch.maximum(dht, -hi)
    # sublimation from the latent flux: snow first, the remainder from
    # the ice, so that each sublimated gram counts once
    sub = torch.where(qice_n > qair, C.DALT_I * wspd * (qice_n - qair), 0.0)
    sub_mass = dts * C.RHOATM * sub                        # [g/cm^2]
    dhs_sub = -torch.minimum(sub_mass / C.RHOSNO,
                             torch.clamp(hs + dhs_melt, min=0.0))
    sub_h_ice = torch.clamp(sub_mass - (-dhs_sub) * C.RHOSNO,
                            min=0.0) / C.RHOICE
    dht = torch.maximum(dht - sub_h_ice, -hi)
    dhs = dhs_melt + dhs_sub
    dhb = torch.maximum(dhb, -(hi + dht))

    q_re, hi_n = _remap_layers(q_last_axis, hi, dht, dhb, q_new, nlay)
    hs_n = torch.clamp(hs + dhs, min=0.0)

    # flooding: snow below the waterline becomes ice carrying the snow's
    # latent heat (q_flood = -RFLICE), so the column budget closes with
    # no ocean heat term (cpts.F adjust / freeboard)
    zintfc = hi_n - (C.RHOSNO * hs_n + C.RHOICE * hi_n) / C.RHOOCN
    dhf = torch.where(zintfc < 0.0,
                      torch.minimum(-zintfc * C.RHOICE / C.RHOSNO, hs_n),
                      0.0)
    hs_n = hs_n - dhf
    dhi_f = dhf * C.RHOSNO / C.RHOICE
    q_re, hi_n = _remap_layers(q_re, hi_n, dhi_f, 0.0 * dhi_f,
                               q_new, nlay, q_new_top=-RFLICE)

    # lateral melt (Maykut & Perovich, thermo.h:70-75)
    rside = torch.clamp(
        M1_LAT * torch.clamp(sst - frzpt, min=0.0)[None] ** M2_LAT
        * dts / torch.clamp(hi_n, min=10.0), 0.0, 0.5)
    A_n = torch.where(has, A * (1.0 - rside), 0.0)

    heff_n = torch.where(has, A_n * hi_n, 0.0)
    hseff_n = torch.where(has, A_n * hs_n, 0.0)
    E_n = torch.where(has[:, None], torch.movedim(q_re, -1, 1)
                      * (heff_n[:, None] / nlay), 0.0)

    # ---- new ice over open water (grownew, cpts.F:735-860) -------------
    A0 = torch.clamp(1.0 - A.sum(0), 0.0, 1.0)
    focean = dnswr_ow - uplwr_ow - upsens_ow - upltnt_ow \
        + C.RHOOCN * 0.9576e7 * 0.0058 * (frzpt - sst)
    freeze = torch.clamp(-focean, min=0.0) * (sst <= frzpt + 0.1)
    q_new0 = energy_of_melt(torch.clamp(frzpt, max=-0.1), SALNEW)
    hnew = freeze * dts / (-q_new0)
    a_new = torch.minimum(A0 * hnew / _hstar(hstar, A0)[0], A0)
    h_eff_new = A0 * hnew
    ocean = tmsk > 0
    A_n = torch.cat([(A_n[0] + torch.where(ocean, a_new, 0.0))[None],
                     A_n[1:]])
    heff_n = torch.cat([(heff_n[0] + torch.where(ocean, h_eff_new,
                                                 0.0))[None], heff_n[1:]])
    E_n = torch.cat([(E_n[0] + torch.where(
        ocean, q_new0 * h_eff_new / nlay, 0.0)[None])[None], E_n[1:]])

    # ---- ocean adjustments & blended fluxes ----------------------------
    # heat taken from (given to) the ocean by growth/melt and lateral melt
    dvol_ice = (heff_n - heff).sum(0)
    dvol_sno = (hseff_n - hseff).sum(0)
    heat_adj = RFLICE * dvol_ice + RFLSNO * dvol_sno       # erg/cm^2 / dts
    fresh_adj = -C.RHOICE * dvol_ice - C.RHOSNO * dvol_sno \
        + dts * C.RHOATM * (A * sub).sum(0)

    aice_tot = torch.clamp(A_n.sum(0), 0.0, 1.0)
    # the blend is a convex combination: open water clipped at 0, the
    # category weights renormalized where advection or the pre-ridging
    # state left the total area above 1
    asum = A.sum(0)
    norm = torch.where(asum > 1.0, 1.0 / torch.clamp(asum, min=TINY), 1.0)
    ao = torch.clamp(1.0 - asum, 0.0, 1.0)
    wsum = torch.where(has, A, 0.0) * norm

    def blend(f_ice, f_ow):
        return (wsum * f_ice).sum(0) + ao * f_ow

    fluxes = dict(
        dnswr=blend(dswr, dnswr_ow),
        uplwr=blend(ulwr_n, uplwr_ow),
        upsens=blend(usens_n, upsens_ow),
        upltnt=blend(ultnt_n, upltnt_ow),
        evap=blend(C.RHOATM * sub, evap_ow),
    )
    tmsk3 = tmsk[None] > 0
    new = CptsState(
        A=torch.where(tmsk3, A_n, 0.0),
        heff=torch.where(tmsk3, heff_n, 0.0),
        hseff=torch.where(tmsk3, hseff_n, 0.0),
        Ts=torch.where(tmsk3, Ts_n, 0.0),
        E=torch.where(tmsk3[:, None], E_n, 0.0),
        uice=st.uice)
    adj = dict(heat=tmsk * heat_adj, freshwater=tmsk * fresh_adj)
    return new, fluxes, adj, aice_tot


# ---------------------------------------------------------------------------
# category re-binning (movedown/moveup/zerocat, cpts.F:1415-1540)
# ---------------------------------------------------------------------------

def rebin(st: CptsState, hstar):
    """Move each category's content into the bin its mean thickness now
    occupies: a one-hot (ncat, ncat) transfer from the static bounds in
    place of the reference's sequential neighbour swaps."""
    ncat = st.A.shape[0]
    dtype = st.A.dtype
    has = st.A > TINY
    hi = torch.where(has, st.heff / torch.where(has, st.A, 1.0), 0.0)
    lo, hi_b = _bounds(hstar, st.A)
    # target[n, k] = 1 if category n's thickness falls in bin k
    t = ((hi[:, None] >= lo[None, :, None, None])
         & (hi[:, None] < hi_b[None, :, None, None])).to(dtype)
    t = torch.where(has[:, None], t, 0.0)
    # empty categories stay where they are (no transfer)
    keep = 1.0 - t.sum(1)
    eye = torch.eye(ncat, dtype=dtype, device=st.A.device)
    t = t + keep[:, None] * eye[:, :, None, None]

    def mv(x):
        return torch.einsum("nk...,n...->k...", t, x)

    return st.replace(A=mv(st.A), heff=mv(st.heff), hseff=mv(st.hseff),
                      Ts=mv(st.Ts * st.A) / torch.clamp(mv(st.A), min=TINY),
                      E=torch.einsum("nkji,nlji->klji", t, st.E))


# ---------------------------------------------------------------------------
# mechanical redistribution (mechred/ridge, cpts.F:862-1414)
# ---------------------------------------------------------------------------

def ridge(st: CptsState, divu, dts, hstar):
    """Ridging: close area under convergence (and wherever the total area
    exceeds 1) by piling thin ice into thicker categories.

    Participation follows Thorndike's b(h), linear in cumulative area and
    zero beyond GSTAR (ridging_mode, cpts.F:1168-1224).  Ice of mean
    thickness Hi ridges into a uniform-in-h slab on [2*Hi,
    2*sqrt(cK*Hi)] (ridge_matrices, cpts.F:1225-1341), mapped onto the
    category bins in closed form.
    """
    A = st.A
    A0 = torch.clamp(1.0 - A.sum(0), 0.0, 1.0)
    # cumulative area below each category (open water first)
    cum = torch.cumsum(torch.cat([A0[None], A], dim=0), dim=0)
    glo, ghi = cum[:-1], cum[1:]

    def bint(g):
        # participation integral of b(g) = 2/G*(1-g/G)
        return 2.0 * g / GSTAR - g * g / GSTAR ** 2

    part = torch.clamp(bint(torch.clamp(ghi, max=GSTAR))
                       - bint(torch.clamp(glo, max=GSTAR)), 0.0, 1.0)

    has = A > TINY
    Hi = torch.where(has, st.heff / torch.where(has, A, 1.0),
                     _hstar(hstar, A)[:-1, None, None])
    hmin_r = 2.0 * Hi
    hmax_r = torch.maximum(2.0 * torch.sqrt(CK * torch.clamp(Hi, min=TINY)),
                           hmin_r * (1.0 + 1e-6))
    # area shrink: participating area a -> a*Hi/hmean
    hmean = 0.5 * (hmin_r + hmax_r)
    shrink = 1.0 - Hi / hmean
    # closing needed this step: convergence + cap overflow
    closing = torch.clamp(-divu, min=0.0) * dts * (1.0 - A0) \
        + torch.clamp(A.sum(0) - 1.0, min=0.0)
    denom = (part * shrink).sum(0)
    scale = torch.where(
        denom > TINY,
        torch.clamp(closing / torch.clamp(denom, min=TINY), max=1.0), 0.0)
    w = part * scale[None]                         # area fraction ridged
    w = torch.clamp(w, max=0.8)

    # ridged volume onto the bins: uniform area density on [hmin_r,
    # hmax_r]; overlap with bin k = [lo_k, hi_k]
    lo, hb = _bounds(hstar, A)
    l_ = torch.maximum(hmin_r[:, None], lo[None, :, None, None])
    r_ = torch.minimum(hmax_r[:, None], hb[None, :, None, None])
    ov = torch.clamp(r_ - l_, min=0.0)
    span = torch.clamp((hmax_r - hmin_r)[:, None], min=TINY)
    a_r = w * Hi / hmean                           # ridged area from cat n
    M = ov / span * a_r[:, None]                   # area n->k
    # the integral of h over the overlap: volume n->k per unit area
    Nv = (torch.maximum(r_, l_) ** 2 - l_ ** 2) * 0.5 / span * a_r[:, None]
    vol_src = w * st.heff                          # participating volume
    vsum = torch.clamp(Nv.sum(1), min=TINY)
    Nv = Nv * (vol_src / vsum)[:, None]            # normalize: conserve vol
    frac_v = Nv / torch.clamp(vol_src[:, None], min=TINY)

    A_new = A * (1.0 - w) + M.sum(0)
    heff_new = st.heff * (1.0 - w) + Nv.sum(0)
    hseff_new = st.hseff * (1.0 - w) \
        + torch.einsum("nk...,n...->k...", frac_v, st.hseff * w)
    E_new = st.E * (1.0 - w)[:, None] \
        + torch.einsum("nk...,nl...->kl...", frac_v, st.E * w[:, None])
    Ts_new = torch.where(A_new > TINY,
                         (st.Ts * A * (1.0 - w)
                          + torch.einsum("nk...,n...->k...", M, st.Ts))
                         / torch.clamp(A_new, min=TINY), st.Ts)
    return st.replace(A=torch.clamp(A_new, 0.0, 1.0), heff=heff_new,
                      hseff=hseff_new, E=E_new, Ts=Ts_new)


def cpts_advect(st: CptsState, uice, vice, g, dts, niats=1, cyclic=True):
    """Advect every category field upstream (adv_ridge_cpts, cpts.F:579),
    all categories and layers in one batched sweep."""
    def adv(f):
        return ice_advection(f, uice, vice, g, dts, niats, cyclic)

    return st.replace(A=adv(st.A), heff=adv(st.heff), hseff=adv(st.hseff),
                      Ts=st.Ts, E=adv(st.E), uice=torch.stack([uice, vice]))


def aggregate(st: CptsState):
    """Collapse the distribution to the 0-layer coupling fields (hice,
    aice, hsno, tice)."""
    aice = torch.clamp(st.A.sum(0), 0.0, 1.0)
    hice = st.heff.sum(0)
    hsno = st.hseff.sum(0)
    w = torch.clamp(aice, min=TINY)
    tice = (st.Ts * st.A).sum(0) / w
    return hice, aice, hsno, tice
