"""NPZD marine ecosystem model, in PyTorch.

Port of ``uvic_tpu.models.bgc.npzd`` (source/mom/npzd_src.F, Schmittner
et al. 2005 / Oschlies & Garcon 1999, and its caller tracer.F:256-521):

- the column loop becomes a Python loop down the levels carrying the
  shortwave attenuation and the detrital export chain, with every (j,i)
  column in the batch; the per-level outputs are stacked,
- the ``nbio`` ODE substeps run in an inner Python loop (all cells),
- calcite production collects over the column and redistributes with
  the rcak/rcab profiles; O2 consumption and denitrification follow the
  OCMIP limiters (tracer.F:458-480).

Nothing here reads a value back to the host, so a step that calls
``sources`` can be captured in a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...constants import DAYLEN, PI

TRCMIN = 5.0e-12   # npzd.h:68


@dataclass
class NpzdParams:
    """Namelist parameters in input units (per day, per m)."""
    kw: float = 0.04        # light attenuation of water [1/m]
    kc: float = 0.047       # light attenuation by phytoplankton
    ki: float = 5.0         # attenuation through ice/snow [1/m]
    abio: float = 0.18      # max growth rate a [1/day]
    bbio: float = 1.066
    cbio: float = 1.0
    k1n: float = 0.7        # N half saturation [mmol/m^3]
    nup: float = 0.025      # quadratic P mortality [1/day]
    nupt0: float = 0.02     # specific P mortality [1/day]
    gamma1: float = 0.925   # assimilation efficiency
    gbio: float = 1.575     # max grazing [1/day]
    epsbio: float = 1.6     # prey capture rate
    nuz: float = 0.34       # quadratic Z mortality
    gamma2: float = 0.01    # excretion [1/day]
    nud0: float = 0.048     # remineralization [1/day]
    wd0: float = 6.0        # detritus sinking at surface [m/day]
    alpha: float = 0.1      # P-I curve initial slope
    par: float = 0.43       # photosynthetically active fraction
    dtnpzd: float = 27000.0  # biology substep [s]
    redctn: float = 7.0     # C/N Redfield (input units; x1e-3 internally)
    redptn: float = 1.0 / 16.0
    redotn: float = 10.6
    capr: float = 0.018     # calcite production ratio
    dcaco3: float = 650000.0  # calcite remineralization depth [cm]
    jdiar: float = 0.5      # diazotroph growth reduction
    nitrogen: bool = False
    o2: bool = False
    carbon: bool = False
    alk: bool = False


def calcite_profiles(zw, dzt, dcaco3):
    """(rcak, rcab): calcite remineralization profiles (setmom.F:961-977)."""
    km = dzt.shape[0]
    rcak = np.empty(km)
    rcab = np.empty(km)
    rcak[0] = -(np.exp(-zw[0] / dcaco3) - 1.0) / dzt[0]
    rcab[0] = -1.0 / dzt[0]
    rcak[1:] = (-np.exp(-zw[1:] / dcaco3)
                + np.exp(-zw[:-1] / dcaco3)) / dzt[1:]
    rcab[1:] = np.exp(-zw[:-1] / dcaco3) / dzt[1:]
    return rcak, rcab


def solar_geometry(tlat_rad, relyr, kw):
    """(rctheta, dayfrac) of the seasonal declination (tracer.F:356-402).
    relyr is a 0-d tensor: it stays on the device, so a captured step
    reads the value of its static forcing buffer."""
    declin = torch.sin((torch.remainder(relyr, 1.0) - 0.22) * 2.0 * PI) * 0.4
    rctheta = torch.clamp(tlat_rad - declin, -1.5, 1.5)
    rctheta = kw / torch.sqrt(
        1.0 - (1.0 - torch.cos(rctheta) ** 2) / 1.33 ** 2)
    dayfrac = torch.clamp(-torch.tan(tlat_rad) * torch.tan(declin), max=1.0)
    dayfrac = torch.clamp(
        torch.arccos(torch.clamp(dayfrac, min=-1.0)) / PI, min=1e-12)
    return rctheta, dayfrac


def phi(u):
    """Integral of the P-I curve (npzd_src.F)."""
    s = torch.sqrt(1.0 + u * u)
    return torch.log(u + s) - (s - 1.0) / u


def _flag(x):
    return 0.5 + torch.sign(x - TRCMIN) * 0.5


class Npzd:
    """Precomputed per-level constants and the source computation."""

    def __init__(self, params: NpzdParams, grid, idx, c2dtts: float,
                 dtype=torch.float64, device="cpu"):
        p = params
        self.p = p
        self.idx = idx
        # unit conversions (setmom.F:937-957)
        self.redctn = p.redctn * 1.0e-3
        self.redotn = p.redotn * 1.0e-3
        self.redptn = p.redptn
        self.redotp = self.redotn / p.redptn
        self.redctp = self.redctn / p.redptn
        self.redntp = 1.0 / p.redptn
        self.k1n = p.k1n
        self.k1p = p.k1n * p.redptn
        self.kw = p.kw * 1.0e-2
        self.kc = p.kc * 1.0e-2
        self.ki = p.ki * 1.0e-2
        wd0 = p.wd0 * 1.0e2
        self.abio = p.abio / DAYLEN
        self.nup = p.nup / DAYLEN
        self.nupt0 = p.nupt0 / DAYLEN
        self.gbio = p.gbio / DAYLEN
        self.epsbio = p.epsbio / DAYLEN
        self.nuz = p.nuz / DAYLEN
        self.gamma2 = p.gamma2 / DAYLEN
        self.nud0 = p.nud0 / DAYLEN
        self.alpha = p.alpha / DAYLEN
        self.tap = 2.0 * self.alpha * p.par

        zt = np.asarray(grid.zt)
        zw = np.asarray(grid.zw)
        dzt = np.asarray(grid.dzt)

        def tn(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        # per-level constants as Python floats (the level loop is a host
        # loop) and as tensors (the column sums after it)
        self.wd = [float(x) for x in (wd0 + 4.0e-2 * zt) / DAYLEN / dzt]
        self.ztt = [float(x) for x in -zt + dzt / 2.0]
        self.rkwz = [float(x) for x in 1.0 / (self.kw * dzt)]
        self.dzt = [float(x) for x in dzt]
        self.dztr = [float(x) for x in 1.0 / dzt]
        self.dzt3 = tn(dzt)[:, None, None]
        rcak, rcab = calcite_profiles(zw, dzt, p.dcaco3)
        self.rcak = tn(rcak)[:, None, None]
        self.rcab = tn(rcab)[:, None, None]

        # biology substep counts (tracer.F:264-269); dtxcel = 1
        self.nbio = max(1, int(round(c2dtts / p.dtnpzd)))
        self.dtbio = c2dtts / self.nbio
        self.rdtts = 1.0 / c2dtts
        self.rnbio = 1.0 / self.nbio
        self.c2dtts = c2dtts

    # ------------------------------------------------------------------
    def _ode_substeps(self, tnpzd, gl, bct, impo, dzt_k, dayfrac, wwd,
                      rkw, nud, dtbio):
        """nbio Euler substeps of the NPZD ODEs (npzd_src.F)."""
        p = self
        nit = p.p.nitrogen
        f1 = torch.exp((-p.kw - p.kc * tnpzd[1]) * dzt_k)
        jmax = p.abio * bct
        gd = torch.clamp(jmax * dayfrac, min=1.0e-14)
        u1 = torch.clamp(gl / gd, min=1.0e-6)
        u2 = u1 * f1
        avej = gd * rkw * (phi(u1) - phi(u2))
        if nit:
            jmax_d = torch.clamp(p.abio * (bct - 2.6), min=0.0) * p.p.jdiar
            gd_d = torch.clamp(jmax_d * dayfrac, min=1.0e-14)
            u1d = torch.clamp(gl / gd_d, min=1.0e-6)
            u2d = u1d * f1
            avej_d = gd_d * rkw * (phi(u1d) - phi(u2d))
        nupt = p.nupt0 * bct

        zero = torch.zeros_like(tnpzd[0])
        bion, biop, bioz, biod = tnpzd[0], tnpzd[1], tnpzd[2], tnpzd[3]
        biono3 = tnpzd[4] if nit else zero
        biodiaz = tnpzd[5] if nit else zero
        expo_acc = zero
        aux = dict(graz=zero, morp=zero, morz=zero)
        for _ in range(p.nbio):
            u_p = torch.minimum(avej, jmax * bion / (p.k1p + bion))
            if nit:
                u_p = torch.minimum(u_p, jmax * biono3 / (p.k1n + biono3))
                u_d = torch.minimum(avej_d, jmax_d * bion / (p.k1p + bion))
                npp_d = torch.clamp(u_d * biodiaz, min=0.0)
                g_d = (p.gbio * p.epsbio * biodiaz ** 2
                       / (p.gbio + p.epsbio * biodiaz ** 2))
                graz_d = g_d * bioz
                morp_d = nupt * biodiaz
                no3upt_d = biono3 / (p.k1n + biono3) * npp_d
            npp = u_p * biop
            biop2 = biop * biop
            g_p = p.gbio * p.epsbio * biop2 / (p.gbio + p.epsbio * biop2)
            graz = g_p * bioz
            morp = p.nup * biop2
            morpt = nupt * biop
            morz = p.nuz * bioz * bioz
            remi = nud * bct * biod
            excr = p.gamma2 * bct * bioz
            expo = wwd * biod

            nf, pf, zf, df = _flag(bion), _flag(biop), _flag(bioz), \
                _flag(biod)
            graz, morp, morpt = graz * pf, morp * pf, morpt * pf
            morz, excr = morz * zf, excr * zf
            remi, expo = remi * df, expo * df
            if nit:
                no3f, dzf = _flag(biono3), _flag(biodiaz)
                npp = npp * nf * no3f
                npp_d = npp_d * nf
                graz_d = graz_d * dzf
                morp_d = morp_d * dzf
                no3upt_d = no3upt_d * no3f
                tot_npp = npp + npp_d
                tot_graz = graz + graz_d
            else:
                npp = npp * nf
                npp_d = graz_d = morp_d = no3upt_d = 0.0
                tot_npp = npp
                tot_graz = graz

            ts = dtbio
            bion = bion + ts * p.redptn * (remi + excr - tot_npp + morpt)
            biop = biop + ts * (npp - morp - graz - morpt)
            bioz = bioz + ts * (p.p.gamma1 * tot_graz - excr - morz)
            biod = biod + ts * ((1.0 - p.p.gamma1) * tot_graz + morp
                                + morp_d + morz - remi - expo + impo)
            if nit:
                biono3 = biono3 + ts * (remi + excr - npp + morpt
                                        - no3upt_d)
                biodiaz = biodiaz + ts * (npp_d - morp_d - graz_d)
            aux = dict(graz=aux["graz"] + graz, morp=aux["morp"] + morp,
                       morz=aux["morz"] + morz)
            expo_acc = expo_acc + expo
        delta = [bion - tnpzd[0], biop - tnpzd[1], bioz - tnpzd[2],
                 biod - tnpzd[3]]
        if nit:
            delta += [biono3 - tnpzd[4], biodiaz - tnpzd[5]]
        return delta, expo_acc, aux

    # ------------------------------------------------------------------
    def sources(self, t_tm1, kmt, tmask, swr_in, aice, hice, hsno,
                tlat_rad, relyr, c2dtts=None):
        """Source terms for all bgc tracers (tracer.F:256-521).

        t_tm1 : (nt, km, jmt, imt) tracers at tau-1
        swr_in: (jmt, imt) downward surface shortwave [erg/cm^2/s]
        relyr : 0-d tensor, fractional year
        c2dtts: a number overriding the instance's interval
        returns src: (nt, km, jmt, imt) with zeros for T,S.
        """
        p = self
        idx = self.idx
        km = t_tm1.shape[1]
        if c2dtts is None:
            dtbio, rdtts = p.dtbio, p.rdtts
        else:
            dtbio, rdtts = c2dtts / p.nbio, 1.0 / c2dtts
        rctheta, dayfrac = solar_geometry(tlat_rad, relyr, p.kw)
        swr = swr_in * 1e-3 * (
            1.0 + aice * (torch.exp(-p.ki * (hice + hsno)) - 1.0))

        temp = t_tm1[idx.itemp]
        bct_all = p.p.bbio ** (p.p.cbio * temp)
        if p.p.o2:
            o2 = t_tm1[idx.io2]
            nud_all = p.nud0 * (0.65 + 0.35 * torch.tanh(o2 * 1000.0 - 6.0))
        else:
            nud_all = torch.full_like(temp, p.nud0)

        names = ["po4", "phyt", "zoop", "detr"]
        if p.p.nitrogen:
            names += ["no3", "diaz"]
        tr_idx = [getattr(idx, "i" + n) for n in names]

        levels = torch.arange(km, device=t_tm1.device)[:, None, None]
        in_col = (levels < kmt[None]).to(temp.dtype)

        tnpzd_all = torch.clamp(torch.stack([t_tm1[i] for i in tr_idx]),
                                min=TRCMIN)
        expo = torch.zeros_like(swr)
        phin = torch.zeros_like(swr)
        snpzd_k, expo_k, dprca_k = [], [], []
        for k in range(km):
            tnpzd_k, mask_k = tnpzd_all[:, k], in_col[k]
            swr = swr * torch.exp(-p.kc * phin)
            phin = phin + tnpzd_k[1] * self.dzt[k]
            gl = p.tap * swr * torch.exp(self.ztt[k] * rctheta)
            impo = expo * self.dztr[k]
            delta, expo_col, aux = self._ode_substeps(
                tnpzd_k, gl, bct_all[k], impo, self.dzt[k], dayfrac,
                self.wd[k], self.rkwz[k], nud_all[k], dtbio)
            expo_rate = expo_col * p.rnbio
            snpzd_k.append(torch.stack([d * rdtts * mask_k for d in delta]))
            expo_k.append(expo_rate * mask_k)
            dprca_k.append((aux["morp"] + aux["morz"]
                            + aux["graz"] * (1.0 - p.p.gamma1))
                           * p.p.capr * p.redctn * p.rnbio * mask_k)
            expo = expo_rate * self.dzt[k] * mask_k
        snpzd = torch.stack(snpzd_k, dim=1)        # (tracer, km, j, i)
        expo_k = torch.stack(expo_k)
        dprca = torch.stack(dprca_k)

        # bottom detrital export remineralizes in the bottom cell
        is_bot = (levels == (kmt - 1)[None]).to(temp.dtype)
        kb = torch.clamp(kmt - 1, min=0).long()[None]
        expo_bot = torch.gather(expo_k, 0, kb)[0]
        snpzd[0] = snpzd[0] + is_bot * p.redptn * expo_bot[None]
        if p.p.nitrogen:
            snpzd[4] = snpzd[4] + is_bot * expo_bot[None]

        src = torch.zeros_like(t_tm1)
        for n, i in enumerate(tr_idx):
            src[i] = snpzd[n]

        # calcite production/remineralization (tracer.F:410-520)
        if p.p.carbon or p.p.alk:
            prca = torch.sum(dprca * self.dzt3 * in_col, dim=0)
            not_bot = in_col * (1.0 - is_bot)
            remin = (prca[None] * self.rcak * not_bot
                     + prca[None] * self.rcab * is_bot)
            if p.p.carbon:
                src[idx.idic] = (snpzd[0] * p.redctp - dprca) * in_col \
                    + remin
            if p.p.alk:
                src[idx.ialk] = (-snpzd[0] * p.redntp * 1e-3
                                 - 2.0 * dprca) * in_col + 2.0 * remin

        # oxygen consumption + denitrification (tracer.F:458-480)
        if p.p.o2:
            fo2 = 0.5 * torch.tanh(t_tm1[idx.io2] * 1000.0 - 5.0)
            so2 = snpzd[0] * p.redotp
            src[idx.io2] = -so2 * (0.5 + fo2) * in_col
            if p.p.nitrogen:
                no3flag = 0.5 + 0.5 * torch.sign(t_tm1[idx.ino3] - TRCMIN)
                deni = 800.0 * no3flag * so2 * (0.5 - fo2)
                src[idx.ino3] = src[idx.ino3] - deni * in_col

        return src
