"""Numerical stability monitors (stab.F parity, O_stability_tests), in
PyTorch.

Port of ``uvic_tpu.diag.stability``: per-cell CFL fractions for u, v
and the vertical advective velocities (stab.F:74-178: percent of the
local CFL limit, with umax = dx/(2 dtmax), vmax = dy/(2 dtmax), wmax =
dzw/(2 dtmax) and dtmax = max(dtuv, dtts*dtxcel)), grid Reynolds numbers
(|u| dx / visc, stab.F:216-248) and grid Peclet numbers (|u| dx / diff,
stab.F:249-281), each with the location (depth, lat, lon) of its
largest value, so that a destabilization is triaged from one log line.
``check`` returns host scalars, ``report`` the one-line yearly entry
that ``coupler.run.Run`` logs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EPSLN
from ..models.ocean.kernels import adv_vel


class StabilityMonitor:
    def __init__(self, ocean_model, cflcrt: float = 100.0):
        self.m = m = ocean_model
        g = m.params.grid
        cfg = m.cfg.ocean
        km, jmt, imt = g.km, g.jmt, g.imt
        self.shape = (km, jmt, imt)
        self.cflcrt = cflcrt

        def tn(x):
            return torch.as_tensor(np.array(x, np.float64), dtype=m.dtype,
                                   device=m.device)

        # local CFL limits (stab.F:90-96): dtmax = max(dtuv, dtts*dtxcel)
        dtmax = np.maximum(cfg.dtuv,
                           cfg.dtts * np.asarray(m.params.dtxcel))
        self.umax = tn(0.5 * np.asarray(g.csu)[None, :, None]
                       * np.asarray(g.dxu)[None, None, :]
                       / dtmax[:, None, None])
        self.vmax = tn(0.5 * np.asarray(g.dyu)[None, :, None]
                       / dtmax[:, None, None]) * torch.ones_like(
                           self.umax[:1, :1, :])
        self.wmax = tn(0.5 * np.asarray(g.dzw)[:km] / dtmax)[:, None, None] \
            * torch.ones_like(self.umax[:1])

        # the static background mixing coefficients of the reference's
        # approximation (its runtime additions, isopycnal K33, tidal and
        # PP mixing, are not included): diagnostic only
        if m.aniso_visc is not None:
            self.visc_e, self.visc_n = m.aniso_visc
        else:
            self.visc_e = tn(np.full((1, 1, 1), cfg.am))
            self.visc_n = tn(np.full((1, 1, 1), cfg.am))
        self.ah_eff = float(cfg.ah + (cfg.ahisop if cfg.isopycmix else 0.0))
        self.dxu3 = tn(np.asarray(g.dxu))[None, None, :]
        self.dyu3 = tn(np.asarray(g.dyu))[None, :, None]
        self.dzw3 = tn(np.asarray(g.dzw)[:km])[:, None, None]
        self.yt = np.asarray(g.yt)
        self.xt = np.asarray(g.xt)
        self.zt_km = np.asarray(g.zt) / 1.0e5

    def _fields(self, u_full, vbt, vbu):
        m = self.m
        # CFL percent-of-limit fields (stab.F:139-178)
        pcflu = 100.0 * torch.abs(u_full[0]) / self.umax * m.umask
        pcflv = 100.0 * torch.abs(u_full[1]) / self.vmax * m.umask
        pcflwu = 100.0 * torch.abs(vbu) / self.wmax * m.umask
        pcflwt = 100.0 * torch.abs(vbt) / self.wmax * m.tmask
        # grid Reynolds / Peclet (stab.F:216-281)
        reyx = torch.abs(u_full[0] * self.dxu3) / (self.visc_e + EPSLN) \
            * m.umask
        reyy = torch.abs(u_full[1] * self.dyu3) / (self.visc_n + EPSLN) \
            * m.umask
        reyz = torch.abs(vbu * self.dzw3) / (m.visc_cbu + EPSLN) * m.umask
        pecx = torch.abs(u_full[0] * self.dxu3) / self.ah_eff * m.umask
        pecy = torch.abs(u_full[1] * self.dyu3) / self.ah_eff * m.umask
        pecz = torch.abs(vbt * self.dzw3) / (m.diff_cbt + EPSLN) * m.tmask
        fields = dict(cflu=pcflu, cflv=pcflv, cflwu=pcflwu, cflwt=pcflwt,
                      reyx=reyx, reyy=reyy, reyz=reyz, pecx=pecx,
                      pecy=pecy, pecz=pecz)
        crt = self.cflcrt
        viol = torch.sum((pcflu >= crt) | (pcflv >= crt) | (pcflwu >= crt)
                         | (pcflwt >= crt))
        return fields, viol

    def check(self, ocean_state) -> dict:
        """Scan the state; returns {metric: value, metric_at: (depth_km,
        lat, lon)} host scalars."""
        m = self.m
        u = m.full_velocity(ocean_state.u, ocean_state.psi0)
        _, _, vbt, _, _, vbu = adv_vel(u[0], u[1], m.g, m.cyclic)
        fields, viol = self._fields(u, vbt, vbu)
        maxima = torch.stack([torch.max(f) for f in fields.values()])
        args = torch.stack([torch.argmax(f) for f in fields.values()])
        maxima, args = maxima.cpu().numpy(), args.cpu().numpy()
        out = {}
        for n, name in enumerate(fields):
            out[name] = float(maxima[n])
            kk, jj, ii = np.unravel_index(int(args[n]), self.shape)
            out[name + "_at"] = (round(float(self.zt_km[kk]), 2),
                                 round(float(self.yt[jj]), 1),
                                 round(float(self.xt[ii]), 1))
        out["n_cfl_violations"] = float(viol)
        return out

    def report(self, ocean_state) -> str:
        """One-line yearly triage entry (stab.F print analog)."""
        d = self.check(ocean_state)
        return ("stab: cfl% u={cflu:.0f}@{cflu_at} v={cflv:.0f}@{cflv_at}"
                " w={cflwt:.0f}@{cflwt_at} | Re x={reyx:.0f} y={reyy:.0f}"
                " z={reyz:.1f}@{reyz_at} | Pe x={pecx:.0f}@{pecx_at}"
                " z={pecz:.1f} | viol={n:.0f}").format(
                    n=d["n_cfl_violations"], **d)
