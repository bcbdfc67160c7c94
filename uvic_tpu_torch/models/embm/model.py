"""EMBM: 2-D energy-moisture balance atmosphere, in PyTorch.

Port of ``uvic_tpu.models.embm.model`` (source/embm/, Fanning & Weaver
1996):

- ``fluxes``: shortwave, Thompson-Warren outgoing longwave, latent,
  sensible and longwave surface fluxes; the land surface temperature by
  a 10-trip Newton solve (fluxes.F:2-278),
- ``precipitate``: condensation above rhmax of saturation, snowfall,
  soil moisture and runoff (fluxes.F:280-446),
- implicit advection-diffusion of SAT and humidity on the 5-point
  upstream/diffusion operator (solve.F ``coef``), with the conserving
  row-1 operator, solved by the breakdown-guarded BiCGSTAB on the
  row-equilibrated system,
- leapfrog stepping with a forward mixing step every ``namix`` steps
  (embm.F:39-48).

``nats``, the mixing counter, is a host integer here (read once from a
restart): it picks the step type, as ``itt`` does for the ocean.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from ...constants import EPSLN
from ...ops.solvers import bicgstab_safe
from . import constants as C
from .insolation import annual_mean_insolation


@dataclass
class AtmState:
    """at = (nat, jmt, imt) atmospheric tracers [SAT degC, humidity g/g]
    at tau and tau-1; land surface fields; the mixing counter."""
    at: torch.Tensor
    atm1: torch.Tensor
    soilm: torch.Tensor    # (jmt, imt) soil moisture [cm]
    soilm1: torch.Tensor
    surf: torch.Tensor     # (jmt, imt) land surface temperature [C]
    nats: int              # mixing counter (host side)


class EmbmModel:
    def __init__(self, grid, topo, cfg, dtype=torch.float64, device="cpu",
                 elev=None, winds=None, diff_n=None,
                 atm_coalbedo=None, wspd=None, diff_t=None, diff_q=None,
                 dry_soil_albedo=0.0, check_every=None):
        self.cfg = cfg
        self.grid = grid
        self.topo = topo
        self.device = device = torch.device(device)
        self.dtype = dtype
        jmt, imt = grid.jmt, grid.imt

        def tn(x):
            return torch.as_tensor(np.array(x, np.float64), dtype=dtype,
                                   device=device)

        g = SimpleNamespace()
        # solver grid factors (setembm.F:453-480, 1-point-per-cell branch)
        csu, cst = grid.csu, grid.cst
        dyu, dyt = grid.dyu, grid.dyt
        dxu, dxt = grid.dxu, grid.dxt
        jm1 = np.maximum(np.arange(jmt) - 1, 0)
        im1 = np.maximum(np.arange(imt) - 1, 0)
        g.dsgrd = tn(csu[jm1] / (dyu[jm1] * cst * dyt))[:, None]
        g.dngrd = tn(csu / (dyu * cst * dyt))[:, None]
        g.asgrd = tn(csu[jm1] / (2.0 * cst * dyt))[:, None]
        g.angrd = tn(csu / (2.0 * cst * dyt))[:, None]
        g.dwgrd = tn(1.0 / (dxu[im1] * dxt))[None, :]
        g.degrd = tn(1.0 / (dxu * dxt))[None, :]
        g.azgrd = tn(1.0 / (2.0 * dxt))[None, :]
        g.cstr = tn(1.0 / cst)[:, None]
        self.g = g

        # masks: tmsk = 1 over ocean (embm convention)
        self.tmsk = tn((topo.kmt > 0).astype(np.float64))
        self.lmsk = 1.0 - self.tmsk

        # diffusivities (setembm.F:265-266, flat 5e9 fallback)
        base = np.full((jmt, imt), 5.0e9)
        self.diff_n = tn(base if diff_n is None else diff_n)
        self.diff_t = self.diff_n if diff_t is None else tn(diff_t)
        self.diff_q = self.diff_n if diff_q is None else tn(diff_q)

        self.elev = tn(np.zeros((jmt, imt)) if elev is None else elev)

        # winds at U cells [cm/s]; default: analytic easterlies/westerlies
        if winds is None:
            lat = grid.yu
            u = 600.0 * (np.sin(np.deg2rad(3.0 * lat))
                         - 0.5 * np.sin(np.deg2rad(lat)))
            winds = np.stack([np.broadcast_to(u[:, None], (jmt, imt)),
                              np.zeros((jmt, imt))])
        self.winds = tn(winds)
        if wspd is None:
            self.wspd = torch.sqrt(self.winds[0] ** 2
                                   + self.winds[1] ** 2) + 1.0
        else:
            self.wspd = tn(wspd)
        self.dry_soil_albedo = float(dry_soil_albedo)

        # annual-mean insolation (the seasonal cycle is the coupler's)
        lat2d = np.deg2rad(np.broadcast_to(grid.yt[:, None], (jmt, imt)))
        self.solins = annual_mean_insolation(
            torch.as_tensor(lat2d, dtype=dtype)).to(device)

        # coalbedos: atmosphere and ocean/land surface (setembm.F:952-959)
        if atm_coalbedo is None:
            atm_coalbedo = 0.85 - 0.13 * np.sin(
                np.deg2rad(np.broadcast_to(grid.yt[:, None],
                                           (jmt, imt)))) ** 2
        self.aca = tn(atm_coalbedo)
        sca_o = 0.87 + 0.02 * np.cos(
            2.0 * np.deg2rad(np.abs(np.broadcast_to(grid.yt[:, None],
                                                    (jmt, imt)))))
        alat = np.abs(np.broadcast_to(grid.yt[:, None], (jmt, imt)))
        sca_l = 0.80 - 0.55 / (1.0 + np.exp(-(alat - 63.0) / 4.0))
        self.sca = tn(np.where(topo.kmt > 0, sca_o, sca_l))

        self.cyclic = grid.cyclic
        # boundary rows and columns: identity equations of the transport
        edge = np.zeros((jmt, imt), bool)
        edge[[0, -1], :] = True
        edge[:, [0, -1]] = True
        self.edge = torch.as_tensor(edge, device=device)
        j = np.arange(jmt)
        self.row_first = torch.as_tensor((j == 1)[:, None], device=device)
        self.row_last = torch.as_tensor((j == jmt - 2)[:, None],
                                        device=device)
        self.interior_j = torch.as_tensor(
            ((j > 0) & (j < jmt - 1))[:, None], device=device)
        # dtype-aware solver tolerance: 1e-10 is out of reach in f32
        eps = float(torch.finfo(dtype).eps)
        self.solver_tol = max(cfg.solver_tol, 30.0 * eps)
        # BiCGSTAB loop form: trips between host reads of ``done``
        # (eager), or None for maxiter trips with the freeze (capture)
        self.check_every = check_every
        self.last_trips = []

    # ------------------------------------------------------------------
    def init_state(self, sat0=None, shum0=None) -> AtmState:
        jmt, imt = self.grid.jmt, self.grid.imt
        lat = np.broadcast_to(self.grid.yt[:, None], (jmt, imt))
        if sat0 is None:
            sat0 = 25.0 * np.cos(np.deg2rad(lat)) ** 2 - 2.0
        if shum0 is None:
            shum0 = 0.8 * C.CSSH * np.exp(
                17.67 * sat0 / (np.maximum(sat0, -40.0) + 243.5))
        at = torch.as_tensor(np.stack([sat0, shum0]), dtype=self.dtype,
                             device=self.device)
        z = torch.zeros((jmt, imt), dtype=self.dtype, device=self.device)
        return AtmState(at=at, atm1=at.clone(),
                        soilm=z + 0.5 * C.SOILMAX,
                        soilm1=z + 0.5 * C.SOILMAX,
                        surf=at[0].clone(), nats=0)

    def _bc(self, a):
        if self.cyclic:
            return torch.cat([a[..., -2:-1], a[..., 1:-1], a[..., 1:2]],
                             dim=-1)
        return a

    # ------------------------------------------------------------------
    def fluxes(self, state: AtmState, sst, dts=54000.0, anthro=0.0,
               wspd=None, solins=None, land_gc=None, sulph=None,
               hicel=None, aicel=None):
        """Surface/TOA fluxes at tau (fluxes.F:2-278); sst (jmt, imt).
        ``anthro``: CO2 radiative forcing; ``wspd`` overrides the
        prescribed wind speed; ``land_gc``: the land model's canopy
        conductance [cm/s] for the land surface solve's stomatal
        resistance (glsbc.F); ``sulph``: the sulphate coalbedo reduction
        (fluxes.F:101 O_sulphate_data, sca - sulph); ``hicel``/``aicel``:
        the continental ice sheets' elevation anomaly [cm] and 0/1 extent
        (O_landice_data: elev + hicel in the lapse-rate terms, the
        ice-sheet coalbedo on ice-covered land)."""
        at_sat = state.at[0]
        at_shum = state.at[1]
        telev = self.elev if hicel is None else self.elev + hicel
        teff = at_sat - telev * C.RLAPSE * C.RF1 * torch.exp(
            torch.clamp(-telev / C.RF2, min=-1.0))
        tair = at_sat - telev * C.RLAPSE

        ssh_eff = C.CSSH * torch.exp(17.67 * teff / (teff + 243.5))
        rh = torch.clamp(at_shum / (ssh_eff + EPSLN), 0.0, 1.0)

        if solins is None:
            solins = self.solins
        sca = self.sca if sulph is None \
            else torch.clamp(self.sca - sulph, min=0.0)
        if aicel is not None:
            sca = torch.where(aicel * self.lmsk > 0.5, 0.25, sca)
        dnswr = solins * self.aca * C.PASS * sca
        if self.dry_soil_albedo > 0.0:
            # dry land is brighter: scales the land surface absorption by
            # the soil-moisture deficit
            dry = 1.0 - torch.clamp(state.soilm / C.SOILMAX, 0.0, 1.0)
            dnswr = dnswr * (1.0 - self.dry_soil_albedo * dry * self.lmsk)

        b = C.TW_B
        # Thompson-Warren OLR: the cubic fit is clamped to its range and
        # continued linearly with a blackbody slope beyond it
        teff_c = torch.clamp(teff, -60.0, 45.0)
        outlwr = 1.0e3 * (
            b["b00"] + b["b10"] * rh + b["b20"] * rh ** 2
            + (b["b01"] + b["b11"] * rh + b["b21"] * rh ** 2) * teff_c
            + (b["b02"] + b["b12"] * rh + b["b22"] * rh ** 2)
            * teff_c ** 2
            + (b["b03"] + b["b13"] * rh + b["b23"] * rh ** 2)
            * teff_c ** 3
        ) + 5.0e3 * (teff - teff_c) - anthro

        fb = 0.94 * C.RHOATM * C.CPATM
        if wspd is None:
            wspd = self.wspd

        # ---- ocean points --------------------------------------------
        fg_o = C.DALT_O * wspd
        ssh_o = C.CSSH * torch.exp(17.67 * sst / (sst + 243.5))
        evap_o = torch.clamp(C.RHOATM * fg_o * (ssh_o - at_shum), min=0.0)
        upsens_o = fb * fg_o * (sst - tair)
        uplwr_o = (C.ESOCN * (sst + C.C2K) ** 4
                   - C.ESATM * (tair + C.C2K) ** 4)

        # ---- land points: Newton solve for surface temperature -------
        fm = C.ESATM * (tair + C.C2K) ** 4
        if land_gc is None:
            rs_stom = 150.0                            # fixed veg_rs [s/cm]
        else:
            rs_stom = torch.where(land_gc > 1.0e-8,
                                  1.0 / (land_gc + EPSLN), 150.0)
            rs_stom = torch.clamp(rs_stom, 20.0, 2.0e4)
        sr = 1.0 / (C.DALT_V * wspd + EPSLN) + rs_stom
        fh = torch.clamp((state.soilm / C.SOILMAX) ** 0.25, EPSLN, 1.0)
        fl = fh * C.RHOATM * C.VLOCN / sr
        fg_l = fh * C.RHOATM / sr
        dusens = fb * C.DALT_V * wspd
        qair = rh * C.CSSH * torch.exp(17.67 * tair / (tair + 243.5))

        tlnd = state.surf
        for _ in range(10):
            qlnd = C.CSSH * torch.exp(17.67 * tlnd / (tlnd + 243.5))
            wet = qlnd > qair
            ultnt = torch.where(wet, fl * (qlnd - qair), 0.0)
            dultnt = torch.where(
                wet, fl * qlnd * 17.67 * 243.5 / (tlnd + 243.5) ** 2, 0.0)
            usens = dusens * (tlnd - tair)
            ulwr = C.ESLND * (tlnd + C.C2K) ** 4 - fm
            dulwr = 4.0 * C.ESLND * (tlnd + C.C2K) ** 3
            f = dnswr - ultnt - usens - ulwr
            df = dultnt + dusens + dulwr
            tlnd = tlnd + f / df
        qlnd = C.CSSH * torch.exp(17.67 * tlnd / (tlnd + 243.5))
        evap_l = torch.clamp(fg_l * (qlnd - qair), min=0.0)
        evap_l = torch.minimum(evap_l, state.soilm / dts)
        upltnt_l = C.VLOCN * evap_l
        uplwr_l = C.ESLND * (tlnd + C.C2K) ** 4 - fm
        # the land cannot store the residual
        upsens_l = dnswr - upltnt_l - uplwr_l

        ocean = self.tmsk
        evap = ocean * evap_o + (1 - ocean) * evap_l
        upsens = ocean * upsens_o + (1 - ocean) * upsens_l
        uplwr = ocean * uplwr_o + (1 - ocean) * uplwr_l
        upltnt = C.VLOCN * evap_o * ocean + upltnt_l * (1 - ocean)
        surf_new = torch.where(ocean > 0, state.surf, tlnd)

        return dict(dnswr=dnswr, outlwr=outlwr, evap=evap, rh=rh,
                    upsens=upsens, uplwr=uplwr, upltnt=upltnt,
                    surf=surf_new, tair=tair, teff=teff)

    # ------------------------------------------------------------------
    def _transport_matvec(self, x, coefs):
        cc, cn, cs, ce, cw = coefs
        xb = self._bc(x)
        y = (xb if cc is None else cc * xb) \
            + cn * torch.roll(xb, -1, 0) + cs * torch.roll(xb, 1, 0) \
            + ce * torch.roll(xb, -1, 1) + cw * torch.roll(xb, 1, 1)
        # boundary rows/columns are identity equations (the duplicated
        # cyclic columns are reinstalled by _bc after the solve)
        return torch.where(self.edge, x, y)

    def _coef(self, diff, dts, winds=None):
        """Implicit operator coefficients (solve.F coef:424-620), with
        rows 1..jmt-2 active and the face fluxes of rows 1 and jmt-2 at
        the boundary zeroed: the conserving row-1 operator."""
        g = self.g
        dn_s = torch.roll(diff, 1, 0)                  # dn(i,j-1)
        cs0 = torch.where(self.row_first, 0.0, dn_s)
        cn0 = torch.where(self.row_last, 0.0, diff)
        cs = -dts * cs0 * g.dsgrd
        cn = -dts * cn0 * g.dngrd
        de_w = torch.roll(diff, 1, 1)
        cw = -dts * de_w * g.cstr ** 2 * g.dwgrd
        ce = -dts * diff * g.cstr ** 2 * g.degrd
        cc = 1.0 - cs - cn - cw - ce

        # upstream advection from the prescribed wind field at U cells
        if winds is None:
            winds = self.winds
        wx, wy = winds[0], winds[1]
        vs = torch.roll(wy, (1, 1), (0, 1)) + torch.roll(wy, 1, 0)
        vn = torch.roll(wy, 1, 1) + wy
        uw = torch.roll(wx, (1, 1), (0, 1)) + torch.roll(wx, 1, 1)
        ue = torch.roll(wx, 1, 0) + wx
        vs = torch.where(self.row_first, 0.0, vs)
        vn = torch.where(self.row_last, 0.0, vn)
        fs = 0.5 * (1.0 + torch.sign(vs))
        fn = 0.5 * (1.0 + torch.sign(vn))
        fw = 0.5 * (1.0 + torch.sign(uw))
        fe = 0.5 * (1.0 + torch.sign(ue))
        cs = cs - dts * fs * vs * g.asgrd
        cn = cn + dts * (1.0 - fn) * vn * g.angrd
        cw = cw - dts * fw * uw * g.cstr * g.azgrd
        ce = ce + dts * (1.0 - fe) * ue * g.cstr * g.azgrd
        cc = cc + dts * (fn * vn * g.angrd - (1.0 - fs) * vs * g.asgrd
                         + (fe * ue - (1.0 - fw) * uw) * g.cstr * g.azgrd)

        mask = self.interior_j.to(cc.dtype)
        cc = torch.where(self.interior_j, cc, 1.0)
        return cc, cn * mask, cs * mask, ce * mask, cw * mask

    def solve_tracer(self, rhs, guess, coefs, tol, maxiter):
        """BiCGSTAB on the row-equilibrated 5-point transport operator
        (D^-1 A x = D^-1 b, D = diag(A)): near the poles the 1/cos^2
        metric makes the diagonal ~4e3 against ~1 at mid-latitudes, and
        the scaling makes the stopping criterion uniform across rows.
        The trips it took are appended to ``last_trips``."""
        cc, cn, cs, ce, cw = coefs
        d = 1.0 / cc
        sc = (None, cn * d, cs * d, ce * d, cw * d)
        rhs = self._zero_cols(rhs * d)
        guess = self._zero_cols(guess)
        with record_function("embm_solve"):
            x, trips = bicgstab_safe(
                lambda v: self._transport_matvec(v, sc), rhs, guess,
                lambda r: r, tol, maxiter, check_every=self.check_every)
        self.last_trips.append(trips)
        return self._bc(x)

    @staticmethod
    def _zero_cols(a):
        z = torch.zeros_like(a[..., :1])
        return torch.cat([z, a[..., 1:-1], z], dim=-1)

    # ------------------------------------------------------------------
    def precipitate(self, at_shum, state, flux_shum, psno_allowed, dts,
                    hicel=None):
        """Condensation above rhmax, snow/soil bookkeeping
        (fluxes.F:280-446).  Returns updated humidity and fields."""
        at_sat = state.at[0]
        telev = self.elev if hicel is None else self.elev + hicel
        teff = at_sat - telev * C.RLAPSE * C.RF1 * torch.exp(
            torch.clamp(-telev / C.RF2, min=-1.0))
        ssh = C.CSSH * torch.exp(17.67 * teff / (teff + 243.5))
        qmax = C.RHMAX * ssh
        fb = C.RHOATM * C.SHQ / dts
        excess = torch.clamp(at_shum - qmax, min=0.0)
        precip = fb * excess
        at_shum = at_shum - excess
        rh = torch.clamp(at_shum / (ssh + EPSLN), 0.0, 1.0)

        # snowfall where the air is below freezing
        tair = at_sat - C.TSNO - telev * C.RLAPSE
        psno = torch.where(tair <= 0.0, precip, 0.0) * psno_allowed

        # land: update soil moisture, spill to runoff
        land = self.lmsk
        fshum_land = flux_shum - precip + psno
        soilm_new = torch.clamp(state.soilm - dts * fshum_land, min=0.0)
        runoff = torch.clamp(soilm_new - C.SOILMAX, min=0.0) / dts
        soilm_new = torch.clamp(soilm_new, max=C.SOILMAX)
        soilm_new = land * soilm_new + (1 - land) * state.soilm
        return (self._bc(at_shum), precip, psno, rh, soilm_new, runoff)

    # ------------------------------------------------------------------
    def step(self, state: AtmState, sst):
        """One stand-alone atmosphere step (no ice, no land model):
        returns (new state, flux fields)."""
        cfg = self.cfg
        mixing = state.nats + 1 > cfg.namix
        dts = cfg.dtatm if mixing else 2.0 * cfg.dtatm
        at_old = state.at if mixing else state.atm1

        fl = self.fluxes(state, sst, dts=dts)
        evap = fl["evap"]

        # humidity transport (solve(ishum))
        forc_q = self._zero_rows(dts / (C.RHOATM * C.SHQ) * evap)
        coefs_q = self._coef(self.diff_q, dts)
        rhs_q = self._bc(at_old[1] + forc_q)
        shum_new = self.solve_tracer(rhs_q, state.at[1], coefs_q,
                                     self.solver_tol, cfg.solver_maxiter)

        flux_shum = evap * self.lmsk   # land freshwater bookkeeping
        shum_new, precip, psno, rh, soilm_new, runoff = self.precipitate(
            shum_new, state, flux_shum, torch.ones_like(evap), dts)

        # temperature transport (solve(isat))
        forc_t = self.temperature_forcing(
            dts, self.solins, fl["dnswr"], fl["outlwr"], fl["uplwr"],
            fl["upsens"], precip, psno)
        rhs_t = self._bc(at_old[0] + forc_t)
        coefs_t = self._coef(self.diff_t, dts)
        sat_new = self.solve_tracer(rhs_t, state.at[0], coefs_t,
                                    self.solver_tol, cfg.solver_maxiter)

        new_state = AtmState(
            at=torch.stack([sat_new, shum_new]), atm1=state.at,
            soilm=soilm_new, soilm1=state.soilm, surf=fl["surf"],
            nats=1 if mixing else state.nats + 1)
        diag = dict(fl, precip=precip, psno=psno, rh=rh, runoff=runoff,
                    flux_shum=evap - precip)
        return new_state, diag

    @staticmethod
    def _zero_rows(a):
        z = torch.zeros_like(a[..., :1, :])
        return torch.cat([z, a[..., 1:-1, :], z], dim=-2)

    def temperature_forcing(self, dts, solins, dnswr, outlwr, uplwr,
                            upsens, precip, psno):
        """SAT source of one step: radiation, surface fluxes, latent
        heat of precipitation and of snowfall; zero on the boundary
        rows."""
        fa = dts / (C.CPATM * C.RHOATM * C.SHT)
        fb_l = dts * C.VLOCN / (C.CPATM * C.RHOATM * C.SHT)
        fc = dts * C.SLICE / (C.CPATM * C.RHOATM * C.SHT) - fb_l
        fd = C.SCATTER * (1.0 + C.PASS)
        forc_t = fa * (solins * self.aca * fd - dnswr * C.SCATTER
                       - outlwr + uplwr + upsens)
        forc_t = forc_t + precip * fb_l + fc * psno
        return self._zero_rows(forc_t)
