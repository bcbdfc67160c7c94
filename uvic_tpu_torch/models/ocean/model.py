"""Ocean model: the assembled leapfrog step, in PyTorch.

Port of ``uvic_tpu.models.ocean.model`` (source/mom/mom.F) for the
flagship physics: FCT dlm1 advection, isopycnal/GM mixing, full
convection, tidal kv, geothermal heat, anisotropic viscosity, equatorial
zonal mixing, the streamfunction barotropic mode with the
island-constrained CG, and the FIR high-latitude filters.  One step:

    full velocities from psi -> adv_vel -> mixing coeffs -> surface BCs
    -> tracer step -> convection -> filters -> clinic (momentum)
    -> barotropic CG -> new state

With a bgc suite (``npzd`` or ``mobi``) the step adds the suite's
sources (tracer.F:256-521, ``models/bgc``) to the tracer step.

The three hot spots run as hand-written CUDA kernels when the tensors
lie on the card (``ops/tracer_kernel.py``, ``ops/convection.py``,
``ops/cg_kernel.py``) and as their plain PyTorch versions on the CPU.
The host schedules leapfrog and forward (mixing) steps.  ``step`` and
``run`` take one Python call a step; ``run_scan`` replays one CUDA graph
per step type on the card (``graphs.py``), the counterpart of the
reference's ``lax.scan``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ... import resolve_device
from ...config import BarotropicMode, Convection, ModelConfig
from ...constants import GRAV, RHO0R
from ...core.state import OceanState, init_ocean_state
from ...ops.cg_kernel import CGSolver
from ...ops.convection import convct_brine, convct_full
from ...ops.eos import dens
from ...ops.filters import build_hlat_filter
from ...ops.solvers import IslandIndex
from ...ops.stencil import setbcx
from ...ops.tracer_kernel import TracerStepConsts, fct_tracer_step
from ..bgc.mobi import Mobi
from ..bgc.npzd import Npzd, NpzdParams
from .kernels import adv_vel, clinic_step
from .params import OceanParams, build_ocean_params
from .tropic import ext_mode_velocity, sfc5pt_unit, tropic_step


@dataclass
class SurfaceForcing:
    """Surface boundary conditions for one ocean step (csbc.h slots).

    smf : (2, jmt, imt) wind stress at U cells [cm^2/s^2]
    stf : (nt, jmt, imt) surface tracer fluxes [tracer-unit * cm/s]
    swr : (jmt, imt) downward surface shortwave [erg/cm^2/s] (bgc light)
    aice/hice/hsno : (jmt, imt) sea-ice state for light under ice
    relyr : 0-d tensor, fractional year for the seasonal declination
    btf : (nt, jmt, imt) bottom tracer fluxes; negative = upward into
          the bottom cell
    cbf, cba : (2, jmt, imt) brine salt fluxes and area weights of the
          open-water and the ice category (O_convect_brine), or None
    """
    smf: torch.Tensor
    stf: torch.Tensor
    swr: torch.Tensor
    aice: torch.Tensor
    hice: torch.Tensor
    hsno: torch.Tensor
    relyr: torch.Tensor
    btf: torch.Tensor
    cbf: torch.Tensor | None = None
    cba: torch.Tensor | None = None


def make_forcing(smf, stf, swr=None, aice=None, hice=None, hsno=None,
                 relyr=0.0, btf=None, cbf=None, cba=None):
    """SurfaceForcing with the reference's defaults for the optional
    fields: swr 2e5, no ice, relyr 0 (a 0-d tensor, so a captured step
    reads it from its buffer), zero bottom fluxes, no brine fluxes."""
    z = torch.zeros_like(smf[0])
    return SurfaceForcing(
        smf=smf, stf=stf,
        swr=z + 2.0e5 if swr is None else swr,
        aice=z if aice is None else aice,
        hice=z if hice is None else hice,
        hsno=z if hsno is None else hsno,
        relyr=torch.as_tensor(relyr, dtype=smf.dtype, device=smf.device),
        btf=torch.zeros_like(stf) if btf is None else btf,
        cbf=cbf, cba=cba)


def _check_supported(cfg: ModelConfig):
    """Reject options outside the ported slice."""
    o = cfg.ocean
    unsupported = {
        "tracer_advection": o.tracer_advection != "fct",
        "fct_variant": o.fct_variant != "dlm1",
        "fct_3d": o.fct_3d,
        "convection": o.convection != Convection.FULL,
        "barotropic": o.barotropic != BarotropicMode.STREAM_FUNCTION,
        "vmix": o.vmix not in ("const", "bryan_lewis"),
        "hmix": o.hmix != "const",
        "sf_npt": o.sf_npt != 5,
        "acor": o.acor != 0.0,
        "hlat_filter": o.fourfil and o.hlat_filter != "fir",
        "shortwave": o.shortwave,
        "neptune": o.neptune,
        "full_tensor": o.full_tensor,
        "eb": o.eb,
        "grid.cyclic": not cfg.grid.cyclic,
        "bgc": cfg.bgc.suite not in ("none", "npzd", "mobi"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"options not ported to uvic_tpu_torch yet: {bad}")


class OceanModel:
    """Static configuration and device constants; steps the ocean."""

    def __init__(self, params: OceanParams, device):
        cfg = params.cfg
        _check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.device = device = torch.device(device)
        g = params.grid
        topo = params.topo
        dt = torch.from_numpy(np.zeros(0, cfg.np_dtype)).dtype
        self.dtype = dt
        km, jmt, imt = g.km, g.jmt, g.imt

        def tn(x):
            return torch.as_tensor(np.array(x), dtype=dt, device=device)

        # parameter bag of device constants for the stencils
        bag = SimpleNamespace()
        for name in ("dxt", "dxu", "dyt", "dyu", "dzt", "dzw", "cst", "csu",
                     "duw", "due", "dus", "dun", "dxmetr",
                     "dxtr", "dxt2r", "dxu2r", "dxur",
                     "dytr", "dyt2r", "dyu2r", "dyu4r", "dyur",
                     "dztr", "dzt2r", "dzwr", "dztur", "dztlr",
                     "cstr", "csur",
                     "cstdxt2r", "cstdxtr", "cstdxur", "csudxur",
                     "csudxu2r", "cstdyt2r", "csudyu2r"):
            setattr(bag, name, tn(getattr(g, name)))
        for name in ("cori", "advmet", "amc_north", "amc_south",
                     "ahc_north", "ahc_south", "am3", "am4", "dtxcel"):
            setattr(bag, name, tn(getattr(params, name)))
        bag.am = cfg.ocean.am
        bag.ah = cfg.ocean.ah             # kernels.tracer_step
        bag.hr = tn(topo.hr)
        bag.zt = tn(g.zt)                 # level depths (diag/energy.py)
        bag.grav_rho0r = GRAV * RHO0R
        self.g = bag

        self.tmask = tn(topo.tmask)
        self.umask = tn(topo.umask)
        self.kmt = torch.as_tensor(topo.kmt, dtype=torch.int32, device=device)
        self.kmu = torch.as_tensor(topo.kmu, dtype=torch.int32, device=device)
        self.eos_c = tn(params.eos.c)
        self.eos_to = tn(params.eos.to)
        self.eos_so = tn(params.eos.so)
        self.cyclic = g.cyclic

        # island machinery and the barotropic operator (5-point, unit
        # timestep) for the streamfunction solve
        self.isl = IslandIndex(
            perim_id=torch.as_tensor(topo.perim_id, dtype=torch.int64,
                                     device=device),
            nisle=topo.nisle,
            counts=tn(topo.perim_count),
            imain=topo.imain,
            ocean_mask=tn((topo.land_map <= 0).astype(np.float64)),
        )
        self.cf_unit = tn(sfc5pt_unit(np.asarray(g.dxu), np.asarray(g.dyu),
                                      np.asarray(g.csu), np.asarray(topo.hr)))
        self.cg_solver = CGSolver(self.cf_unit, self.isl, cfg.ocean.mxscan,
                                  g.cyclic)

        # mixing coefficients (vmixc.F:63-106)
        if cfg.ocean.vmix == "bryan_lewis":
            from .vmix import bryan_lewis_profile
            ahv = bryan_lewis_profile(np.asarray(g.zw[:km]))
            self.diff_cbt = torch.broadcast_to(
                tn(ahv)[:, None, None], (km, jmt, imt)).contiguous()
        else:
            self.diff_cbt = torch.full((km, jmt, imt), cfg.ocean.kappa_h,
                                       dtype=dt, device=device)
        self.visc_cbu = torch.full((km, jmt, imt), cfg.ocean.kappa_m,
                                   dtype=dt, device=device)
        self.dztxcl = tn(g.dzt) / bag.dtxcel

        # tidal-mixing dissipation field (O_tidal_kv); the reference's
        # constituent maps are absent upstream, the default is the
        # roughness-scaled bottom deposit of vmix.default_tidal_edr
        self.tidal_edr = None
        self.tlat_deg = tn(np.broadcast_to(np.asarray(g.yt)[:, None],
                                           (jmt, imt)))
        if cfg.ocean.tidal_kv:
            from .vmix import default_tidal_edr
            area_t = (np.asarray(g.cst)[:, None] * np.asarray(g.dyt)[:, None]
                      * np.asarray(g.dxt)[None, :])
            self.tidal_edr = tn(default_tidal_edr(
                np.asarray(topo.kmt), np.asarray(g.dzt),
                ht_cm=np.asarray(topo.ht), area=area_t))
            self.tidal_zw = tn(np.asarray(g.zw)[:km])

        # anisotropic viscosity / zonal-mixing static fields
        self.aniso_visc = None
        self.addisop = None
        if cfg.ocean.aniso_visc:
            from .aniso import large_anisotropic_viscosity
            vce, vcn = large_anisotropic_viscosity(
                np.asarray(g.yu), np.asarray(g.dxu), np.asarray(g.dyu),
                np.asarray(topo.umask)[0], np.asarray(g.zw)[:km],
                cfg.ocean.am, cyclic=g.cyclic)
            self.aniso_visc = (tn(vce), tn(vcn))
        if cfg.ocean.aniso_zonal:
            from .aniso import equatorial_zonal_diffusivity
            self.addisop = tn(equatorial_zonal_diffusivity(np.asarray(g.yt)))

        # geothermal bottom heat flux (O_gthflx, setmom.F:1749-1754)
        self.bhf = None
        if cfg.ocean.gthflx:
            from .gthflx import geoheatflux_field
            self.bhf = tn(geoheatflux_field(np.asarray(g.xt),
                                            np.asarray(g.yt)))

        # high-latitude zonal filters (setcom.F:101-132)
        self.filt_t = self.filt_u = self.filt_sf = None
        if cfg.ocean.fourfil:
            meth = cfg.ocean.hlat_filter
            self.filt_t = build_hlat_filter(
                meth, topo.tmask, np.asarray(g.yt), imt, "symmetric",
                g.cyclic, dt, device)
            self.filt_u = build_hlat_filter(
                meth, topo.umask, np.asarray(g.yu), imt, "asymmetric",
                g.cyclic, dt, device)
            self.filt_sf = build_hlat_filter(
                meth, (topo.land_map <= 0).astype(np.float64),
                np.asarray(g.yt), imt, "symmetric", g.cyclic, dt, device)

        self.nt = params.nt
        self.tracer_index = params.tracer_index

        # biogeochemistry sources (tracer.F npzd section): one instance
        # per step interval, keyed by the leapfrog flag
        self.npzd = None
        if cfg.bgc.suite in ("npzd", "mobi"):
            b = cfg.bgc
            nz_params = NpzdParams(dtnpzd=b.dtnpzd, nitrogen=b.nitrogen,
                                   o2=b.o2, carbon=b.carbon, alk=b.alk)
            cls = Mobi if b.suite == "mobi" else Npzd
            self.npzd = {
                lf: cls(nz_params, g, self.tracer_index,
                        (2 if lf else 1) * cfg.ocean.dtts, dt, device)
                for lf in (True, False)}
            self.tlat_rad = tn(np.deg2rad(
                np.broadcast_to(np.asarray(g.yt)[:, None], (jmt, imt))))

        # bottom-drag coefficient: scalar, enhanced over the polar cap
        yu_arr = np.asarray(g.yu)
        polar_w = 1.0 / (1.0 + np.exp(-(yu_arr - cfg.ocean.cdbot_polar_lat)
                                      / 1.5))
        cdbot_j = cfg.ocean.cdbot * (
            1.0 + (cfg.ocean.cdbot_polar_scale - 1.0) * polar_w)
        self.cdbot2d = tn(np.broadcast_to(cdbot_j[:, None], (jmt, imt)))

        # the fused tracer step; the Redi/GM tendency is applied inside
        # it from the 18-slot weight stack (``uvic_tpu`` without its
        # UVIC_ISO_SRC switch)
        iso = cfg.ocean.isopycmix
        self.tracer_consts = TracerStepConsts(
            bag, cfg.ocean.ah, cfg.ocean.aidif if iso else 0.0,
            ydiff_fluxform=iso, has_iso=iso)
        self.last_cg_iters = None
        self.scan_cg_iters = None
        self._graphs = None

    # ------------------------------------------------------------------
    def init_state(self, t_init=None) -> OceanState:
        """Cold-start state; a physics-only ``t_init`` (fewer tracers
        than the registry) is extended with the registry's uniform
        defaults for the rest."""
        g = self.params.grid
        vals = np.array([t.init for t in self.tracer_index.tracers])
        full = vals[:, None, None, None] \
            * np.asarray(self.params.topo.tmask)[None]
        if t_init is not None:
            t_init = np.asarray(t_init)
            full[:t_init.shape[0]] = t_init
        return init_ocean_state(self.nt, g.km, g.jmt, g.imt, self.dtype,
                                self.device, full)

    def full_velocity(self, u_int, psi):
        """Internal + external mode, masked (loadmw.F add_ext_mode)."""
        uext, vext = ext_mode_velocity(psi, self.g.hr, self.g.dxu2r,
                                       self.g.dyu2r, self.g.csur)
        u = setbcx((u_int[0] + uext[None]) * self.umask, self.cyclic)
        v = setbcx((u_int[1] + vext[None]) * self.umask, self.cyclic)
        return torch.stack([u, v])

    # ------------------------------------------------------------------
    def _step(self, state: OceanState, forcing: SurfaceForcing, *,
              leapfrog: bool, scan: bool = False) -> OceanState:
        """One ocean step: leapfrog, or a forward mixing step with
        tau-1 <- tau (mom.F:96-148).

        ``scan`` takes the bgc sources as the reference's ``run_scan``
        does (``uvic_tpu/models/ocean/model.py:564-567``): the leapfrog
        instance with the step's interval, so a mixing step takes
        nbio = round(2 dtts / dtnpzd) substeps of dtts / nbio.  Without
        it a mixing step takes the forward instance, as ``step`` and
        ``run`` do in the reference.  The two differ by design."""
        cfg = self.cfg.ocean
        g = self.g
        if leapfrog:
            c2dtts, c2dtuv, c2dtsf = 2 * cfg.dtts, 2 * cfg.dtuv, 2 * cfg.dtsf
            tm1, t_tau = state.tm1, state.t
            um1_int, u_int = state.um1, state.u
            psi0, psi1 = state.psi0, state.psi1
        else:
            c2dtts, c2dtuv, c2dtsf = cfg.dtts, cfg.dtuv, cfg.dtsf
            tm1, t_tau = state.t, state.t
            um1_int, u_int = state.u, state.u
            psi0, psi1 = state.psi0, state.psi0

        # full velocities at both time levels, face advection velocities
        u_tau = self.full_velocity(u_int, psi0)
        u_tm1 = self.full_velocity(um1_int, psi1)
        vet, vnt, vbt, veu, vnu, vbu = adv_vel(u_tau[0], u_tau[1], g,
                                               self.cyclic)

        # surface/bottom boundary fluxes (setvbc.F)
        smf = forcing.smf * self.umask[0][None]
        stf = forcing.stf * self.tmask[0][None]
        btf = forcing.btf * self.tmask[0][None]
        if self.bhf is not None:
            # geothermal heating of the deepest wet cell (setvbc.F
            # updates/09:74-76)
            btf[0] = btf[0] - self.bhf * self.tmask[0]
        if cfg.cdbot != 0.0:
            kb = torch.clamp(self.kmu - 1, min=0).long()
            ub = torch.gather(u_tm1, 1,
                              kb[None, None].expand(2, 1, -1, -1))[:, 0]
            uvmag = torch.sqrt(ub[0] ** 2 + ub[1] ** 2)
            bmf = self.cdbot2d[None] * ub * uvmag[None] \
                * (self.kmu > 0)[None]
        else:
            bmf = torch.zeros_like(smf)

        # isopycnal/GM fields (isopyc.F): K33 into the implicit vertical
        # diffusivity (vmixc.F:146-156), GM velocities into advection,
        # the Redi fluxes through the weight stack
        diff_cbt = self.diff_cbt
        isow = None
        vet_t, vnt_t, vbt_t = vet, vnt, vbt
        if cfg.isopycmix:
            from .isopyc import compute_isopyc, iso_weight_pack, \
                iso_weight_stack
            iso = compute_isopyc(tm1, self.tmask, self.kmt, self.eos_c,
                                 self.eos_to, self.eos_so, g, cfg,
                                 self.cyclic, addisop=self.addisop)
            if cfg.tidal_kv:
                from .vmix import tidal_kv_diff
                drodzb0 = iso.alphai * iso.ddzt[0] + iso.betai * iso.ddzt[1]
                diff_cbt = tidal_kv_diff(drodzb0, self.kmt, self.tidal_zw,
                                         self.tlat_deg, self.tidal_edr,
                                         diff_cbt)
            diff_cbt = diff_cbt + iso.K33
            if cfg.gent_mcwilliams:
                vet_t = vet + iso.vetiso
                vnt_t = vnt + iso.vntiso
                vbt_t = vbt + iso.vbtiso
            isow = iso_weight_stack(iso_weight_pack(iso, g))

        # biogeochemistry sources (tracer.F:256-521)
        source = None
        if self.npzd is not None:
            args = (tm1, self.kmt, self.tmask, forcing.swr, forcing.aice,
                    forcing.hice, forcing.hsno, self.tlat_rad,
                    forcing.relyr)
            if scan:
                source = self.npzd[True].sources(*args, c2dtts=c2dtts)
            else:
                source = self.npzd[leapfrog].sources(*args)

        # tracer step (tracer.F), convection (convect.F), filtering
        # (tracer.F:980-993)
        t_new = fct_tracer_step(
            self.tracer_consts, t_tau, tm1, vet_t, vnt_t, vbt_t, diff_cbt,
            stf, btf, source, c2dtts * g.dtxcel, self.tmask, self.kmt,
            isow=isow)
        if cfg.convect_brine and forcing.cbf is not None:
            # O_convect_brine: the ice categories' brine fluxes drive
            # per-category convection (convect_brine.F) in place of the
            # salt flux at the surface; the interval and dtxcel0 = 1 as
            # the reference passes them
            cba0 = torch.clamp(1.0 - forcing.cba.sum(0), min=0.0) \
                * self.tmask[0]
            t_new = convct_brine(
                t_new, forcing.cbf, forcing.cba, cba0, self.kmt,
                self.eos_c, self.eos_to, self.eos_so, self.dztxcl, c2dtts,
                float(self.params.grid.zw[0]))
        else:
            t_new = convct_full(t_new, self.kmt, self.eos_c, self.eos_to,
                                self.eos_so, self.dztxcl)
        if self.filt_t is not None:
            t_new = self.filt_t(t_new)
        t_new = setbcx(t_new, self.cyclic)

        # baroclinic momentum step (clinic.F); density from tau tracers
        rho = eos_state_from(self.eos_c, self.eos_to, self.eos_so, t_tau)
        u_int_new, zu = clinic_step(
            u_tau, u_tm1, rho, veu, vnu, vbu, smf, bmf, self.visc_cbu,
            self.kmu, self.umask, g, c2dtuv, self.cyclic,
            aniso=self.aniso_visc)
        if self.filt_u is not None:
            u_int_new = setbcx(self.filt_u(u_int_new), self.cyclic)

        # barotropic streamfunction solve (tropic.F)
        psi0n, psi1n, ptd, ptdb, iters, conv = tropic_step(
            zu, psi0, psi1, state.ptd, state.ptdb, self.isl, g.dxu, g.dyu,
            g.csu, c2dtsf, cfg.tolrsf, cfg.mxscan, leapfrog,
            self.cg_solver, self.cyclic, filt=self.filt_sf)
        self.last_cg_iters = iters

        return OceanState(
            tm1=t_tau, t=t_new, um1=u_int, u=u_int_new,
            psi0=psi0n, psi1=psi1n, ptd=ptd, ptdb=ptdb,
            ubar=state.ubar, ubarm1=state.ubarm1,
            itt=state.itt + 1,
            nconv=state.nconv + (~conv).to(torch.int32),
        )

    def step(self, state: OceanState, forcing: SurfaceForcing,
             leapfrog: bool = True) -> OceanState:
        return self._step(state, forcing, leapfrog=leapfrog)

    def run(self, state: OceanState, forcing: SurfaceForcing,
            nsteps: int, nmix: int | None = None) -> OceanState:
        """Run nsteps with the reference mixing cadence: a forward step
        every ``nmix`` steps (mom.F leapfrog control, itt%nmix==1)."""
        nmix = nmix or self.cfg.ocean.nmix
        for _ in range(nsteps):
            state = self.step(state, forcing,
                              leapfrog=(state.itt % nmix) != 0)
        return state

    def apply_restoring(self, forcing: SurfaceForcing, state: OceanState,
                        sst_field, sss_field,
                        relyr=0.0) -> SurfaceForcing:
        """O_restorst: replace the T/S surface-flux rows with Newtonian
        restoring toward time-interpolated climatology (data.F:119-142,
        checks.F:240-265).  sst_field/sss_field are
        ``io.timeforce.TimeInterpField`` (or None to leave a row)."""
        from ...io.timeforce import restoring_stf
        o = self.cfg.ocean
        stf = restoring_stf(forcing.stf, state.t[:, 0], sst_field,
                            sss_field, relyr, o.dampts, o.dampdz,
                            self.tmask[0])
        return dataclasses.replace(forcing, stf=stf)

    def run_restoring(self, state: OceanState, smf,
                      sst_field=None, sss_field=None, nseg: int = 1,
                      seg_days: float = 30.0, relyr0: float = 0.0,
                      yrlen: float = 365.0,
                      climatology: str = "seasonal") -> OceanState:
        """Ocean-only production driver with Newtonian surface
        restoring (O_restorst, data.F:119-142): each segment
        interpolates the SST/SSS climatology at the segment midpoint,
        converts it to surface fluxes against the state entering the
        segment (setvbc restoring path), and runs the segment's steps
        through ``run_scan`` (CUDA-graph replays on the card, which read
        each segment's fluxes from their forcing buffers).  This is the
        classic spin-up configuration of the reference (restoring run
        before coupling).

        smf : (2, jmt, imt) wind stress; sst_field/sss_field :
        io.timeforce.TimeInterpField or None (then the ``climatology``,
        "seasonal" or "bcest", provides both).
        """
        from ...io.timeforce import (TimeInterpField,
                                     default_surface_climatology)
        np_dtype = self.cfg.np_dtype
        if sst_field is None and sss_field is None:
            if climatology == "bcest":
                # annual-mean Levitus/H&R zonal estimates (bcest.F) —
                # the reference's idealized standalone-ocean restoring
                from ...io.bcest import bcest_fields
                f = bcest_fields(self.params.grid, dtype=np_dtype)
                sst_field = TimeInterpField(f["sst"][None], dtype=np_dtype,
                                            device=self.device)
                sss_field = TimeInterpField(
                    (f["sss"][None] - 35.0) / 1000.0, dtype=np_dtype,
                    device=self.device)
            else:
                sst_field, sss_field = default_surface_climatology(
                    self.params.grid, dtype=np_dtype, device=self.device)
        nsteps = max(1, round(seg_days * 86400.0 / self.cfg.ocean.dtts))
        stf0 = torch.zeros((self.nt,) + tuple(smf.shape[1:]),
                           dtype=self.dtype, device=self.device)
        relyr = relyr0
        for _ in range(nseg):
            mid = relyr + 0.5 * seg_days / yrlen
            forcing = make_forcing(smf, stf0, relyr=mid)
            forcing = self.apply_restoring(forcing, state, sst_field,
                                           sss_field, relyr=mid)
            state = self.run_scan(state, forcing, nsteps)
            relyr += seg_days / yrlen
        return state

    def run_scan(self, state: OceanState, forcing: SurfaceForcing,
                 nsteps: int) -> OceanState:
        """Run ``nsteps`` with ``cfg.ocean.nmix``'s cadence and the
        reference ``run_scan``'s step (``_step(..., scan=True)``).

        On the card each step is the replay of one of two CUDA graphs,
        a leapfrog step and a mixing step, captured at the first call
        and kept with the model (``graphs.StepGraphs``); a capture that
        fails raises.  On the CPU it is the same loop of eager steps.
        Either way the result is a new state and ``state`` stays valid;
        ``scan_cg_iters`` holds each step's CG iterations (int32 on the
        model's device).
        """
        nmix = self.cfg.ocean.nmix
        iters = torch.zeros(nsteps, dtype=torch.int32, device=self.device)
        if self.device.type == "cpu":
            for n in range(nsteps):
                state = self._step(state, forcing,
                                   leapfrog=(state.itt % nmix) != 0,
                                   scan=True)
                iters[n] = self.last_cg_iters
        else:
            if self._graphs is None:
                from .graphs import StepGraphs
                self._graphs = StepGraphs(self, state, forcing)
            state = self._graphs.run(state, forcing, nsteps, nmix, iters)
        self.scan_cg_iters = iters
        return state


def eos_state_from(c, to, so, t):
    """Density anomaly field from the tracer block (state.F:54-60)."""
    return dens(c[:, None, None, :], t[0] - to[:, None, None],
                t[1] - so[:, None, None])


def make_ocean(cfg: ModelConfig | None = None, topo_kind: str = "world",
               device=None, **kw) -> OceanModel:
    """Build the ocean model; on ``cuda`` unless ``device`` says
    otherwise (raises without a card and without an explicit device)."""
    device = resolve_device(device)
    params = build_ocean_params(cfg or ModelConfig(), topo_kind=topo_kind,
                                **kw)
    return OceanModel(params, device)
