"""Ocean model: the assembled leapfrog step, in PyTorch.

Port of ``uvic_tpu.models.ocean.model`` (source/mom/mom.F) with every
ocean option of the reference: the tracer schemes (FCT dlm1/dlm2 with
the optional 3-D delimiter, QUICKER, upstream, centered), isopycnal/GM
mixing in the small-angle or full-tensor form, constant, Smagorinsky or
biharmonic horizontal mixing, anisotropic viscosity, equatorial zonal
mixing, Neptune, constant, Bryan-Lewis or Pacanowski-Philander vertical
mixing with tidal kv, full or ncon convection, geothermal heat,
penetrative shortwave, the streamfunction barotropic mode (5- or
9-point, explicit or implicit Coriolis) with the island-constrained CG
or the surface-pressure / implicit free-surface modes, FIR or Fourier
high-latitude filters, Euler-backward mixing steps and a cyclic or
walled zonal boundary.  One step:

    full velocities from psi (or ubar) -> adv_vel -> mixing coeffs
    -> surface BCs -> tracer step -> convection -> filters
    -> clinic (momentum) -> barotropic CG -> new state

With a bgc suite (``npzd`` or ``mobi``) the step adds the suite's
sources (tracer.F:256-521, ``models/bgc``) to the tracer step.

The three hot spots run as hand-written CUDA kernels when the tensors
lie on the card (``ops/tracer_kernel.py``, ``ops/convection.py``,
``ops/cg_kernel.py``) and as their plain PyTorch versions on the CPU.
The tracer kernel takes the step where the reference takes its fused
kernel (FCT dlm1, no 3-D delimiter, constant hmix); every other scheme
and hmix runs the reference's generic ``kernels.tracer_step``, as the
reference does.  Every barotropic solve runs the CG kernel: on the unit
operator with 1/c2dtsf for the explicit-Coriolis streamfunction, on the
step's whole operator otherwise (one solver per step interval).
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
from ...ops.convection import convct_brine, convct_full, convct_ncon
from ...ops.eos import dens
from ...ops.filters import build_hlat_filter
from ...ops.solvers import IslandIndex
from ...ops.stencil import setbcx
from ...ops.tracer_kernel import TracerStepConsts, fct_tracer_step
from ..bgc.mobi import Mobi
from ..bgc.npzd import Npzd, NpzdParams
from .kernels import adv_vel, clinic_step, iso_flux_tendency, tracer_step
from .params import OceanParams, build_ocean_params
from .tropic import (ext_mode_velocity, sfc5pt_unit, sfc9pt_unit,
                     tropic_step)


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


class OceanModel:
    """Static configuration and device constants; steps the ocean."""

    def __init__(self, params: OceanParams, device):
        cfg = params.cfg
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
        bag.ah = cfg.ocean.ah
        if cfg.ocean.full_tensor:
            # O_full_tensor adds the diapycnal kappa_h to the
            # horizontal background diffusivity (hmixc.F:97-99); the
            # Gerdes re-scaling band of isopyc.F:150-175
            from .isopyc import full_tensor_delta
            bag.ah = bag.ah + cfg.ocean.kappa_h
            bag.full_tensor_band = full_tensor_delta(g, cfg.ocean)
        bag.hr = tn(topo.hr)
        bag.h = tn(topo.h)                # surface-pressure modes
        bag.zt = tn(g.zt)                 # level depths (diag/energy.py)
        bag.grav_rho0r = GRAV * RHO0R
        if cfg.ocean.tracer_advection == "quicker":
            from ...ops.advection import quicker_coefficients
            bag.quicker = {ax: {k: tn(v) for k, v in d.items()}
                           for ax, d in quicker_coefficients(g).items()}
        self.g = bag
        self.sine = tn(g.sine)

        self.tmask = tn(topo.tmask)
        self.umask = tn(topo.umask)
        self.kmt = torch.as_tensor(topo.kmt, dtype=torch.int32, device=device)
        self.kmu = torch.as_tensor(topo.kmu, dtype=torch.int32, device=device)
        self.eos_c = tn(params.eos.c)
        self.eos_to = tn(params.eos.to)
        self.eos_so = tn(params.eos.so)
        self.cyclic = g.cyclic

        # island machinery for the streamfunction solve
        self.isl = IslandIndex(
            perim_id=torch.as_tensor(topo.perim_id, dtype=torch.int64,
                                     device=device),
            nisle=topo.nisle,
            counts=tn(topo.perim_count),
            imain=topo.imain,
            ocean_mask=tn((topo.land_map <= 0).astype(np.float64)),
        )

        # barotropic mode (O_stream_function vs the surface-pressure
        # formulations, emode.h) and its CG solvers; c2dtsf of a step
        # by its leapfrog flag
        o = cfg.ocean
        c2dtsf = {True: 2 * o.dtsf, False: o.dtsf}
        self.barotropic = o.barotropic
        self.sp_mode = o.barotropic in (
            BarotropicMode.SURFACE_PRESSURE,
            BarotropicMode.IMPLICIT_FREE_SURFACE)
        self.cf_unit = self.cf_acor = self.cg_solver = None
        self.cg_solvers = None
        self.filt_zu = None
        if self.sp_mode:
            from .surfpress import spc9pt_unit
            self.cf_sp = tn(spc9pt_unit(
                np.asarray(g.dxu), np.asarray(g.dyu), np.asarray(g.csu),
                np.asarray(topo.h)))
            omask2d = (topo.land_map <= 0).astype(np.float64)
            inter = np.zeros_like(omask2d)
            inter[1:-1, 1:-1] = 1.0
            self.fs_diag_unit = tn(
                -(np.asarray(g.cst) * np.asarray(g.dyt))[:, None]
                * np.asarray(g.dxt)[None, :] / (GRAV * o.dtsf)
                * omask2d * inter)
            self.isl_sp = IslandIndex(
                perim_id=torch.full((jmt, imt), -1, dtype=torch.int64,
                                    device=device),
                nisle=0, counts=tn(np.zeros(1)), imain=-1,
                ocean_mask=tn(omask2d))
            self.sp_omask = tn(omask2d)
            # high-latitude filtering of the external-mode forcing zu:
            # the streamfunction path filters its forcing (filz,
            # tropic.F:136-141) but bardiv.F dropped uhat filtering, so
            # the sp modes have no converging-meridian protection in the
            # reference and are unstable at the standard grid/timestep;
            # the reference package filters zu, the direct analog of filz
            if o.fourfil:
                self.filt_zu = build_hlat_filter(
                    o.hlat_filter, (topo.kmu > 0).astype(np.float64),
                    np.asarray(g.yu), imt, "asymmetric", g.cyclic, dt,
                    device)
            # alph/gam/theta time-blend constants (setmom.F:105-113)
            fs = o.barotropic == BarotropicMode.IMPLICIT_FREE_SURFACE
            self.sp_consts = ((1.0 / 3.0, 1.0 / 3.0, 0.5) if fs
                              else (1.0, 0.0, 1.0))
            # the 9-point operator without islands; the free surface adds
            # cst*dyt*dxt/(apgr*c2dtsf*dtsf*g) to its centre
            # (bardiv.F:90-101), apgr = alph (leapfrog) or theta
            def sp_solver(lf):
                cf = self.cf_sp
                if fs:
                    apgr = self.sp_consts[0] if lf else self.sp_consts[2]
                    cf = cf.clone()
                    cf[1, 1] += self.fs_diag_unit / (c2dtsf[lf] * apgr)
                return CGSolver(cf, self.isl_sp, o.mxscan, g.cyclic)

            if fs:
                self.cg_solvers = {lf: sp_solver(lf) for lf in (True, False)}
            else:
                rigid = sp_solver(True)
                self.cg_solvers = {True: rigid, False: rigid}
        else:
            # 5- or 9-point streamfunction operator at unit timestep and
            # its implicit Coriolis part
            sfc = sfc9pt_unit if o.sf_npt == 9 else sfc5pt_unit
            cf_unit, cf_acor = sfc(
                np.asarray(g.dxu), np.asarray(g.dyu), np.asarray(g.csu),
                np.asarray(topo.hr), f=np.asarray(params.cori[0]),
                acor=o.acor)
            self.cf_unit, self.cf_acor = tn(cf_unit), tn(cf_acor)
            if o.acor == 0.0:
                self.cg_solver = CGSolver(self.cf_unit, self.isl, o.mxscan,
                                          g.cyclic)
            else:
                # the operator cf_unit/c2dtsf + cf_acor of each interval
                self.cg_solvers = {
                    lf: CGSolver(self.cf_unit / c2dtsf[lf] + self.cf_acor,
                                 self.isl, o.mxscan, g.cyclic)
                    for lf in (True, False)}

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

        # Neptune topographic stress (O_neptune): static equilibrium
        # velocity from topography (neptune.F; const-hmix gate)
        self.unep = None
        if cfg.ocean.neptune and cfg.ocean.hmix == "const":
            from .neptune import neptune_velocity
            self.unep = tn(neptune_velocity(g, topo, cfg.ocean.spnep,
                                            cfg.ocean.senep))

        # shortwave penetration profile (O_shortwave, setmom.F:376-410):
        # Paulson & Simpson double exponential; pen(0)=0 compensates the
        # shortwave already included in the surface flux stf(temp)
        self.divpen = None
        if cfg.ocean.shortwave:
            zw = np.asarray(g.zw)[:km]
            rpart, efold1, efold2 = 0.58, 35.0, 23.0e2  # cm
            pen = rpart * np.exp(-np.minimum(zw / efold1, 70.0)) \
                + (1.0 - rpart) * np.exp(-np.minimum(zw / efold2, 70.0))
            pen0 = np.concatenate([[0.0], pen[:-1]])
            self.divpen = tn((pen0 - pen) / np.asarray(g.dzt))

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

        # the fused tracer step, where the reference takes its fused
        # kernel (FCT dlm1, no 3-D delimiter, constant hmix); the
        # small-angle Redi/GM tendency is applied inside it from the
        # 18-slot weight stack (``uvic_tpu`` without its UVIC_ISO_SRC
        # switch), the full tensor's enters it as a source (the weight
        # stack is small-angle only)
        iso = o.isopycmix
        self.fused_tracer = (o.tracer_advection == "fct"
                             and o.fct_variant == "dlm1" and not o.fct_3d
                             and o.hmix == "const")
        self.tracer_consts = TracerStepConsts(
            bag, bag.ah, o.aidif if iso else 0.0, ydiff_fluxform=iso,
            has_iso=iso and not o.full_tensor, cyclic=g.cyclic)
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

    def full_velocity(self, u_int, ext):
        """Internal + external mode, masked (loadmw.F add_ext_mode).
        ``ext`` is the streamfunction (jmt, imt) or, in the
        surface-pressure modes, ubar (2, jmt, imt) directly."""
        if self.sp_mode:
            uext, vext = ext[0], ext[1]
        else:
            uext, vext = ext_mode_velocity(ext, self.g.hr, self.g.dxu2r,
                                           self.g.dyu2r, self.g.csur)
        u = setbcx((u_int[0] + uext[None]) * self.umask, self.cyclic)
        v = setbcx((u_int[1] + vext[None]) * self.umask, self.cyclic)
        return torch.stack([u, v])

    def barotropic_solver(self, leapfrog: bool):
        """(solver, c2dtsf to call it with or None for the step's own) of
        a step's barotropic solve: the unit-operator CG with 1/c2dtsf, or
        a CG on the step interval's whole operator, called with 1."""
        if self.cg_solvers is None:
            return self.cg_solver, None
        return self.cg_solvers[leapfrog], 1.0

    # ------------------------------------------------------------------
    def _step(self, state: OceanState, forcing: SurfaceForcing, *,
              leapfrog: bool, scan: bool = False,
              eb_pass: int = 0) -> OceanState:
        """One ocean step: leapfrog, or a forward mixing step with
        tau-1 <- tau (mom.F:96-148); ``eb_pass`` 1/2 are the two passes
        of an Euler-backward mixing step (mom.F:424-446), taken with
        ``leapfrog`` False.

        ``scan`` takes the bgc sources as the reference's ``run_scan``
        does (``uvic_tpu/models/ocean/model.py:564-567``): the leapfrog
        instance with the step's interval, so a mixing step takes
        nbio = round(2 dtts / dtnpzd) substeps of dtts / nbio.  Without
        it a mixing step takes the forward instance, as ``step`` and
        ``run`` do in the reference.  The two differ by design."""
        cfg = self.cfg.ocean
        g = self.g
        if eb_pass == 2:
            # 2nd EB pass: tendencies at tau' (stored in t), interval dt
            c2dtts, c2dtuv, c2dtsf = cfg.dtts, cfg.dtuv, cfg.dtsf
            tm1, t_tau = state.tm1, state.t
            um1_int, u_int = state.um1, state.u
            psi0, psi1 = state.psi0, state.psi1
            ub_tm1 = state.ubarm1
        elif leapfrog:
            c2dtts, c2dtuv, c2dtsf = 2 * cfg.dtts, 2 * cfg.dtuv, 2 * cfg.dtsf
            tm1, t_tau = state.tm1, state.t
            um1_int, u_int = state.um1, state.u
            psi0, psi1 = state.psi0, state.psi1
            ub_tm1 = state.ubarm1
        else:
            # forward mixing step: tau-1 <- tau (mom.F:119-148; ubarm1 <-
            # ubar at mixing-step entry, mom.F:163-167)
            c2dtts, c2dtuv, c2dtsf = cfg.dtts, cfg.dtuv, cfg.dtsf
            tm1, t_tau = state.t, state.t
            um1_int, u_int = state.u, state.u
            psi0, psi1 = state.psi0, state.psi0
            ub_tm1 = state.ubar

        # full velocities at both time levels, face advection velocities
        if self.sp_mode:
            u_tau = self.full_velocity(u_int, state.ubar)
            u_tm1 = self.full_velocity(um1_int, ub_tm1)
        else:
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

        # Richardson-number mixing recomputes the coefficients per step
        # (ppmix.F); other schemes use the precomputed fields
        if cfg.vmix == "ppmix":
            from .vmix import ppmix_coefficients
            diff_cbt, visc_cbu = ppmix_coefficients(
                tm1, u_tm1, self.tmask, self.umask, self.eos_c, self.eos_to,
                self.eos_so, g, cyclic=self.cyclic)
        else:
            diff_cbt, visc_cbu = self.diff_cbt, self.visc_cbu

        # isopycnal/GM fields (isopyc.F): K33 into the implicit vertical
        # diffusivity (vmixc.F:146-156), GM velocities into advection
        iso = None
        aidif = 0.0
        vet_t, vnt_t, vbt_t = vet, vnt, vbt
        if cfg.isopycmix:
            from .isopyc import compute_isopyc
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
            aidif = cfg.aidif

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

        # penetrative shortwave heating (swflux0, tracer.F:1787-1840):
        # the solar part of the surface heat flux spread down the column
        # by the divpen profile; 2.389e-8 converts erg/cm^2/s to K cm/s
        if self.divpen is not None:
            ki = 5.0e-2   # ice/snow attenuation [1/cm] (npzd ki)
            psw = forcing.swr * 2.389e-8 * (1.0 + forcing.aice * (
                torch.exp(-ki * (forcing.hice + forcing.hsno)) - 1.0))
            sw_src = psw[None] * self.divpen[:, None, None] * self.tmask
            if source is None:
                source = torch.zeros_like(tm1)
                source[0] = sw_src
            else:
                source = source.clone()
                source[0] = source[0] + sw_src

        # variable horizontal mixing (smagnl.F / O_biharmonic)
        hmix_t = hmix_u = None
        if cfg.hmix == "smagnl":
            from .hmix import smag_tracer_coefficients, smagnl_coefficients
            strain, am_lam, am_phi = smagnl_coefficients(u_tm1, g,
                                                         self.cyclic)
            cet, cnt = smag_tracer_coefficients(am_lam, am_phi,
                                                cfg.smag_diff_back)
            hmix_t = ("smagnl", cet, cnt)
            hmix_u = ("smagnl", strain, am_lam, am_phi, self.sine)
        elif cfg.hmix == "biharmonic":
            hmix_t = ("biharmonic", cfg.ahbi)
            hmix_u = ("biharmonic", cfg.ambi)
        if self.aniso_visc is not None and hmix_u is None:
            # Large et al. 2001 anisotropic momentum mixing rides the
            # consthmix path with 3-D coefficients
            hmix_u = ("aniso",) + self.aniso_visc

        # tracer step (tracer.F): the fused step (kernel on the card)
        # where the reference takes its fused kernel, its generic form
        # otherwise
        if self.fused_tracer:
            isow = None
            if iso is not None and self.tracer_consts.has_iso:
                from .isopyc import iso_weight_pack, iso_weight_stack
                isow = iso_weight_stack(iso_weight_pack(iso, g))
            elif iso is not None:
                iso_tend = iso_flux_tendency(iso, tm1, self.tmask, g,
                                             self.cyclic)
                source = iso_tend if source is None else source + iso_tend
            t_new = fct_tracer_step(
                self.tracer_consts, t_tau, tm1, vet_t, vnt_t, vbt_t,
                diff_cbt, stf, btf, source, c2dtts * g.dtxcel, self.tmask,
                self.kmt, isow=isow)
        else:
            t_new = tracer_step(
                t_tau, tm1, vet_t, vnt_t, vbt_t, stf, btf, source, diff_cbt,
                self.kmt, self.tmask, g, c2dtts, cfg.tracer_advection,
                aidif, self.cyclic, iso=iso, hmix=hmix_t,
                fct_variant=cfg.fct_variant, fct3d=cfg.fct_3d)

        # convection (convect.F, convect_brine.F), filtering
        # (tracer.F:980-993)
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
        elif cfg.convection == Convection.FULL:
            t_new = convct_full(t_new, self.kmt, self.eos_c, self.eos_to,
                                self.eos_so, self.dztxcl)
        else:
            t_new = convct_ncon(t_new, self.kmt, self.eos_c, self.eos_to,
                                self.eos_so, self.dztxcl, cfg.ncon)
        if self.filt_t is not None:
            t_new = self.filt_t(t_new)
        t_new = setbcx(t_new, self.cyclic)

        # baroclinic momentum step (clinic.F); density from tau tracers
        rho = eos_state_from(self.eos_c, self.eos_to, self.eos_so, t_tau)
        u_int_new, zu = clinic_step(
            u_tau, u_tm1, rho, veu, vnu, vbu, smf, bmf, visc_cbu,
            self.kmu, self.umask, g, c2dtuv, self.cyclic, hmix=hmix_u,
            unep=self.unep)
        if self.filt_u is not None:
            u_int_new = setbcx(self.filt_u(u_int_new), self.cyclic)

        solver, solve_c2dtsf = self.barotropic_solver(leapfrog)
        if self.sp_mode:
            # surface pressure / implicit free surface (bardiv.F)
            from .surfpress import surface_pressure_step
            alph, gam_b, theta = self.sp_consts
            fs = self.barotropic == BarotropicMode.IMPLICIT_FREE_SURFACE
            if self.filt_zu is not None:
                zu = self.filt_zu(zu)
            ps0n, ps1n, pguess, ubar_n, iters = surface_pressure_step(
                zu, state.psi0, state.psi1, psi1, state.ptd, state.ubar,
                ub_tm1, solver, g, self.umask[0], self.sp_omask, c2dtsf,
                cfg.dtsf, cfg.tolrfs if fs else cfg.tolrsp, leapfrog,
                free_surface=fs, alph=alph, gam=gam_b, theta=theta,
                acor=cfg.acor, cori=g.cori[0], eb_pass=eb_pass,
                cyclic=self.cyclic)
            self.last_cg_iters = iters
            return OceanState(
                tm1=t_tau, t=t_new, um1=u_int, u=u_int_new,
                psi0=ps0n, psi1=ps1n, ptd=pguess, ptdb=state.ptdb,
                ubar=ubar_n,
                ubarm1=state.ubarm1 if eb_pass == 2 else state.ubar,
                itt=state.itt + 1,
                nconv=state.nconv + (iters >= cfg.mxscan).to(torch.int32))

        # barotropic streamfunction solve (tropic.F)
        psi0n, psi1n, ptd, ptdb, iters, conv = tropic_step(
            zu, psi0, psi1, state.ptd, state.ptdb, self.isl, g.dxu, g.dyu,
            g.csu, c2dtsf, cfg.tolrsf, cfg.mxscan, leapfrog, solver,
            self.cyclic, filt=self.filt_sf, euler2=eb_pass == 2,
            save_ptd=eb_pass != 1, npt=cfg.sf_npt,
            solve_c2dtsf=solve_c2dtsf)
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
        if not leapfrog and self.cfg.ocean.eb:
            return self._step_eb(state, forcing)
        return self._step(state, forcing, leapfrog=leapfrog)

    def _step_eb(self, state: OceanState,
                 forcing: SurfaceForcing) -> OceanState:
        """Euler-backward mixing step (mom.F:424-446): a forward
        predictor pass (euler1) whose tau+1 fields become the tau
        arguments of a corrector pass (euler2).  Each pass is a whole
        step: the three kernels launch twice."""
        s1 = self._step(state, forcing, leapfrog=False, eb_pass=1)
        if self.sp_mode:
            # euler1 committed pguess (+ps for free surface) into s1;
            # euler2 solves against the original ps levels (bardiv.F)
            mid = OceanState(
                tm1=state.t, t=s1.t, um1=state.u, u=s1.u,
                psi0=s1.psi0, psi1=s1.psi1, ptd=s1.ptd, ptdb=state.ptdb,
                ubar=s1.ubar, ubarm1=s1.ubarm1, itt=state.itt,
                nconv=s1.nconv)
        else:
            mid = OceanState(
                tm1=state.t, t=s1.t, um1=state.u, u=s1.u,
                psi0=s1.psi0, psi1=state.psi0, ptd=state.ptd,
                ptdb=state.ptdb, ubar=state.ubar, ubarm1=state.ubarm1,
                itt=state.itt, nconv=s1.nconv)
        s2 = self._step(mid, forcing, leapfrog=False, eb_pass=2)
        # euler_shuffle: tau-1 <- tau(original), tau <- tau+1
        return dataclasses.replace(s2, tm1=state.t, um1=state.u,
                                   itt=state.itt + 1)

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
                 nsteps: int, nmix: int | None = None) -> OceanState:
        """Run ``nsteps`` with ``nmix``'s cadence (by default
        ``cfg.ocean.nmix``'s) and the reference ``run_scan``'s step
        (``_step(..., scan=True)``).

        On the card each step is the replay of one of two CUDA graphs,
        a leapfrog step and a mixing step, captured at the first call
        and kept with the model (``graphs.StepGraphs``); a capture that
        fails raises.  On the CPU it is the same loop of eager steps.
        Either way the result is a new state and ``state`` stays valid;
        ``scan_cg_iters`` holds each step's CG iterations (int32 on the
        model's device).
        """
        nmix = nmix or self.cfg.ocean.nmix
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
