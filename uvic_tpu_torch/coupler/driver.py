"""Coupled driver: the segment loop tying ocean, atmosphere, sea ice and
land, in PyTorch.

Port of ``uvic_tpu.coupler.driver`` (source/common/UVic_ESCM.F:296-416
segment loop, gasbc.F, gosbc.F):

  for each segment (segtim days):
    gasbc  : ocean surface state -> atmosphere boundary conditions
    ntspas x EMBM step with the sea ice inside (fluxes -> EVP dynamics
             + advection -> ice thermodynamics -> humidity solve ->
             precipitation -> temperature solve -> flux accumulation,
             embm.F:39-95)
    land   : MTLM physics and TRIFFID on the segment means
    sed    : the ocean sediments' step (sed.F), on the bottom water
    gosbc  : time-mean fluxes -> ocean surface forcing; with a bgc suite
             the gas exchange (gasbc.F:310-470) and the normalized
             virtual fluxes (gosbc.F:312-364) of the tracers, and the
             sediments' return flux at the bottom
    ntspos x ocean step, with the per-step time means

A segment runs as a sequence of stages on a flat workspace: a dict of
tensors named like the restart's keys ("ocean/t", "atm/at", ...) plus
the segment's own fields ("sst", "acc/heat", "tavg/temp", ...).  Each
stage reads the workspace and returns the entries it changes:

    head, ntspas x atm(mixing), mid, ntspos x ocean(leapfrog), tail

The atmosphere's mixing counter ``nats`` and the ocean's ``itt`` are
host integers, as in ``OceanModel``: they pick each stage's type.
``run_segment`` runs the stages eagerly on any device; on the card
``run`` replays one CUDA graph per stage type (``graphs.py``), the
counterpart of the reference's one jitted segment program.  Both give
the same result bitwise.

What changes from one segment to the next (the fractional year, the
transient forcing's CO2, its radiative forcing and solar factor, the
atmospheric Delta-14C and CFCs, the sulphate and land-ice fields, the
anomalous-wind climatology) enters as workspace tensors written before
each segment (``segment_inputs``, the reference's ``_segment_scalars``),
never as a Python number read inside a stage, so a replayed stage takes
its own segment's values.  The set of those tensors is the workspace's
structure: with transient forcing the sulphate and land-ice fields are
always present (zero where the reference has ``None``: the same values);
the CFC concentrations are present once the transient forcing has given
them (a zero CFC atmosphere is not the reference's ``None``: it draws
the CFCs out of the ocean), and the anomalous-wind climatology once it
is set.  ``run`` captures the graphs again when the structure changes.

The sediments (``sed.enabled``: the pore-water columns of
``models/sed/porewater.py``, or the legacy interfacial closure of
``models/sed/sediment.py``) and the multi-category sea ice (``ice.cpts``
> 0: ``models/ice/cpts.py``) are part of the state, in the workspace
under the restart's keys (``sed/calgg``, ``cpts/E``, ...).  The ice
options of the reference run here too: the sea ice off, the ice without
EVP dynamics (no advection, no ice stress on the ocean), the free-drift
ice-ocean stress (the EVP internal stress divergence, capped by
``ice_ocn_stress_cap`` when it is > 0) and O_convect_brine (the ice's
brine masses accumulated a segment, ``acc/cbf`` and ``acc/cba``, handed
to the ocean's brine convection through the forcing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..checks import validate
from ..config import ModelConfig
from ..constants import EPSLN, OMEGA, RADIAN
from ..core.state import OceanState
from ..io.forcing import TransientForcing, sulphate_pattern
from ..ops.stencil import DN, E, N, S, W
from ..models.embm import constants as C
from ..models.embm.insolation import daily_insolation
from ..models.embm.model import AtmState, EmbmModel
from ..models.embm.rivers import RiverModel
from ..models.embm.winds import WindFeedback
from ..models.ice import cpts as cpts_mod
from ..models.ice.cpts import CPTS_FIELDS, CptsState, init_cpts_state
from ..models.ice.evp import COSTH, DRAGW_RHO, SINTH, evp_dynamics, evp_xymin
from ..models.ice.thermo import (IceState, freezing_point, ice_advection,
                          ice_thermodynamics, init_ice_state)
from ..models.bgc.gasx import (co2calc_sws, hemispheric_blend,
                               surface_gas_fluxes)
from ..models.land.mtlm import (LandState, init_land_state, mtlm_physics_step,
                         triffid_update)
from ..models.sed.porewater import (PW_FIELDS, PoreWaterState,
                                    init_porewater, porewater_step)
from ..models.sed.sediment import (SED_FIELDS, SedState, init_sed_state,
                                   sed_step)
from ..models.ocean.kernels import adv_vel
from ..models.ocean.model import eos_state_from, make_forcing, make_ocean

SOCN = 0.035  # global-mean absolute salinity for virtual salt flux
# The coupler's carbon chemistry (the gas exchange's carbonate system and
# the sediments' step) runs in float64 whatever the model's dtype.  In
# float32 the Mehrbach K2 fit of the pore water (terms of ~5e3 summing
# to ~-9) and dco2star (the air-sea difference of near-equal numbers)
# lose three to four digits: on the earth's bottom water K2 is 0.2% off,
# and the port's float32 sediment return flux then sat ~10x further from
# float64 than the JAX package's float32 does (PERF.md, PR 10).  These
# are 2-D fields once a segment: the float64 costs no time.
CHEM_DTYPE = torch.float64

OCEAN_FIELDS = ("tm1", "t", "um1", "u", "psi0", "psi1", "ptd", "ptdb",
                "ubar", "ubarm1", "nconv")
ATM_FIELDS = ("at", "atm1", "soilm", "soilm1", "surf")
ICE_FIELDS = ("hice", "aice", "hsno", "tice", "uice", "sig")
LAND_FIELDS = ("frac", "ht", "lai", "cs", "tsoil", "npp_acc", "gleaf_acc",
               "resp_w_acc", "resp_s_acc", "nacc", "gc", "m_soil", "mneg",
               "lying_snow")
ACC_NAMES = ("heat", "freshwater", "taux", "tauy", "swr", "wspd", "toa_sw",
             "olr", "precip", "psno", "evap", "runoff", "uplwr", "upsens",
             "upltnt", "time")
ATAV_NAMES = ("sat", "shum", "hice", "aice", "hsno", "soilm", "tice",
              "uice", "vice")
OTAV_NAMES = ("temp", "salt", "u", "v", "w", "rho", "adv_fe_temp",
              "adv_fn_temp", "adv_fb_temp", "dif_fe_temp", "dif_fn_temp",
              "dif_fb_temp", "psi")
FORCING_NAMES = ("smf", "stf", "swr", "aice", "hice", "hsno", "relyr",
                 "btf")
# the brine accumulators and forcing fields of O_convect_brine
BRINE_NAMES = ("cbf", "cba")
# the sediment state's class and fields by kind (host["sed"])
SED_KINDS = {"porewater": (PoreWaterState, PW_FIELDS),
             "legacy": (SedState, SED_FIELDS)}


@dataclass
class CoupledState:
    ocean: OceanState
    atm: AtmState
    ice: IceState
    land: Any = None       # LandState when cfg.land.enabled
    sed: Any = None        # PoreWaterState or SedState when cfg.sed.enabled
    cpts: Any = None       # CptsState when cfg.ice.cpts > 0


def _chem(*xs):
    """The arguments in CHEM_DTYPE (tensors; numbers pass as they are),
    one or a tuple."""
    out = tuple(x.to(CHEM_DTYPE) if isinstance(x, torch.Tensor) else x
                for x in xs)
    return out[0] if len(out) == 1 else out


def sed_kind(sed):
    """The key of SED_KINDS for a sediment state, None without one."""
    if sed is None:
        return None
    return "porewater" if isinstance(sed, PoreWaterState) else "legacy"


def host_of(state: CoupledState) -> dict:
    """The host side of a segment: the counters and the optional
    components present."""
    return dict(itt=state.ocean.itt, nats=state.atm.nats,
                land=state.land is not None, sed=sed_kind(state.sed),
                cpts=state.cpts is not None)


class CoupledModel:
    def __init__(self, cfg: ModelConfig | None = None,
                 topo_kind: str = "world", kmt=None, device=None):
        cfg = cfg or ModelConfig()
        # checks.F + chkcpl: fatal inconsistencies raise, the
        # adjust-and-warn rules are kept for the caller and the logs
        self.config_warnings = validate(cfg)
        if cfg.ocean.convect_brine and (cfg.ice.cpts > 0
                                        or not cfg.ice.enabled):
            raise ValueError("O_convect_brine requires the 0-layer ice "
                             "model (cpts carries its own categories)")
        self.cfg = cfg
        # the segment's accumulators and ocean forcing fields: with
        # O_convect_brine (and the ice on) the brine masses and fractions
        brine = cfg.ocean.convect_brine and cfg.ice.enabled
        self.acc_names = ACC_NAMES + (BRINE_NAMES if brine else ())
        self.forcing_names = FORCING_NAMES + (BRINE_NAMES if brine else ())
        self.device = device = resolve_device(device)
        self._topo_kind = topo_kind
        self.ocean = make_ocean(cfg, topo_kind=topo_kind, kmt=kmt,
                                device=device)
        self.dtype = dt = self.ocean.dtype
        grid = self.ocean.params.grid
        topo = self.ocean.params.topo
        self.grid = grid
        self.topo = topo

        def tn(x):
            return torch.as_tensor(np.array(x, np.float64), dtype=dt,
                                   device=device)

        embm_kw = {}
        stress_clim = None
        if topo_kind == "earth":
            # the reference reads elevation, winds, wind stress, coalbedo
            # and diffusivity from data files; the earth configuration
            # authors them in-repo (core/earth.py)
            from ..core.earth import (earth_atm_coalbedo, earth_atm_diff,
                                       earth_elevation, earth_surface_wind,
                                       earth_wind_stress)
            diff_t, diff_q = earth_atm_diff(grid)
            winds_e, wspd_e = earth_surface_wind(grid)
            embm_kw = dict(elev=earth_elevation(grid), winds=winds_e,
                           wspd=wspd_e, diff_t=diff_t, diff_q=diff_q,
                           atm_coalbedo=earth_atm_coalbedo(grid),
                           dry_soil_albedo=0.15)
            stress_clim = earth_wind_stress(grid)
        self.embm = EmbmModel(grid, topo, cfg.embm, dtype=dt, device=device,
                              check_every=1, **embm_kw)

        # coupling cadence (chkcpl semantics)
        seg_s = cfg.time.segtim_days * 86400.0
        self.ntspas = max(1, round(seg_s / cfg.embm.dtatm))
        self.ntspos = max(1, round(seg_s / cfg.ocean.dtts))

        jmt, imt = grid.jmt, grid.imt
        # the per-segment inputs on the host (segment_inputs puts them in
        # the workspace); run() updates them from the transient forcing
        self.co2ccn = 280.0     # atmospheric CO2 [ppmv] (co2ccn)
        self.anthro = 0.0       # CO2 radiative forcing (co2forc)
        self.cfcccn = None      # (cfc11 N,S, cfc12 N,S) [pptv]
        self.dc14ccn = 0.0      # atmospheric Delta-14C [permil]
        self.solar_scale = 1.0  # transient (solar - volcanic)/solarconst
        self.sulph = None       # sulphate coalbedo-reduction field
        self.sealev = 0.0       # sea level rel. present [cm] (sealevdata)
        self.landice = None     # (hicel, aicel) paleo ice sheets (icedata)
        self._icesheet_scale = None
        self._sulph_pattern = tn(sulphate_pattern(grid.yt, imt=imt))
        self.relyr = 0.0        # fractional year, advanced by run()
        self.year0 = cfg.time.year0
        self.transient = None   # set by set_transient_forcing()
        self.awind = None       # the anomalous-wind feedback (winds.F)
        if cfg.embm.awind:
            self.awind = WindFeedback(
                grid, grid.cst[:, None] * grid.dyt[:, None]
                * grid.dxt[None, :], dt, device)
        tlat = np.broadcast_to(grid.yt[:, None], (jmt, imt))
        self.tlat_deg = tn(tlat)
        self.tlat_rad2d = tn(np.deg2rad(tlat))
        f = 2.0 * OMEGA * np.sin(grid.yu / RADIAN)
        self.fcor_u = tn(np.broadcast_to(f[:, None], (jmt, imt)))
        self.umsk = tn((topo.kmu > 0).astype(np.float64))
        area_full = (grid.cst[:, None] * grid.dyt[:, None]
                     * grid.dxt[None, :])
        # land-cell areas [cm^2] for the global nep integral (gasbc.F)
        self.area2d_land = tn(area_full) * self.embm.lmsk
        # ocean-cell areas without the cyclic columns, for the global
        # surface means of the virtual fluxes (gosbc.F)
        area = area_full * (topo.kmt > 0)
        area[:, 0] = 0.0
        area[:, -1] = 0.0
        self.area2d = tn(area)
        self._init_sediments()

        # river routing (rivmodel)
        self.rivers = RiverModel(topo.kmt, area_full, grid.cyclic,
                                 dtype=dt, device=device)

        # wind stress on the ocean and ice: the earth configuration's
        # climatology, else a bulk stress from the prescribed EMBM winds
        if stress_clim is not None:
            self.taux_w = tn(stress_clim[0])
            self.tauy_w = tn(stress_clim[1])
        else:
            w = self.embm.winds
            wmag = torch.sqrt(w[0] ** 2 + w[1] ** 2) + EPSLN
            self.taux_w = C.RHOATM * C.CDATM * wmag * w[0]
            self.tauy_w = C.RHOATM * C.CDATM * wmag * w[1]

        # ice-velocity high-latitude zonal filter (filuvice, ice.F) and
        # the per-cell advective-CFL speed cap (IceConfig.cfl_cap)
        self.filt_uvice = None
        if cfg.ocean.fourfil and cfg.ice.enabled and cfg.ice.evp:
            from ..ops.filters import build_hlat_filter
            self.filt_uvice = build_hlat_filter(
                cfg.ocean.hlat_filter, (topo.kmu > 0).astype(np.float64),
                np.asarray(grid.yu), imt, "asymmetric", grid.cyclic, dt,
                device)
        dx_u = (np.asarray(grid.csu)[:, None]
                * np.asarray(grid.dxu)[None, :])
        dy_u = np.broadcast_to(np.asarray(grid.dyu)[:, None], (jmt, imt))
        self.uice_cap = tn(0.4 * dx_u / cfg.embm.dtatm)
        self.vice_cap = tn(0.4 * dy_u / cfg.embm.dtatm)
        self.xyminevp = evp_xymin(grid.cst, grid.dxt, grid.dyt)

        # multi-category ice (cpts.F): the category bounds and the layer
        # salinity profile
        if cfg.ice.cpts > 0:
            self._cpts_hstar = tn(cpts_mod.HSTAR[cfg.ice.cpts])
            self._cpts_saltz = tn(cpts_mod.salinity_profile(cfg.ice.nlay))

        self.last_acc = None
        self.last_forcing = None
        self.last_tavg = None
        self.last_nep_kgC_s = None
        self._graphs = None

    def _init_sediments(self):
        """The sediment step's fixed inputs, in CHEM_DTYPE: the bottom
        cells, the ocean mask, the water depth and the particle sinking at
        the bottom of the bgc suite (the reference's
        ``jnp.take(mob.wc * mob.dzt, kb)``)."""
        self._sed_on = (self.cfg.sed.enabled
                        and "dic" in self.ocean.tracer_index)
        if not self._sed_on:
            return
        dt, dev = CHEM_DTYPE, self.device
        kb = torch.clamp(self.ocean.kmt.long() - 1, min=0)
        self._sed_kb = kb
        self._sed_tmsk = self.embm.tmsk.to(dt)
        self._sed_depth = torch.as_tensor(np.asarray(self.topo.ht),
                                          dtype=dt, device=dev)
        idx = self.ocean.tracer_index
        mob = self.ocean.npzd[True] if self.ocean.npzd else None
        self._sed_wc = self._sed_wd = None
        self._sed_redctn = getattr(mob, "redctn", 7.1e-3)

        def sinking(w):
            w = torch.as_tensor(np.asarray(w), dtype=dt, device=dev)
            dzt = torch.as_tensor(np.asarray(mob.dzt), dtype=dt, device=dev)
            return (w * dzt)[kb]

        if mob is not None and "caco3" in idx:
            self._sed_wc = sinking(mob.wc)
        if mob is not None and "detr" in idx:
            self._sed_wd = sinking(mob.wd)

    # ------------------------------------------------------------------
    def init_state(self, t_init=None) -> CoupledState:
        grid = self.grid
        ocean = self.ocean.init_state(
            t_init if t_init is not None else self._default_ocean_ic())
        atm = self.embm.init_state()
        ice = init_ice_state(grid.jmt, grid.imt, self.dtype, self.device)
        land = None
        if self.cfg.land.enabled:
            land = init_land_state(grid.jmt, grid.imt,
                                   self.embm.lmsk.cpu().numpy(), self.dtype,
                                   self.device)
        sed = None
        if self.cfg.sed.enabled:
            init = (init_porewater if self.cfg.sed.porewater
                    else init_sed_state)
            sed = init(grid.jmt, grid.imt, self.dtype, self.device)
        cpts = None
        if self.cfg.ice.cpts > 0:
            cpts = init_cpts_state(self.cfg.ice.cpts, self.cfg.ice.nlay,
                                   grid.jmt, grid.imt, self.dtype,
                                   self.device)
        return CoupledState(ocean=ocean, atm=atm, ice=ice, land=land,
                            sed=sed, cpts=cpts)

    def _default_ocean_ic(self):
        g = self.grid
        vals = np.array([t.init for t in self.ocean.tracer_index.tracers])
        t0 = np.broadcast_to(
            vals[:, None, None, None],
            (self.ocean.nt, g.km, g.jmt, g.imt)).copy()
        tmask = np.asarray(self.topo.tmask)
        if self._topo_kind == "earth":
            # Levitus-like zonal-mean hydrography (core/earth.py)
            from ..core.earth import earth_initial_ts
            temp, salt = earth_initial_ts(g, np.asarray(self.topo.kmt))
            t0[0] = temp
            t0[1] = salt
            return t0 * tmask
        lat = np.broadcast_to(g.yt[:, None], (g.jmt, g.imt))
        sst = 25.0 * np.cos(np.deg2rad(lat)) ** 2
        prof = np.exp(-np.asarray(g.zt) / 1000.0e2)
        t0[0] = sst[None] * prof[:, None, None] + 2.0
        t0[1] = 0.0
        return t0 * tmask

    def set_transient_forcing(self, transient=None):
        """Enable transient forcing (co2data/solardata/... readers): from
        the next segment on, ``run`` takes its values at each segment's
        year."""
        self.transient = transient or TransientForcing.default()

    def _update_transient(self):
        """The transient forcing at the coming segment's year, into the
        host-side inputs (gasbc.F data calls)."""
        f = self.transient.at(self.year0 + self.relyr)
        self.co2ccn = f["co2ccn"]
        self.anthro = 5.35e3 * np.log(self.co2ccn / 280.0)
        self.dc14ccn = f["dc14ccn"]
        self.solar_scale = f["solarconst"] / C.SOLARCONST
        if "aggfor" in f:
            # additional GHG forcing rides the CO2 longwave channel
            # (aggdata.F application in fluxes.F anthro)
            self.anthro = self.anthro + f["aggfor"]
        if "sealev" in f:
            self.sealev = f["sealev"]
        if "icesheet" in f and f["icesheet"] != self._icesheet_scale:
            # paleo continental ice sheets (icedata.F): the authored
            # footprint at the new extent scale
            self._icesheet_scale = f["icesheet"]
            self.landice = None
            if f["icesheet"] > 0.0:
                from ..core.earth import landice_fields
                ai, hi = landice_fields(self.grid, f["icesheet"])
                self.landice = tuple(
                    torch.as_tensor(x, dtype=self.dtype, device=self.device)
                    for x in (hi, ai))
        if "sulph_scale" in f:
            self.sulph = (self._sulph_pattern * f["sulph_scale"]
                          if f["sulph_scale"] > 0.0 else None)
        if "cfc11ccnn" in f:
            self.cfcccn = (f["cfc11ccnn"], f["cfc11ccns"],
                           f["cfc12ccnn"], f["cfc12ccns"])

    def segment_inputs(self) -> dict:
        """The coming segment's inputs as workspace tensors (the
        reference's ``_segment_scalars``).  Under transient forcing the
        sulphate and land-ice fields are always present, zero where the
        reference has ``None`` (sca - 0, elev + 0 and an empty ice
        sheet: the same values); the anomalous-wind climatology is
        present once it is set."""
        def scalar(v):
            return torch.tensor(float(v), dtype=self.dtype,
                                device=self.device)

        out = dict(relyr=scalar(self.relyr), co2ccn=scalar(self.co2ccn),
                   anthro=scalar(self.anthro),
                   solar_scale=scalar(self.solar_scale),
                   dc14ccn=scalar(self.dc14ccn))
        if self.cfcccn is not None:
            # (cfc11 N, cfc11 S, cfc12 N, cfc12 S) [pptv]
            out["cfcccn"] = torch.tensor([float(v) for v in self.cfcccn],
                                         dtype=self.dtype,
                                         device=self.device)
        if self.transient is not None:
            zero = torch.zeros_like(self._sulph_pattern)
            out["sulph"] = zero if self.sulph is None else self.sulph
            out["hicel"], out["aicel"] = ((zero, zero) if self.landice
                                          is None else self.landice)
        if self.awind is not None and self.awind.t_clim is not None:
            out["awind_clim"] = self.awind.t_clim
        return out

    # ------------------------------------------------------------------
    def gasbc(self, state: CoupledState):
        """Ocean surface state -> atm boundary conditions (gasbc.F)."""
        return self.surface_bc(state.ocean.t[:, 0])

    @staticmethod
    def surface_bc(surf):
        """(sst, sss, frzpt) of the surface tracers ``surf`` (nt, jmt,
        imt)."""
        sst = surf[0]
        sss = surf[1] * 1000.0 + 35.0
        return sst, sss, freezing_point(sss)

    # ------------------------------------------------------------------
    def _atm_ice_step_impl(self, atm: AtmState, ice: IceState, sst, frzpt,
                           uocn, vocn, anthro, solins=None, land_gc=None,
                           wind_pkg=None, sulph=None, landice=None,
                           cpts_st=None, *, mixing: bool):
        """One atmosphere step with the sea ice inside (embm.F:39-95).
        solins: seasonal TOA insolation (else the annual mean); land_gc:
        the land model's canopy conductance [cm/s] from its last step;
        wind_pkg: (winds, wspd, taux, tauy) of the anomalous-wind
        feedback; sulph, landice: the transient sulphate field and the
        (hicel, aicel) ice sheets; cpts_st: the thickness distribution
        (``ice.cpts`` > 0).  Returns (new atm, new ice, flux increments
        for the coupler, new thickness distribution)."""
        embm = self.embm
        cfg = self.cfg.embm
        icfg = self.cfg.ice
        dts = cfg.dtatm if mixing else 2.0 * cfg.dtatm
        at_old = atm.at if mixing else atm.atm1
        if wind_pkg is None:
            winds_a, wspd_a = embm.winds, embm.wspd
            taux_w, tauy_w = self.taux_w, self.tauy_w
        else:
            winds_a, wspd_a, taux_w, tauy_w = wind_pkg
        solins_a = embm.solins if solins is None else solins
        hicel = aicel = None
        if landice is not None:
            hicel, aicel = landice

        fl = embm.fluxes(atm, sst, dts=dts, anthro=anthro, wspd=wspd_a,
                         solins=solins_a, land_gc=land_gc, sulph=sulph,
                         hicel=hicel, aicel=aicel)

        # ---- sea ice (ice.F): dynamics, advection, thermodynamics ----
        g = self.ocean.g
        use_cpts = icfg.cpts > 0 and cpts_st is not None
        xint = yint = None
        if icfg.enabled:
            if icfg.evp:
                with record_function("evp_dynamics"):
                    uice, vice, sig_n, xint, yint = evp_dynamics(
                        ice.uice[0], ice.uice[1], ice.hice, ice.aice,
                        embm.tmsk, self.umsk, self.fcor_u, taux_w, tauy_w,
                        uocn, vocn, g, cfg.dtatm, icfg.ndte, embm.cyclic,
                        sig_in=ice.sig, xyminevp=self.xyminevp)
                if self.filt_uvice is not None:
                    uice = self.filt_uvice(uice)
                    vice = self.filt_uvice(vice)
                if icfg.cfl_cap:
                    # the cap protects the advection only: sig above is
                    # from the unclamped velocities
                    uice = torch.minimum(torch.maximum(uice, -self.uice_cap),
                                         self.uice_cap)
                    vice = torch.minimum(torch.maximum(vice, -self.vice_cap),
                                         self.vice_cap)
                if use_cpts:
                    # advect the whole thickness distribution, ridge under
                    # convergence, re-bin (adv_ridge_cpts, cpts.F:579-675)
                    cpts_st = cpts_mod.cpts_advect(
                        cpts_st, uice, vice, g, dts, icfg.niats, embm.cyclic)
                    ue = 0.5 * (uice + S(uice))
                    vn = 0.5 * (vice + W(vice))
                    vnc = vn * g.csu[:, None]
                    divu = g.cstr[:, None] * (
                        (ue - W(ue)) * 2.0 * g.dxt2r[None, :]
                        + (vnc - S(vnc)) * 2.0 * g.dyt2r[:, None])
                    cpts_st = cpts_mod.ridge(cpts_st, divu, dts,
                                             self._cpts_hstar)
                    cpts_st = cpts_mod.rebin(cpts_st, self._cpts_hstar)
                    hice, aice, hsno, _ = cpts_mod.aggregate(cpts_st)
                else:
                    hice, aice, hsno = (
                        ice_advection(f, uice, vice, g, dts, icfg.niats,
                                      embm.cyclic)
                        for f in (ice.hice, ice.aice, ice.hsno))
                ice = ice.replace(hice=torch.clamp(hice, min=0.0),
                                  aice=torch.clamp(aice, 0.0, 1.0),
                                  hsno=torch.clamp(hsno, min=0.0),
                                  uice=torch.stack([uice, vice]), sig=sig_n)
            ice, flx, oadj = ice_thermodynamics(
                ice, atm.at[0], atm.at[1], fl["rh"], sst, frzpt, solins_a,
                embm.aca, wspd_a, embm.elev, embm.tmsk, fl["dnswr"],
                fl["uplwr"], fl["upsens"], fl["upltnt"], fl["evap"], dts,
                float(self.grid.zw[0]), aicel=aicel)
            if use_cpts:
                # the multi-category thermodynamics over ocean cells takes
                # the place of the 0-layer result; the land-snow branch
                # stays from therm.F
                tm = embm.tmsk
                cpts_st, cflx, cadj, _ = cpts_mod.cpts_thermo(
                    cpts_st, atm.at[0], atm.at[1], sst, frzpt, solins_a,
                    embm.aca, wspd_a, tm, dts, self._cpts_saltz,
                    self._cpts_hstar, fl["dnswr"], fl["uplwr"],
                    fl["upsens"], fl["upltnt"], fl["evap"])
                cpts_st = cpts_mod.rebin(cpts_st, self._cpts_hstar)
                flx = {k: tm * cflx[k] + (1.0 - tm) * flx[k] for k in cflx}
                oadj = {k: tm * cadj[k] + (1.0 - tm) * oadj[k]
                        for k in ("heat", "freshwater")}
                hice_c, aice_c, hsno_c, tice_c = cpts_mod.aggregate(cpts_st)
                ice = ice.replace(
                    hice=tm * hice_c + (1.0 - tm) * ice.hice,
                    aice=tm * torch.clamp(aice_c, 0.0, 1.0)
                    + (1.0 - tm) * ice.aice,
                    hsno=tm * hsno_c + (1.0 - tm) * ice.hsno,
                    tice=tm * tice_c + (1.0 - tm) * ice.tice)
        else:
            flx = fl
            oadj = dict(heat=torch.zeros_like(sst),
                        freshwater=torch.zeros_like(sst))
        dnswr, uplwr = flx["dnswr"], flx["uplwr"]
        upsens, upltnt = flx["upsens"], flx["upltnt"]
        evap = flx["evap"]

        # ---- humidity transport + precipitation ----------------------
        forc_q = embm._zero_rows(dts / (C.RHOATM * C.SHQ) * evap)
        coefs_q = embm._coef(embm.diff_q, dts, winds=winds_a)
        rhs_q = embm._bc(at_old[1] + forc_q)
        shum = embm.solve_tracer(rhs_q, atm.at[1], coefs_q,
                                 embm.solver_tol, cfg.solver_maxiter)
        shum, precip, psno, rh, soilm_new, runoff = embm.precipitate(
            shum, atm, evap * embm.lmsk, torch.ones_like(evap), dts,
            hicel=hicel)

        # snowfall accumulates on sea ice / land snow (fluxes.F:363-420):
        # over the ocean only the ice-covered fraction holds snow
        if icfg.enabled:
            fc = dts / C.RHOSNO
            psno = torch.where(ice.hsno < 1000.0, psno, 0.0)
            psno = psno * torch.where(embm.tmsk > 0, ice.aice, 1.0)
            ice = ice.replace(hsno=ice.hsno + fc * psno)
            if use_cpts:
                # snowfall over the categories by area fraction
                atot = torch.clamp(cpts_st.A.sum(0), min=1e-10)
                cpts_st = cpts_st.replace(
                    hseff=cpts_st.hseff + fc * psno * embm.tmsk
                    * cpts_st.A / atot)

        # ---- temperature transport -----------------------------------
        forc_t = embm.temperature_forcing(dts, solins_a, dnswr,
                                          fl["outlwr"], uplwr, upsens,
                                          precip, psno)
        rhs_t = embm._bc(at_old[0] + forc_t)
        coefs_t = embm._coef(embm.diff_t, dts, winds=winds_a)
        sat = embm.solve_tracer(rhs_t, atm.at[0], coefs_t,
                                embm.solver_tol, cfg.solver_maxiter)

        new_atm = AtmState(
            at=torch.stack([sat, shum]), atm1=atm.at,
            soilm=soilm_new, soilm1=atm.soilm, surf=fl["surf"],
            nats=1 if mixing else atm.nats + 1)

        # ---- flux accumulation for the coupler (sum_flux) ------------
        ocean_msk = embm.tmsk
        disch = self.rivers.discharge(runoff * embm.lmsk)
        # ocean-surface stress: the wind stress, and where the EVP
        # dynamics ran the ice's share (IceConfig.ice_ocn_stress)
        taux_o, tauy_o = taux_w, tauy_w
        if xint is not None and icfg.ice_ocn_stress == "draglaw":
            # the reaction to the EVP water drag, with the turning
            # angle, blended by the ice fraction at U points
            ui, vi = ice.uice[0], ice.uice[1]
            dux = ui - uocn
            dvy = vi - vocn
            vrel = DRAGW_RHO * torch.sqrt(dux ** 2 + dvy ** 2)
            sinth_s = torch.sign(self.fcor_u) * SINTH
            tio_x = vrel * (COSTH * dux - sinth_s * dvy)
            tio_y = vrel * (COSTH * dvy + sinth_s * dux)
            a = ice.aice
            aice_u = 0.25 * (a + N(a) + E(a) + N(E(a)))
            taux_o = taux_w * (1.0 - aice_u) + (tio_x * aice_u) * self.umsk
            tauy_o = tauy_w * (1.0 - aice_u) + (tio_y * aice_u) * self.umsk
        elif xint is not None:
            # free drift: the ice's internal stress divergence passes to
            # the ocean, its magnitude capped when ice_ocn_stress_cap > 0
            cap = icfg.ice_ocn_stress_cap
            if cap > 0.0:
                mag = torch.sqrt(xint ** 2 + yint ** 2)
                scl = torch.clamp(cap / torch.clamp(mag, min=1e-12),
                                  max=1.0)
                xint = xint * scl
                yint = yint * scl
            taux_o = taux_w + xint * self.umsk
            tauy_o = tauy_w + yint * self.umsk
        # planetary absorbed shortwave (global_sums.F TOA balance)
        asw = (solins_a * embm.aca * C.SCATTER * (1.0 + C.PASS)
               + dnswr * (1.0 - C.SCATTER))
        acc = dict(
            heat=dts * (dnswr - uplwr - upltnt - upsens) * ocean_msk
            + oadj["heat"],
            freshwater=dts * (precip - evap - psno + disch) * ocean_msk
            + oadj["freshwater"],
            taux=dts * taux_o, tauy=dts * tauy_o, swr=dts * dnswr,
            wspd=dts * wspd_a, toa_sw=dts * asw, olr=dts * fl["outlwr"],
            precip=dts * precip, psno=dts * psno, evap=dts * evap,
            runoff=dts * runoff, uplwr=dts * uplwr, upsens=dts * upsens,
            upltnt=dts * upltnt, time=dts)
        if "cbf" in self.acc_names:
            # therm.F:440-460 cbf/cba accumulators (the 0-layer ice's)
            acc["cbf"] = torch.stack([oadj["brine_open"],
                                      oadj["brine_ice"]])
            acc["cba"] = dts * torch.stack([oadj["brine_ao"],
                                            oadj["brine_ai"]])
        return new_atm, ice, acc, cpts_st

    # ------------------------------------------------------------------
    def gosbc(self, acc, state: CoupledState, swr_mean, sed_flux=None,
              relyr=None, co2ccn=None, cfcccn=None, dc14ccn=None,
              surf=None):
        """Accumulated fluxes -> ocean forcing (gosbc.F:66-145): heat to
        cal/cm^2/s (~ K cm/s), freshwater to a virtual salt flux, wind
        and ice stress to the momentum flux.  With bgc tracers, their gas
        exchange on the segment-mean wind speed through the open water
        (gasbc.F:310-470) and the normalized virtual fluxes
        (gosbc.F:310-365).  ``sed_flux``: the sediments' dic and alk
        fluxes [umol/cm^2/s, positive into the ocean] into the bottom
        cells (tracer.F sed block).  ``relyr``, ``co2ccn``, ``cfcccn``
        (four CFC concentrations) and ``dc14ccn`` default to the
        host-side attributes; the stages pass workspace tensors.
        ``surf``: the surface tracers (nt, jmt, imt), by default
        ``state.ocean.t[:, 0]``."""
        relyr = self.relyr if relyr is None else relyr
        co2ccn = self.co2ccn if co2ccn is None else co2ccn
        cfcccn = self.cfcccn if cfcccn is None else cfcccn
        dc14ccn = self.dc14ccn if dc14ccn is None else dc14ccn
        atatm = acc["time"]
        fh = 2.389e-8 / atatm          # erg/cm^2/s -> cal/cm^2/s ~ K cm/s
        fs = -SOCN / atatm             # freshwater -> virtual salt flux
        tmsk = self.embm.tmsk
        hflx = fh * acc["heat"] * tmsk
        cbf_salt = cba_w = None
        if "cbf" in acc:
            # O_convect_brine: the ice growth/melt part of the virtual
            # salt flux goes through the per-category convection
            # (convect_brine.F), not the surface row
            mass = acc["cbf"]
            sflx = fs * (acc["freshwater"] - mass.sum(0)) * tmsk
            cbf_salt = fs * mass * tmsk[None]
            cba_w = torch.clamp(acc["cba"] / atatm, 0.0, 1.0) * tmsk[None]
        else:
            sflx = fs * acc["freshwater"] * tmsk
        smf = torch.stack([acc["taux"], acc["tauy"]]) / atatm / 1.035
        idx = self.ocean.tracer_index
        nt = self.ocean.nt
        stf = torch.stack([hflx, sflx])
        if nt > 2:
            if surf is None:
                surf = state.ocean.t[:, 0]
            sst, sss, _ = self.surface_bc(surf)
            ao = (1.0 - state.ice.aice) * tmsk
            cfc_atm = None
            if cfcccn is not None and "cfc11" in idx:
                c11n, c11s, c12n, c12s = cfcccn
                cfc_atm = (hemispheric_blend(self.tlat_deg, c11n, c11s),
                           hemispheric_blend(self.tlat_deg, c12n, c12s))
            gflux, _ = surface_gas_fluxes(
                *_chem(sst, sss, acc["wspd"] / atatm, ao, surf), idx,
                co2ccn=_chem(co2ccn),
                cfc_atm=None if cfc_atm is None else _chem(*cfc_atm),
                dc14ccn=_chem(dc14ccn))
            gflux = gflux.to(stf.dtype)
            # normalized virtual fluxes (gosbc.F:312-364): every bgc
            # tracer follows the salt flux anomaly scaled by its global
            # mean surface concentration
            area = self.area2d
            tsflx = torch.sum(sflx * area) / torch.sum(area)
            vflux = (sflx - tsflx) / SOCN
            gaost = torch.sum(surf * area[None], dim=(1, 2)) \
                / torch.sum(area)
            virt = gaost[:, None, None] * vflux[None]
            virt[:2] = 0.0
            stf = torch.cat([stf, torch.zeros_like(surf[2:])])
            stf = (stf + gflux + virt) * tmsk[None]
        btf = None
        if sed_flux is not None:
            # the kernel's sign: btf NEGATIVE = upward flux into the
            # bottom cell (1 umol/cm^2/s == 1 (mol/m^3)(cm/s))
            btf = torch.zeros_like(stf)
            btf[idx.idic] = -sed_flux["dic"]
            if "alk" in idx:
                btf[idx.ialk] = -sed_flux["alk"]
        return make_forcing(smf, stf, swr=swr_mean, aice=state.ice.aice,
                            hice=state.ice.hice, hsno=state.ice.hsno,
                            relyr=relyr, btf=btf, cbf=cbf_salt, cba=cba_w)

    def sediment_step(self, state: CoupledState, co2ccn, bottom=None):
        """The sediments' step on the segment's bottom water (sed.F, once
        a segment), before gosbc so that their return flux enters this
        segment's bottom forcing (tracer.F sed block).  ``bottom``: the
        tracers of the bottom cells (nt, jmt, imt), by default
        ``bottom_water(state.ocean.t, ...)``.  Returns (new sediment
        state, its dic and alk fluxes into the bottom water
        [umol/cm^2/s])."""
        if bottom is None:
            bottom = bottom_water(state.ocean.t, self._sed_kb)
        sed, sfl = self._sediment_step(state, _chem(co2ccn), bottom)
        dt = self.dtype
        cls, fields = SED_KINDS[sed_kind(sed)]
        return (cls(**{f: getattr(sed, f).to(dt) for f in fields}),
                {k: sfl[k].to(dt) for k in ("dic", "alk")})

    def _sediment_step(self, state, co2ccn, bottom):
        """sediment_step in CHEM_DTYPE."""
        idx = self.ocean.tracer_index
        bt = _chem(bottom)
        sss_b = bt[1] * 1000.0 + 35.0
        seg_s = self.cfg.time.segtim_days * 86400.0
        tmsk, depth = self._sed_tmsk, self._sed_depth
        temp_b = torch.clamp(bt[0], -2, 35)
        sal_b = torch.clamp(sss_b, 0, 45)
        cls, fields = SED_KINDS[sed_kind(state.sed)]
        sed = cls(**{f: _chem(getattr(state.sed, f)) for f in fields})
        if isinstance(sed, PoreWaterState):
            # Archer pore-water columns, coupled with the reference's
            # burial correction (sed.F:283-300): the water column keeps
            # the instant bottom redeposit of the particle rain (the
            # suite's bottom source), and the sediments return the
            # correction (dissolution + respiration - rain), normally
            # negative (net burial), as a bottom dic/alk flux
            z2 = torch.zeros_like(bt[0])
            rain_cal = z2
            rain_org = z2
            if self._sed_wc is not None:
                rain_cal = bt[idx["caco3"]] * self._sed_wc * 1.0e-9
            if self._sed_wd is not None:
                rain_org = bt[idx["detr"]] * self._sed_wd * 1.0e-6 \
                    * self._sed_redctn
            o2_bw = bt[idx.io2] * 1e-3 if "o2" in idx else z2 + 1.5e-4
            alk_bw = bt[idx.ialk] * 1e-3 if "alk" in idx else 2.37e-3 + z2
            sed, pw = porewater_step(
                sed, temp_b, sal_b, alk_bw, bt[idx.idic] * 1e-3,
                o2_bw, rain_cal, rain_org, depth * 1e-2, tmsk, seg_s)
            per_s = 1.0e6 / 3.15e7    # mol/cm^2/yr -> umol/cm^2/s
            corr_cal = (pw["ttrcal"] - rain_cal * 3.15e7) * per_s
            corr_org = (pw["ttrorg"] - rain_org * 3.15e7) * per_s
            return sed, dict(dic=(corr_cal + corr_org) * tmsk,
                             alk=2.0 * corr_cal * tmsk)
        alk = bt[idx.ialk] if "alk" in idx else 2.37 * torch.ones_like(bt[0])
        carb = co2calc_sws(temp_b, sal_b, bt[idx.idic], alk, co2ccn)
        return sed_step(sed, carb["co3"] * 1e-3, depth, tmsk, seg_s)

    # ------------------------------------------------------------------
    # the segment's stages on the flat workspace
    def _solins(self, relyr, solar_scale):
        """Seasonal insolation at the segment's midpoint (setembm /
        zenith), or the annual mean, scaled by the transient solar factor
        (solardata.F / volcdata.F)."""
        if self.cfg.embm.seasonal:
            yrlen = 360.0 if self.cfg.time.eqyear else 365.0
            day = torch.remainder(relyr, 1.0) * yrlen \
                + 0.5 * self.cfg.time.segtim_days
            solins = daily_insolation(self.tlat_rad2d, day, yrlen)
        else:
            solins = self.embm.solins
        return solins * solar_scale

    def stage_head(self, ws, host):
        """gasbc, the surface ocean currents for the ice drag, the
        insolation, the land's conductance and the anomalous winds;
        zeroed accumulators."""
        state = unpack_state(ws, host)
        u_surf = self.ocean.full_velocity(state.ocean.u, state.ocean.psi0)
        return self.head_fields(ws, state, state.ocean.t[:, 0],
                                u_surf[0, 0], u_surf[1, 0])

    def head_fields(self, ws, state, surf, uocn, vocn):
        """stage_head's entries from the surface tracers ``surf`` (nt,
        jmt, imt) and the surface currents ``uocn``, ``vocn``; the rest
        of ``state`` is read whole (atmosphere, land)."""
        sst, _, frzpt = self.surface_bc(surf)
        out = dict(sst=sst, frzpt=frzpt, uocn=uocn, vocn=vocn,
                   solins=self._solins(ws["relyr"], ws["solar_scale"]))
        if "awind_clim" in ws:
            # the SAT anomaly against the climatology perturbs the
            # advecting winds, the stress and the wind speed (winds.F)
            w2, tx2, ty2, ws2 = self.awind.apply(
                state.atm.at[0], self.embm.winds, self.taux_w, self.tauy_w,
                self.embm.wspd, t_clim=ws["awind_clim"])
            out.update({"wind/winds": w2, "wind/wspd": ws2,
                        "wind/taux": tx2, "wind/tauy": ty2})
        if state.land is not None:
            out["land_gc"] = state.land.gc * 100.0      # m/s -> cm/s
        z2 = torch.zeros_like(sst)
        for k in self.acc_names:
            if k == "time":
                out["acc/" + k] = torch.zeros((), dtype=sst.dtype,
                                              device=sst.device)
            elif k in BRINE_NAMES:
                out["acc/" + k] = torch.zeros((2,) + sst.shape,
                                              dtype=sst.dtype,
                                              device=sst.device)
            else:
                out["acc/" + k] = z2.clone()
        for k in ATAV_NAMES:
            out["atav/" + k] = z2.clone()
        return out

    def stage_atm(self, ws, host, mixing):
        """One atmosphere/ice substep and its accumulation."""
        state = unpack_state(ws, host)
        self.embm.last_trips = []
        wind_pkg = None
        if "wind/winds" in ws:
            wind_pkg = tuple(ws["wind/" + k]
                             for k in ("winds", "wspd", "taux", "tauy"))
        landice = (ws["hicel"], ws["aicel"]) if "hicel" in ws else None
        atm, ice, a, cpts = self._atm_ice_step_impl(
            state.atm, state.ice, ws["sst"], ws["frzpt"], ws["uocn"],
            ws["vocn"], ws["anthro"], ws["solins"], ws.get("land_gc"),
            wind_pkg, ws.get("sulph"), landice, state.cpts, mixing=mixing)
        out = {"acc/" + k: ws["acc/" + k] + a[k] for k in self.acc_names}
        tav = dict(sat=atm.at[0], shum=atm.at[1], hice=ice.hice,
                   aice=ice.aice, hsno=ice.hsno, soilm=atm.soilm,
                   tice=ice.tice, uice=ice.uice[0], vice=ice.uice[1])
        out.update({"atav/" + k: ws["atav/" + k] + v
                    for k, v in tav.items()})
        out.update(pack_atm(atm))
        out.update(pack_ice(ice))
        if cpts is not None:
            out.update(pack_cpts(cpts))
        out["trips_q"], out["trips_t"] = self.embm.last_trips
        host["nats"] = atm.nats
        return out

    def stage_mid(self, ws, host):
        """Segment means of the atmosphere, the land update and gosbc."""
        state = unpack_state(ws, host)
        t = state.ocean.t
        bottom = bottom_water(t, self._sed_kb) if self._sed_on else None
        return self.mid_fields(ws, state, t[:, 0], bottom)

    def mid_fields(self, ws, state, surf, bottom):
        """stage_mid's entries from the surface tracers ``surf`` and the
        bottom cells' tracers ``bottom`` (nt, jmt, imt; None without
        sediments); the ocean's time means start from zeros shaped as
        ``state.ocean``'s fields."""
        acc = {k: ws["acc/" + k] for k in self.acc_names}
        atm = state.atm
        out = {"tavg/" + k: ws["atav/" + k] / self.ntspas
               for k in ATAV_NAMES}
        at_n = acc["time"]
        for nm in ("precip", "evap", "runoff", "olr", "swr", "uplwr",
                   "upsens", "upltnt", "psno", "wspd", "toa_sw"):
            out["tavg/" + nm] = acc[nm] / at_n
        swr_mean = acc["swr"] / acc["time"]

        # ---- land model segment update (mtlm.F; glsbc coupling) -------
        land = state.land
        if land is not None:
            rh_mean = torch.clamp(atm.at[1] / (3.8011e-3 * torch.exp(
                17.67 * atm.at[0] / (atm.at[0] + 243.5))), 0.0, 1.0)
            # acc["time"] is the leapfrog-weighted interval sum; the
            # prognostic update integrates over the physical segment
            seg_phys = self.cfg.time.segtim_days * 86400.0
            land, lflux = mtlm_physics_step(
                land, self.embm.lmsk, atm.at[0], atm.at[1], swr_mean,
                rh_mean, atm.soilm / 15.0, co2_ppm=ws["co2ccn"],
                precip=acc["precip"] / acc["time"] * 10.0,
                psno=acc["psno"] / acc["time"] * 10.0,
                wspd=acc["wspd"] / acc["time"] * 0.01,
                dt=seg_phys)
            out["nep"] = torch.sum(lflux["nep"] * self.area2d_land) * 1.0e-4
            # TRIFFID every segment: gamma = 360 d / segment days
            land, _ = triffid_update(land, self.embm.lmsk,
                                     360.0 / self.cfg.time.segtim_days)
            out.update({"tavg/m_soil": land.m_soil,
                        "tavg/lying_snow": land.lying_snow,
                        "tavg/tsoil": land.tsoil, "tavg/cs": land.cs,
                        "tavg/veg_frac": torch.sum(land.frac[:5], dim=0),
                        "tavg/nep": lflux["nep"]})
            out.update(pack_land(land))

        # ---- sediments (sed.F, once a segment) ------------------------
        sfl = None
        if self._sed_on:
            sed, sfl = self.sediment_step(state, ws["co2ccn"], bottom)
            state.sed = sed
            out.update(pack_sed(sed))

        forcing = self.gosbc(acc, state, swr_mean, sed_flux=sfl,
                             relyr=ws["relyr"], co2ccn=ws["co2ccn"],
                             cfcccn=ws.get("cfcccn"),
                             dc14ccn=ws["dc14ccn"], surf=surf)
        out.update({"forcing/" + k: getattr(forcing, k)
                    for k in self.forcing_names})
        z3 = torch.zeros_like(state.ocean.t[0])
        for k in OTAV_NAMES:
            out["otav/" + k] = (torch.zeros_like(state.ocean.psi0)
                                if k == "psi" else z3.clone())
        if self.ocean.nt > 2:
            out["otav/surf_tracers"] = torch.zeros_like(state.ocean.t[:, 0])
        return out

    def stage_ocean(self, ws, host, leapfrog):
        """One ocean step with run_scan's semantics and its per-step
        time-mean accumulation (tracer.F:420-443, mom_tavg.F)."""
        state = unpack_state(ws, host)
        forcing = make_forcing(**{k: ws["forcing/" + k]
                                  for k in self.forcing_names})
        om = self.ocean
        oc = om._step(state.ocean, forcing, leapfrog=leapfrog, scan=True)
        uf = om.full_velocity(oc.u, oc.psi0)
        vet, vnt, vbt, *_ = adv_vel(uf[0], uf[1], om.g, om.cyclic)
        tT = oc.t[0]
        tav = step_means(tT, E(tT), uf, vet, vnt, vbt, om.g, om.diff_cbt,
                         self.cfg.ocean.ah)
        return self.ocean_fields(ws, host, oc, tav, om.last_cg_iters)

    def ocean_fields(self, ws, host, oc, tav, cg_iters):
        """stage_ocean's entries after the step ``oc``: ``tav`` (the
        neighbour-reading means of ``step_means``) and the column-local
        means added to the accumulators, the new ocean state."""
        om = self.ocean
        tav = dict(tav, salt=oc.t[1], psi=oc.psi0,
                   rho=eos_state_from(om.eos_c, om.eos_to, om.eos_so, oc.t))
        out = {"otav/" + k: ws["otav/" + k] + tav[k] for k in OTAV_NAMES}
        if om.nt > 2:
            out["otav/surf_tracers"] = ws["otav/surf_tracers"] + oc.t[:, 0]
        out.update(pack_ocean(oc))
        out["cg_iters"] = cg_iters
        host["itt"] = oc.itt
        return out

    def stage_tail(self, ws, host):
        """Segment means of the ocean; the bolus velocities and the
        convection extent of the end-of-segment state."""
        state = unpack_state(ws, host)
        ocean = state.ocean
        om = self.ocean
        out = self.tail_means(ws)
        # GM eddy-induced (bolus) velocities for the residual overturning
        # (mom_tavg.F O_gm_diag rows), from the end-of-segment tracers
        if self.cfg.ocean.isopycmix and self.cfg.ocean.gent_mcwilliams:
            from ..models.ocean.isopyc import compute_isopyc
            iso_d = compute_isopyc(ocean.t, om.tmask, om.kmt, om.eos_c,
                                   om.eos_to, om.eos_so, om.g,
                                   self.cfg.ocean, om.cyclic,
                                   addisop=om.addisop)
            out.update(bolus_means(iso_d, om.diff_cbt))
        # convective-adjustment extent (O_save_convection analog)
        if self.cfg.ocean.convection == "full":
            out.update(self.convection_means(ocean.t, om.kmt))
        return out

    def convection_means(self, t, kmt):
        """The convective-adjustment extent of the tracers ``t``."""
        from ..ops.convection import convection_extent
        om = self.ocean
        cdep, cnreg = convection_extent(t, kmt, om.eos_c, om.eos_to,
                                        om.eos_so, om.dztxcl, om.g.dzt)
        return {"tavg/convect_depth": cdep,
                "tavg/convect_nreg": cnreg.to(cdep.dtype)}

    def tail_means(self, ws):
        """The segment means of the accumulators (the ocean's with the
        shape of its accumulators, the fluxes' whole)."""
        om = self.ocean
        out = {"tavg/" + k: ws["otav/" + k] / self.ntspos
               for k in OTAV_NAMES}
        out["tavg/salt"] = out["tavg/salt"] * 1000.0 + 35.0
        if om.nt > 2:
            # the bgc tracers' surface means (mom_tavg.F)
            surf = ws["otav/surf_tracers"] / self.ntspos
            for n, tr in enumerate(om.tracer_index.tracers[2:], start=2):
                out["tavg/surf_" + tr.name] = surf[n]
        acc = {k: ws["acc/" + k] for k in ACC_NAMES}
        at = acc["time"]
        tmsk = self.embm.tmsk
        out["tavg/hflx"] = 2.389e-8 * acc["heat"] / at * tmsk
        out["tavg/sflx"] = -SOCN * acc["freshwater"] / at * tmsk
        out["tavg/taux"] = acc["taux"] / at / 1.035
        out["tavg/tauy"] = acc["tauy"] / at / 1.035
        return out

    def schedule(self, host):
        """The stages of one segment from the host counters: (name, flag)
        pairs, the flag being mixing for an atm stage and leapfrog for an
        ocean stage."""
        namix, nmix = self.cfg.embm.namix, self.cfg.ocean.nmix
        nats, itt = host["nats"], host["itt"]
        stages = [("head", None)]
        for _ in range(self.ntspas):
            mixing = nats + 1 > namix
            stages.append(("atm", mixing))
            nats = 1 if mixing else nats + 1
        stages.append(("mid", None))
        for _ in range(self.ntspos):
            stages.append(("ocean", (itt % nmix) != 0))
            itt += 1
        stages.append(("tail", None))
        return stages

    def stage(self, name, flag, ws, host):
        """The entries one stage changes (a profiler range names it)."""
        with record_function("stage_" + name):
            if name == "atm":
                return self.stage_atm(ws, host, flag)
            if name == "ocean":
                return self.stage_ocean(ws, host, flag)
            return getattr(self, "stage_" + name)(ws, host)

    # ------------------------------------------------------------------
    def _finish(self, ws, host, logs) -> CoupledState:
        self.last_acc = {k: ws["acc/" + k] for k in self.acc_names}
        self.last_forcing = {k: ws["forcing/" + k]
                             for k in self.forcing_names}
        self.last_tavg = {k[5:]: v for k, v in ws.items()
                          if k.startswith("tavg/")}
        self.last_nep_kgC_s = ws.get("nep")
        self.seg_cg_iters = torch.stack(logs["cg_iters"])
        self.seg_trips = torch.stack(
            [torch.stack(p) for p in zip(logs["trips_q"], logs["trips_t"])])
        return unpack_state(ws, host)

    def run_segment(self, state: CoupledState) -> CoupledState:
        """One coupled segment, its stages taken eagerly; the transport
        solves stop on a host read of their convergence flag.
        ``last_tavg`` holds the segment's time means, ``last_acc`` its
        flux totals, ``last_forcing`` its ocean forcing (``FORCING_NAMES``:
        the surface and bottom tracer fluxes ``stf``, ``btf``, ...),
        ``seg_cg_iters`` the CG iterations of each ocean
        step and ``seg_trips`` the BiCGSTAB trips (humidity,
        temperature) of each atmosphere step."""
        return run_stages(self, state)

    def run(self, state: CoupledState, nseg: int,
            eager: bool = False, yrlen: float | None = None) -> CoupledState:
        """``nseg`` segments, ``relyr`` advancing by a segment each (of a
        year of ``yrlen`` days, by default the calendar's: the repo's
        precision and probe tools count 365), the
        transient forcing (when set) taken at each segment's year.  On
        the card each stage is the replay of its captured CUDA graph
        (``graphs.SegmentGraphs``, captured at the first call and again
        when the workspace's structure changes; a capture that fails
        raises); on the CPU, or with ``eager``, the segments run eagerly
        (``run_segment``)."""
        seg_days = self.cfg.time.segtim_days
        if yrlen is None:
            yrlen = 360.0 if self.cfg.time.eqyear else 365.0
        for _ in range(nseg):
            if self.transient is not None:
                self._update_transient()
            if eager or self.device.type == "cpu":
                state = self.run_segment(state)
            else:
                inputs = self.segment_inputs()
                if self._graphs is None \
                        or set(self._graphs.inputs) != set(inputs):
                    from .graphs import SegmentGraphs
                    self._graphs = None     # free the old graphs first
                    self._graphs = SegmentGraphs(self, state, inputs)
                state = self._graphs.run(state, inputs)
            self.relyr += seg_days / yrlen
        return state


def run_stages(model, state: CoupledState) -> CoupledState:
    """One segment's stages taken eagerly on a workspace: ``model``
    gives the stages (``schedule``, ``stage``), the segment's inputs
    (``segment_inputs``) and keeps the records (``_finish``)."""
    ws = pack_state(state)
    ws.update(model.segment_inputs())
    host = host_of(state)
    logs = dict(cg_iters=[], trips_q=[], trips_t=[])
    for name, flag in model.schedule(host):
        ws.update(model.stage(name, flag, ws, host))
        if name == "ocean":
            logs["cg_iters"].append(ws["cg_iters"])
        elif name == "atm":
            logs["trips_q"].append(ws["trips_q"])
            logs["trips_t"].append(ws["trips_t"])
    return model._finish(ws, host, logs)


def bottom_water(t, kb):
    """The tracers (nt, jmt, imt) of the bottom cells ``kb`` of ``t``."""
    return torch.gather(t, 1, kb[None, None].expand(
        t.shape[0], 1, -1, -1))[:, 0]


def step_means(tT, tE, uf, vet, vnt, vbt, g, diff_cbt, ah):
    """The per-step time means that read neighbours (tracer.F:420-443,
    mom_tavg.F): of the temperature ``tT``, its east neighbours ``tE``,
    the full velocity ``uf`` and the face velocities, with the grid
    factors of ``g``."""
    return dict(
        temp=tT, u=uf[0], v=uf[1], w=vbt,
        adv_fe_temp=vet * (tT + tE), adv_fn_temp=vnt * (tT + N(tT)),
        adv_fb_temp=vbt * (tT + DN(tT)),
        dif_fe_temp=ah * g.cstdxur[None] * (tE - tT),
        dif_fn_temp=(ah * (g.csu * g.dyur)[None, :, None] * (N(tT) - tT)),
        dif_fb_temp=diff_cbt * g.dzwr[1:][:, None, None] * (tT - DN(tT)))


def bolus_means(iso, diff_cbt):
    """The GM bolus velocities and the effective vertical diffusivity of
    the isopycnal fields ``iso``."""
    return {"tavg/vetiso": iso.vetiso, "tavg/vntiso": iso.vntiso,
            "tavg/wbtiso": iso.vbtiso, "tavg/diff_cbt_eff": diff_cbt + iso.K33}


# ----------------------------------------------------------------------
# the workspace: the coupled state as a flat dict of tensors under the
# restart's key names, the counters on the host


def pack_ocean(o: OceanState):
    return {"ocean/" + f: getattr(o, f) for f in OCEAN_FIELDS}


def pack_atm(a: AtmState):
    return {"atm/" + f: getattr(a, f) for f in ATM_FIELDS}


def pack_ice(i: IceState):
    return {"ice/" + f: getattr(i, f) for f in ICE_FIELDS}


def pack_land(la: LandState):
    return {"land/" + f: getattr(la, f) for f in LAND_FIELDS}


def pack_sed(sed) -> dict:
    _, fields = SED_KINDS[sed_kind(sed)]
    return {"sed/" + f: getattr(sed, f) for f in fields}


def pack_cpts(c: CptsState):
    return {"cpts/" + f: getattr(c, f) for f in CPTS_FIELDS}


def pack_state(state: CoupledState) -> dict:
    ws = {**pack_ocean(state.ocean), **pack_atm(state.atm),
          **pack_ice(state.ice)}
    if state.land is not None:
        ws.update(pack_land(state.land))
    if state.sed is not None:
        ws.update(pack_sed(state.sed))
    if state.cpts is not None:
        ws.update(pack_cpts(state.cpts))
    return ws


def unpack_state(ws, host) -> CoupledState:
    ocean = OceanState(itt=host["itt"], **{f: ws["ocean/" + f]
                                           for f in OCEAN_FIELDS})
    atm = AtmState(nats=host["nats"], **{f: ws["atm/" + f]
                                         for f in ATM_FIELDS})
    ice = IceState(**{f: ws["ice/" + f] for f in ICE_FIELDS})
    land = None
    if host["land"]:
        land = LandState(**{f: ws["land/" + f] for f in LAND_FIELDS})
    sed = None
    if host.get("sed") is not None:
        cls, fields = SED_KINDS[host["sed"]]
        sed = cls(**{f: ws["sed/" + f] for f in fields})
    cpts = None
    if host.get("cpts"):
        cpts = CptsState(**{f: ws["cpts/" + f] for f in CPTS_FIELDS})
    return CoupledState(ocean=ocean, atm=atm, ice=ice, land=land, sed=sed,
                        cpts=cpts)

