"""Typed configuration tree of the PyTorch port.

``uvic_tpu.config`` with the same field names and defaults, so one set
of options builds the same model in both packages.
The reference's compile-time CPP flags (``O_*``, run/mk.in) are static
bools/enums and its namelist parameters plain floats/ints.  Options the
port does not implement yet are rejected by ``OceanModel``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


class TracerAdvection:
    """tracer advection scheme (O_fct | O_quicker | default centered)."""
    CENTERED = "centered"
    FCT = "fct"          # Zalesak flux-corrected transport (default, mk.in)
    QUICKER = "quicker"
    UPSTREAM = "upstream"


class BarotropicMode:
    STREAM_FUNCTION = "stream_function"   # O_stream_function (default)
    SURFACE_PRESSURE = "surface_pressure"  # O_rigid_lid_surface_pressure
    IMPLICIT_FREE_SURFACE = "implicit_free_surface"  # O_implicit_free_surface


class VerticalMixing:
    CONST = "const"       # O_constvmix (default)
    PP = "ppmix"          # O_ppmix Pacanowski-Philander
    TIDAL = "tidal_kv"    # O_tidal_kv addition


class HorizontalMixing:
    CONST = "const"       # O_consthmix (default)
    SMAGORINSKY = "smagnl"
    BIHARMONIC = "biharmonic"


class Convection:
    NCON = "ncon"         # standard ncon-pass scheme (convect.F:1)
    FULL = "full"         # O_fullconvect, Rahmstorf complete scheme (convct2)


# ---------------------------------------------------------------------------
# grid config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GridConfig:
    """Grid construction parameters (reference: grids.F gcell/gcoord).

    The standard UVic grid is 3.6 deg x 1.8 deg with 19 vertical levels
    (source/common/size.h:27, imt=102 jmt=102 km=19 including one boundary
    cell on each horizontal edge). The reference reads the grid from a data
    file not present in the repo; we regenerate it with the gcell
    cosine-stretch algorithm (grids.F:233-377).
    """
    imt: int = 102
    jmt: int = 102
    km: int = 19
    # horizontal domain [degrees]; uniform resolution regions
    x_bounds: Tuple[float, ...] = (0.0, 360.0)
    x_res: Tuple[float, ...] = (3.6, 3.6)
    y_bounds: Tuple[float, ...] = (-90.0, 90.0)
    y_res: Tuple[float, ...] = (1.8, 1.8)
    # vertical domain [cm]; stretched from ~50 m surface cells to ~580 m
    # bottom cells, 19 levels, ~6000 m total depth (the reference grid file
    # is not in the repo; these bounds reproduce its character)
    z_bounds: Tuple[float, ...] = (0.0, 6080.0e2)
    z_res: Tuple[float, ...] = (50.0e2, 582.0e2)
    z_stretch: float = 1.0
    cyclic: bool = True   # O_cyclic


# ---------------------------------------------------------------------------
# ocean (MOM) config — mixing namelist (control.in &mixing, &isopyc, ...)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OceanConfig:
    enabled: bool = True                       # O_mom
    # timesteps [s] (control.in &tsteps)
    dtts: float = 108000.0                     # tracer timestep
    dtuv: float = 1125.0                       # momentum timestep
    dtsf: float = 1125.0                       # barotropic timestep
    # mixing (control.in &mixing)
    am: float = 1.5e9                          # lateral viscosity [cm^2/s]
    ah: float = 8.0e6                          # lateral diffusivity [cm^2/s]
    kappa_m: float = 10.0                      # vertical viscosity [cm^2/s]
    kappa_h: float = 0.35                      # vertical diffusivity [cm^2/s]
    aidif: float = 0.5                         # implicit vertical-diffusion fraction
    nmix: int = 16                             # steps between mixing timesteps
    # depth-dependent tracer-timestep acceleration (accel.h dtxcel):
    # factor 1 above dtxcel_z0, ramping linearly in depth to
    # dtxcel_deep at the bottom level.  The reference's asynchronous
    # deep-acceleration for spinups; distorts transients, exact at
    # equilibrium (Bryan 1984).
    dtxcel_deep: float = 1.0
    dtxcel_z0: float = 1.0e5                   # ramp start depth [cm]
    eb: bool = False                           # Euler backward (vs forward) mixing
    ncon: int = 1                              # convection passes (ncon scheme)
    cdbot: float = 1.3e-3                      # bottom drag coefficient
    # polar-cap bottom-drag enhancement (round 5): the enclosed Arctic
    # basin (beta ~ 0, H ~ 2.5 km, 7-40 km cells) integrates any weak
    # residual torque into a slowly growing barotropic gyre; scaling
    # the quadratic bottom drag by this factor north of cdbot_polar_lat
    # bounds it locally (a standard polar sponge; no effect elsewhere)
    cdbot_polar_scale: float = 1.0
    cdbot_polar_lat: float = 83.0
    acor: float = 0.0                          # implicit coriolis factor
    # O_restorst: Newtonian surface restoring toward climatology
    # (uncoupled-ocean path; see io/timeforce.restoring_stf)
    restorst: bool = False
    dampts: Tuple[float, ...] = (30.0, 60.0)   # restoring timescale [days] (T,S)
    dampdz: Tuple[float, ...] = (50.0e2, 50.0e2)
    # barotropic solver (control.in &riglid)
    mxscan: int = 200
    tolrsf: float = 5.0e8
    tolrsp: float = 1.0e-4                     # surface-pressure tolerance
    tolrfs: float = 1.0e-4                     # free-surface tolerance
    # isopycnal mixing (control.in &isopyc)
    slmx: float = 0.01                         # max isopycnal slope
    ahisop: float = 1.2e7                      # isopycnal diffusivity [cm^2/s]
    athkdf: float = 8.0e6                      # GM thickness diffusivity [cm^2/s]
    del_dm: float = 0.4e-2                     # transition for scaling dimension
    s_dm: float = 0.1e-2                       # half width scaling for dm taper
    # scheme selection (static flags)
    tracer_advection: str = TracerAdvection.FCT
    fct_variant: str = "dlm1"                  # O_fct_dlm1 | O_fct_dlm2
    fct_3d: bool = False                       # O_fct_3d extra delimiter
    convect_brine: bool = False                # O_convect_brine
    barotropic: str = BarotropicMode.STREAM_FUNCTION
    vmix: str = VerticalMixing.CONST
    hmix: str = HorizontalMixing.CONST
    ambi: float = 1.0e23                       # biharmonic viscosity [cm^4/s]
    ahbi: float = 5.0e22                       # biharmonic diffusivity [cm^4/s]
    smag_diff_back: float = 0.0                # background diff under smagnl
    convection: str = Convection.FULL
    isopycmix: bool = True                     # O_isopycmix (Redi)
    gent_mcwilliams: bool = True               # O_gent_mcwilliams
    full_tensor: bool = False                  # O_full_tensor (vs small-angle)
    dm_taper: bool = False                     # O_dm_taper slope taper
    tidal_kv: bool = False                     # O_tidal_kv addition to kappa_h
    sf_npt: int = 5                            # O_sf_5_point | O_sf_9_point
    fourfil: bool = True                       # high-lat filtering on/off
    hlat_filter: str = "fir"                   # "fir" (O_firfil) | "fourier" (O_fourfil)
    # shortwave penetration (O_shortwave)
    shortwave: bool = False
    # geothermal bottom heat flux (O_gthflx, updates/09 bhf.F)
    gthflx: bool = False
    # Neptune topographic stress (O_neptune, neptune.F): lateral
    # friction relaxes toward the Holloway eddy-topography equilibrium
    # flow; only active on the const-hmix (incl. aniso) path like the
    # reference's O_consthmix && !O_biharmonic gate
    neptune: bool = False
    spnep: float = 3.0e5                       # polar length scale [cm]
    senep: float = 12.0e5                      # equatorial length scale [cm]
    # Large et al. (2001) tropical anisotropic viscosity
    # (O_anisotropic_viscosity, updates/08 hmixc.F:66-147)
    aniso_visc: bool = False
    # Getzlaff & Dietze (2013) equatorial zonal isopycnal mixing
    # (O_anisotropic_zonal_mixing, updates/08 isopyc.F:243-260)
    aniso_zonal: bool = False


# ---------------------------------------------------------------------------
# atmosphere (EMBM)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EmbmConfig:
    enabled: bool = True                       # O_embm
    dtatm: float = 54000.0                     # atm timestep [s]
    namix: int = 10                            # steps between atm mixing steps
    # transports are solved implicitly (BiCGSTAB on the 5-point operator)
    solver_tol: float = 1.0e-10
    solver_maxiter: int = 200
    adiff: float = 0.03                        # anomaly diffusion factor (&embm)
    rhmax: float = 0.85                        # max relative humidity before precip
    awind: bool = False                        # O_embm_awind anomalous winds
    seasonal: bool = False                     # seasonally varying insolation


@dataclass(frozen=True)
class IceConfig:
    enabled: bool = True                       # O_ice
    evp: bool = True                           # O_ice_evp dynamics
    ndte: int = 30                             # EVP subcycles per dynamics step
    niats: int = 1                             # advection substeps
    cpts: int = 0                              # O_ice_cpts3/5/10 category count
    nlay: int = 4                              # enthalpy layers per category
    # advective-CFL cap on the ice velocity entering advection
    # (|u| <= 0.4 dx/dtatm per cell); the EVP stress is computed from the
    # unclamped velocities
    cfl_cap: bool = True
    # "draglaw": the ocean feels the quadratic ice-ocean drag over the
    # ice-covered fraction; "freedrift": wind stress + the internal
    # stress divergence (embm.F:188-201)
    ice_ocn_stress: str = "draglaw"
    ice_ocn_stress_cap: float = 5.0            # |xint| bound in freedrift mode


@dataclass(frozen=True)
class LandConfig:
    enabled: bool = False                      # O_mtlm
    segday: bool = True                        # O_mtlm_segday


@dataclass(frozen=True)
class SedConfig:
    enabled: bool = False                      # O_sed
    dtsed: float = 108000.0
    porewater: bool = True


@dataclass(frozen=True)
class BgcConfig:
    """Biogeochemistry: none | npzd | mobi tracer suites."""
    suite: str = "none"                        # "none" | "npzd" | "mobi"
    carbon: bool = False                       # O_carbon (DIC)
    carbon_13: bool = False
    carbon_14: bool = False
    alk: bool = False                          # O_npzd_alk
    o2: bool = False                           # O_npzd_o2
    nitrogen: bool = False                     # O_npzd_nitrogen
    nitrogen_15: bool = False
    silicon: bool = False                      # O_mobi_silicon
    iron: bool = False                         # O_mobi_iron
    caco3: bool = False                        # O_mobi_caco3
    pa_th: bool = False                        # O_PaTh scavenging tracers
    cfc: bool = False                          # O_cfcs_data_transient
    dtnpzd: float = 27000.0                    # bgc source substep [s]


def mobi_full() -> "BgcConfig":
    """The reference's configured MOBI suite (run/mk.in Model_Options):
    full isotope-enabled biogeochemistry, 41 tracers with T and S."""
    return BgcConfig(suite="mobi", carbon=True, carbon_13=True,
                     carbon_14=True, alk=True, o2=True, nitrogen=True,
                     nitrogen_15=True, silicon=True, iron=True,
                     caco3=True, pa_th=True, cfc=True)


# ---------------------------------------------------------------------------
# run control / time management
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TimeConfig:
    runlen_days: float = 3650.0                # control.in &contrl
    segtim_days: float = 5.0                   # coupling segment [days]
    init: bool = True                          # cold start vs restart
    eqyear: bool = True                        # equal-month calendar
    year0: int = 0
    month0: int = 1
    day0: int = 1
    # output intervals [days] (&diagn)
    tsiint: float = 10.0
    timavgint: float = 3650.0
    restint: float = 36500.0


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh configuration; ``checks.validate`` holds ``mesh_shape`` to
    the halo law of ``parallel.shard_step.ShardedOceanStep``."""
    mesh_shape: Tuple[int, int] = (1, 1)       # devices along (y, x)
    axis_names: Tuple[str, str] = ("y", "x")
    halo: int = 2
    deterministic_reductions: bool = False


@dataclass(frozen=True)
class ModelConfig:
    grid: GridConfig = field(default_factory=GridConfig)
    ocean: OceanConfig = field(default_factory=OceanConfig)
    embm: EmbmConfig = field(default_factory=EmbmConfig)
    ice: IceConfig = field(default_factory=IceConfig)
    land: LandConfig = field(default_factory=LandConfig)
    sed: SedConfig = field(default_factory=SedConfig)
    bgc: BgcConfig = field(default_factory=BgcConfig)
    time: TimeConfig = field(default_factory=TimeConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    dtype: str = "float64"                     # "-r8" contract; f32 on the card

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return _replace(self, **kw)


def small_config(imt: int = 34, jmt: int = 34, km: int = 8,
                **kw) -> ModelConfig:
    """Small config for fast tests: ~10.8 deg x 5.4 deg, 8 levels."""
    g = GridConfig(
        imt=imt, jmt=jmt, km=km,
        x_res=(360.0 / (imt - 2),) * 2,
        y_res=(180.0 / (jmt - 2),) * 2,
        z_bounds=(0.0, km * 200.0e2),
        z_res=(200.0e2, 200.0e2),
    )
    return ModelConfig(grid=g, **kw)


def earth_config(dtype: str = "float32", accel: float = 1.0,
                 **kw) -> ModelConfig:
    """The flagship coupled real-Earth configuration: standard grid,
    FCT + GM/Redi + tidal kv + geothermal + anisotropic viscosity,
    seasonal EMBM, land model on.  ``accel`` > 1 enables the accel.h
    deep tracer-timestep acceleration (spinup only)."""
    cfg = ModelConfig(dtype=dtype, **kw)
    return cfg.replace(
        ocean=_replace(
            cfg.ocean, isopycmix=True, gent_mcwilliams=True,
            tidal_kv=True, gthflx=True, aniso_visc=True,
            aniso_zonal=True, dtxcel_deep=float(accel),
            athkdf=1.2e7, cdbot_polar_scale=20.0),
        embm=_replace(cfg.embm, seasonal=True),
        land=_replace(cfg.land, enabled=True))


def tools_earth_config(dtype: str = "float32", land: bool = True
                       ) -> ModelConfig:
    """The earth model of the repo's acceptance and analysis tools
    (``run_earth``, ``tune_earth``, ``probes``; ``scripts/run_earth.py:
    31-39``): the physics of ``earth_config`` without its GM thickness
    diffusivity and polar bottom drag, the land model on unless ``land``
    is False (``scripts/probe_closure.py:33-38``)."""
    cfg = ModelConfig(dtype=dtype)
    return cfg.replace(
        ocean=_replace(
            cfg.ocean, isopycmix=True, gent_mcwilliams=True,
            tidal_kv=True, gthflx=True, aniso_visc=True,
            aniso_zonal=True),
        embm=_replace(cfg.embm, seasonal=True),
        land=_replace(cfg.land, enabled=land))
