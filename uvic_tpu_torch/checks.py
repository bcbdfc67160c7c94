"""Configuration consistency checking (checks.F + UVic_ESCM.F chkcpl).

Port of ``uvic_tpu.checks``, pure Python against the port's
``ModelConfig`` (the same fields): ``validate(cfg)`` raises
``ConfigError`` for the rules the reference refuses to start with
(source/mom/checks.F:1-700, source/common/UVic_ESCM.F:418-733:
``errorc = .true.`` -> stop) and returns the warning strings of its
adjust-and-warn rules, the reference's messages word for word.
"""

from __future__ import annotations

import math
from typing import List

from .config import ModelConfig


class ConfigError(ValueError):
    """A configuration the reference would refuse to start with."""


def validate(cfg: ModelConfig) -> List[str]:
    """Raise ConfigError on fatal inconsistencies; return warnings."""
    errors: List[str] = []
    warnings: List[str] = []
    o = cfg.ocean
    g = cfg.grid
    b = cfg.bgc

    # --- grid sanity (checks.F:40-52) --------------------------------
    if g.imt < 3:
        errors.append("imt must be >= 3 (checks.F:40)")
    if g.jmt < 4:
        errors.append("jmt must be >= 4 (checks.F:45)")
    if g.km < 1:
        errors.append("km must be >= 1")

    # --- timesteps (checks.F:407-425) ---------------------------------
    if o.dtsf <= 0:
        errors.append("external-mode timestep dtsf must be > 0 "
                      "(checks.F:407)")
    if o.dtuv <= 0:
        errors.append("internal-mode timestep dtuv must be > 0 "
                      "(checks.F:413)")
    if o.dtts <= 0:
        errors.append("tracer timestep dtts must be > 0 (checks.F:419)")
    if o.dtts > 0 and o.dtuv > 0 and o.dtts < o.dtuv:
        warnings.append("dtts < dtuv: tracer acceleration expects "
                        "dtts >= dtuv")

    # --- coupling cadence (chkcpl, UVic_ESCM.F:530-560) ---------------
    seg_s = cfg.time.segtim_days * 86400.0
    for name, dt in (("dtts", o.dtts), ("dtatm", cfg.embm.dtatm)):
        if dt > 0:
            ratio = seg_s / dt
            if abs(ratio - round(ratio)) > 1e-6:
                errors.append(
                    f"segment length ({cfg.time.segtim_days} days) is "
                    f"not a whole number of {name} steps "
                    f"(ratio {ratio:.4f}); the reference rounds the "
                    "segment — set segtim_days or the timestep so they "
                    "divide (chkcpl)")
    # even-fluxes parity rule (UVic_ESCM.F:557-566): the number of
    # steps per segment and the mixing interval must have the same
    # parity or leapfrog mixing drifts against the segment boundary
    if o.dtts > 0:
        nsteps = round(seg_s / o.dtts)
        if nsteps and o.nmix and (nsteps % 2) != 0 and o.nmix % 2 == 0:
            warnings.append(
                "odd ocean steps per segment with even nmix: mixing "
                "timesteps drift across segments (O_even_fluxes rule)")

    # --- solver (tropic) ----------------------------------------------
    if o.mxscan < 1:
        errors.append("mxscan must be >= 1")
    if o.tolrsf <= 0:
        errors.append("tolrsf must be > 0")

    # --- restoring BCs (checks.F:240-265, O_restorst) ------------------
    if getattr(o, "restorst", False):
        if o.dampts[0] <= 0 or o.dampts[1] <= 0:
            errors.append("dampts must be > 0 when restoring surface "
                          "tracers (checks.F:241)")
        if o.dampdz[0] <= 0 or o.dampdz[1] <= 0:
            errors.append("dampdz must be > 0 when restoring surface "
                          "tracers (checks.F:254)")
        if o.dampts[0] != o.dampts[1]:
            warnings.append("dampts differs between T and S "
                            "(checks.F:247 warning)")

    # --- advection scheme exclusivity (checks.F:55-80) ----------------
    if o.tracer_advection not in ("centered", "upstream", "quicker",
                                  "fct"):
        errors.append(f"unknown tracer_advection "
                      f"'{o.tracer_advection}'")

    # --- bgc option dependencies (mobi_init, mobi.F:140-175) -----------
    if b.nitrogen and not b.o2:
        errors.append("O_mobi_o2 must be on when nitrogen is used "
                      "(mobi.F:141-146)")
    if b.nitrogen_15 and not b.nitrogen:
        errors.append("nitrogen must be on when nitrogen_15 is used "
                      "(mobi.F:152-157)")
    if b.iron and not b.o2:
        errors.append("O_mobi_o2 must be on when iron is used "
                      "(mobi.F:168-172)")
    if b.caco3 and not b.carbon:
        errors.append("carbon must be on when caco3 is used "
                      "(mobi.F:222-227)")
    if b.carbon_13 and not b.carbon:
        errors.append("carbon must be on when carbon_13 is used")
    if b.carbon_14 and not b.carbon:
        errors.append("carbon must be on when carbon_14 is used")
    if b.pa_th and not b.caco3:
        errors.append("O_mobi_caco3 must be on when Pa/Th is used "
                      "(protac_thor.F:39-42)")
    if b.silicon and b.suite != "mobi":
        errors.append("silicon tracers require the mobi suite")
    if b.suite not in ("none", "npzd", "mobi"):
        errors.append(f"unknown bgc suite '{b.suite}'")
    if b.suite != "none" and b.dtnpzd <= 0:
        errors.append("dtnpzd must be > 0 with a bgc suite")

    # --- mixing schemes (checks.F:68-140 vmixset/hmixset) -------------
    if o.vmix not in ("const", "bryan_lewis", "ppmix"):
        errors.append(f"unknown vmix scheme '{o.vmix}'")
    if o.hmix not in ("const", "smagnl", "biharmonic"):
        errors.append(f"unknown hmix scheme '{o.hmix}'")
    if o.isopycmix and o.hmix == "biharmonic":
        errors.append("biharmonic is incompatible with isopycmix — "
                      "use smagnl instead (checks.F:296-300)")
    if getattr(o, "full_tensor", False) and not o.isopycmix:
        errors.append("O_full_tensor requires O_isopycmix "
                      "(isopyc.F:110-114)")
    if o.tidal_kv and not o.isopycmix:
        errors.append("isopycmix must be enabled for tidal_kv to work "
                      "(checks.F:303-306)")
    if o.gent_mcwilliams and not o.isopycmix:
        errors.append("isopycmix must be enabled for gent_mcwilliams "
                      "to work (checks.F:308-312)")
    if o.isopycmix and o.hmix == "const" \
            and (o.ah + o.ahisop) > 1.0e11:
        errors.append("ahisop + ah too large for the isopycmix option "
                      "(checks.F:398-403)")
    if o.dm_taper and not o.isopycmix:
        errors.append("O_dm_taper requires O_isopycmix (isopyc.F)")
    if o.aniso_zonal and not o.isopycmix:
        warnings.append("aniso_zonal equatorial diffusivity addition "
                        "has no effect without isopycmix "
                        "(updates/08 isopyc.F:243-260)")
    if o.vmix == "ppmix" and o.aidif == 0.0:
        warnings.append("ppmix with fully explicit vertical diffusion "
                        "(aidif=0): predicted coefficients can exceed "
                        "the explicit stability limit — the reference "
                        "runs ppvmix with implicit mixing "
                        "(vmixc.F aidif)")
    if o.barotropic != "stream_function" and o.sf_npt == 5:
        warnings.append("sf_5_point is ignored under the surface-"
                        "pressure barotropic modes; 9-point numerics "
                        "are used (checks.F:160-168)")
    if o.convect_brine and not cfg.ice.enabled:
        errors.append("O_convect_brine requires the ice model "
                      "(convect_brine.F brine fluxes come from ice "
                      "growth)")
    if o.convect_brine and cfg.ice.cpts > 0:
        errors.append("O_convect_brine requires the 0-layer ice model "
                      "(cpts carries its own categories, cpts.F)")
    if o.neptune and not o.enabled:
        errors.append("O_neptune requires the ocean (neptune.F)")

    # --- scheme variants (checks.F:55-140 continued) -------------------
    if o.tracer_advection == "fct" and o.fct_variant not in ("dlm1",
                                                             "dlm2"):
        errors.append(f"unknown fct_variant '{o.fct_variant}' "
                      "(O_fct_dlm1 | O_fct_dlm2)")
    if o.fct_3d and o.tracer_advection != "fct":
        errors.append("O_fct_3d requires the FCT scheme")
    if o.sf_npt not in (5, 9):
        errors.append("sf_npt must be 5 or 9 (O_sf_5_point/O_sf_9_point)")
    if o.barotropic not in ("stream_function", "surface_pressure",
                            "implicit_free_surface"):
        errors.append(f"unknown barotropic mode '{o.barotropic}'")
    if o.hlat_filter not in ("fir", "fourier"):
        errors.append(f"unknown hlat_filter '{o.hlat_filter}' "
                      "(O_firfil | O_fourfil)")
    if not 0.0 <= o.aidif <= 1.0:
        errors.append("aidif must be in [0, 1] (checks.F aidif rule)")
    if o.convection not in ("ncon", "full"):
        errors.append(f"unknown convection scheme '{o.convection}'")
    if o.ncon < 1:
        errors.append("ncon must be >= 1 (convect.F pass count)")
    if o.dtxcel_deep < 1.0:
        errors.append("dtxcel_deep must be >= 1 (accel.h acceleration)")
    elif o.dtxcel_deep > 1.0:
        warnings.append(
            "tracer acceleration dtxcel_deep > 1 distorts transients "
            "(exact only at equilibrium, Bryan 1984) — spinup use only")

    # --- ice (chkcpl ice rules) ----------------------------------------
    ic = cfg.ice
    if ic.enabled:
        if ic.cpts not in (0, 3, 5, 10):
            errors.append("ice.cpts must be 0/3/5/10 (O_ice_cpts*)")
        if ic.evp and ic.ndte < 1:
            errors.append("EVP needs ndte >= 1 subcycles (evp.F:36)")
        if ic.niats < 1:
            errors.append("ice advection needs niats >= 1 (iceadv.F)")

    # --- atmosphere cadence (chkcpl, UVic_ESCM.F:530-600) --------------
    e = cfg.embm
    if e.enabled:
        if e.dtatm <= 0:
            errors.append("dtatm must be > 0")
        if e.namix < 1:
            errors.append("namix must be >= 1 (embm.F mixing cadence)")
        # (segtim/dtatm divisibility is the FATAL rule above: the
        # ntspas rounding drift would skew the coupler clock)
        if e.solver_maxiter < 1:
            errors.append("embm solver_maxiter must be >= 1")

    # --- ocean/barotropic timestep relations (chkcpl) ------------------
    if o.dtuv > 0 and o.dtsf > 0 and abs(o.dtsf - o.dtuv) > 1e-9 \
            and o.barotropic == "stream_function":
        warnings.append("dtsf != dtuv with the streamfunction mode: "
                        "the reference runs them equal (control.in)")
    if o.dtts > 0 and o.dtuv > 0:
        r = o.dtts / o.dtuv
        if abs(r - round(r)) > 1e-6:
            warnings.append("dtts is not a whole multiple of dtuv: "
                            "split stepping assumes an integer ratio")

    # --- grid geometry (size_check.F / grids.F) ------------------------
    if g.cyclic:
        span_x = g.x_bounds[-1] - g.x_bounds[0]
        if abs(span_x - 360.0) > 1e-6:
            errors.append(f"cyclic grid must span 360 degrees of "
                          f"longitude, got {span_x} (grids.F O_cyclic)")
    if g.y_bounds[0] >= g.y_bounds[-1]:
        errors.append("y_bounds must increase south to north (grids.F)")
    if g.z_bounds[0] != 0.0:
        errors.append("z_bounds must start at the surface (grids.F)")
    if g.z_bounds[-1] <= g.z_bounds[0]:
        errors.append("z_bounds must increase downward (grids.F)")

    # --- timestep acceleration (accel.h / Bryan 1984) ------------------
    if o.dtxcel_deep > 1.0 and cfg.embm.seasonal:
        warnings.append(
            "deep tracer acceleration (dtxcel_deep > 1) with seasonal "
            "forcing: asynchronous stepping distorts the seasonal "
            "response of the deep ocean and can push ice-albedo "
            "feedbacks past their synchronous equilibria — use only "
            "for coarse spinup, finish unaccelerated (Bryan 1984; "
            "accel.h)")
    if o.dtxcel_deep > 8.0:
        warnings.append("dtxcel_deep > 8: deep advective CFL under "
                        "acceleration has destabilized spun-up states "
                        "(accel.h guidance)")

    # --- ice model (ice.F / evp.F / cpts.F) ----------------------------
    ic = cfg.ice
    if ic.enabled:
        if ic.evp and ic.ndte < 10:
            warnings.append("EVP with ndte < 10 subcycles: elastic "
                            "waves are under-damped (evp.F:36 default "
                            "ndte=30)")
        if ic.cpts > 0 and ic.nlay < 1:
            errors.append("cpts ice needs nlay >= 1 enthalpy layers "
                          "(cpts.F)")
        if ic.ice_ocn_stress not in ("draglaw", "freedrift"):
            errors.append(
                f"unknown ice_ocn_stress '{ic.ice_ocn_stress}' "
                "(draglaw | freedrift) — a typo would silently fall "
                "back to the capped free-drift coupling")
    elif cfg.embm.enabled:
        warnings.append("EMBM without the ice model: polar oceans "
                        "cannot form ice; SST clamps at freezing "
                        "(embm.F expects O_ice)")

    # --- land model (mtlm.F / UVic_ESCM.F:640-660 cadence) -------------
    if cfg.land.enabled:
        if not cfg.embm.enabled:
            errors.append("MTLM requires the EMBM (mtlm.F surface "
                          "exchange runs through the atm solve)")
        if cfg.time.segtim_days > 0:
            r5 = 360.0 / cfg.time.segtim_days
            if abs(r5 - round(r5)) > 1e-6:
                warnings.append(
                    "TRIFFID couples per segment with gamma = 360d / "
                    "segtim; a segment that does not divide the 360-"
                    "day year biases the annual vegetation increment "
                    "(UVic_ESCM.F:640-660 land cadence rule)")

    # --- bgc <-> physics relations (npzd_src.F / gasbc.F) --------------
    if b.suite != "none":
        if b.dtnpzd > 0 and o.dtts > 0:
            rb = (2.0 * o.dtts) / b.dtnpzd
            if abs(rb - round(rb)) > 1e-6:
                warnings.append(
                    "dtnpzd does not divide the leapfrog tracer "
                    "interval 2*dtts evenly; the source substep count "
                    "is rounded (npzd_src.F nbio)")
        if b.carbon and not b.alk:
            warnings.append("carbon without alkalinity: surface pCO2 "
                            "uses a fixed alk proxy — carbonate "
                            "chemistry fidelity is reduced "
                            "(co2calc.F expects alk)")


    if b.cfc and b.suite == "none":
        errors.append("cfc tracers need an active bgc tracer registry")

    # --- sediments (sed.F) ---------------------------------------------
    if cfg.sed.enabled:
        if b.suite == "none" or not b.carbon:
            errors.append("sediments require the carbon system "
                          "(sed.F couples through dic/alk rain)")
        if cfg.sed.dtsed <= 0:
            errors.append("dtsed must be > 0 (sed.F)")

    # --- precision / platform ------------------------------------------
    if cfg.dtype == "float64":
        warnings.append("float64 on TPU is emulated and an order of "
                        "magnitude slower; the validated production "
                        "policy is float32 (golden/precision study)")

    # --- output cadences round to whole segments (switch.F alarms) -----
    for name, iv in (("tsiint", cfg.time.tsiint),
                     ("timavgint", cfg.time.timavgint),
                     ("restint", cfg.time.restint)):
        if iv > 0 and cfg.time.segtim_days > 0:
            r = iv / cfg.time.segtim_days
            if abs(r - round(r)) > 1e-6:
                warnings.append(
                    f"{name} ({iv} d) is not a whole number of "
                    f"segments; the alarm fires on the next segment "
                    f"boundary (switch.F avg_alarm rounding)")
            if iv < cfg.time.segtim_days:
                warnings.append(
                    f"{name} ({iv} d) is shorter than one segment "
                    f"({cfg.time.segtim_days} d): the alarm fires "
                    "every segment (UVic_ESCM.F:530-585 interval "
                    "rules)")
    if cfg.time.timavgint == 0.0:
        warnings.append("timavgint = 0 implies no time-mean averaging "
                        "(UVic_ESCM.F:541-544)")
    if cfg.time.runlen_days > 0 and cfg.time.segtim_days > 0:
        rr = cfg.time.runlen_days / cfg.time.segtim_days
        if abs(rr - round(rr)) > 1e-6:
            warnings.append(
                "runlen_days is not a whole number of segments; the "
                "run rounds to the next segment boundary "
                "(UVic_ESCM.F:655-663 r4 rule)")

    # --- parallel: mesh divisibility + the halo law (size.h:80-100) ----
    p = cfg.parallel
    if p.mesh_shape != (1, 1):
        ny, nx = p.mesh_shape
        if ny < 1 or nx < 1:
            errors.append("mesh_shape entries must be >= 1")
        else:
            from .parallel.shard_step import ShardedOceanStep
            need = ShardedOceanStep.required_halo(o)
            ly = -(-g.jmt // ny)
            lx = -(-g.imt // nx)
            if ny > 1 and need > ly:
                errors.append(
                    f"mesh y={ny}: local rows {ly} < required halo "
                    f"{need} for this scheme combination (size.h jmw "
                    f"law) — coarsen the mesh or simplify the schemes")
            if nx > 1 and need + 2 + (lx * nx - g.imt) > lx:
                errors.append(
                    f"mesh x={nx}: local columns {lx} cannot hold halo "
                    f"{need} + ghost columns (size.h jmw law)")

    # --- precision ------------------------------------------------------
    if cfg.dtype not in ("float32", "float64"):
        errors.append(f"dtype must be float32/float64, got {cfg.dtype}")

    if errors:
        raise ConfigError("configuration errors:\n  - "
                          + "\n  - ".join(errors))
    return warnings
