"""The earth geography and the coupled components of the port against
``uvic_tpu`` on the CPU, in float64.

- ``core/earth.py``: every field equals the reference's bitwise on the
  standard grid (host NumPy both sides), and the earth topography (kmt,
  six islands, perimeters) is the reference's;
- ``bicgstab_safe`` against the reference's at 1e-12 on a seeded
  upstream/diffusion system, and its two loop forms (a host read of the
  flag every n trips; ``maxiter`` trips with the freeze) bitwise equal;
- insolation, river routing, one EMBM step (mixing and leapfrog), ice
  thermodynamics, ice advection, EVP dynamics, the land physics step and
  TRIFFID, each against the reference at 1e-9 of each field's largest
  value, on inputs from ``earth_accept/restart.npz`` (year 1060);
- ``convection_extent`` equal to the reference's.

The EMBM solves here run to convergence (``solver_tol`` 1e-13, 1000
trips, in both packages): with the earth configuration's own float64
settings (1e-10, 200 trips) the temperature solve stops at its trip cap
unconverged, where its iterate is sensitive to round-off, which the last
test shows.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvic_tpu.core.earth as j_earth
from uvic_tpu.config import earth_config as j_earth_config
from uvic_tpu.core.grid import make_grid as j_make_grid
from uvic_tpu.models.embm.insolation import \
    annual_mean_insolation as j_annual
from uvic_tpu.models.embm.insolation import daily_insolation as j_daily
from uvic_tpu.models.embm.model import AtmState as JAtmState
from uvic_tpu.models.embm.model import EmbmModel as JEmbm
from uvic_tpu.models.embm.rivers import RiverModel as JRivers
from uvic_tpu.models.ice.evp import evp_dynamics as j_evp
from uvic_tpu.models.ice.thermo import IceState as JIceState
from uvic_tpu.models.ice.thermo import ice_advection as j_advect
from uvic_tpu.models.ice.thermo import ice_thermodynamics as j_thermo
from uvic_tpu.models.land import mtlm as j_mtlm
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean
from uvic_tpu.ops.convection import convection_extent as j_extent
from uvic_tpu.ops.solvers import bicgstab_safe as j_bicgstab

import uvic_tpu_torch.core.earth as t_earth
from uvic_tpu_torch.config import earth_config as t_earth_config
from uvic_tpu_torch.core.grid import make_grid as t_make_grid
from uvic_tpu_torch.models.embm.insolation import \
    annual_mean_insolation as t_annual
from uvic_tpu_torch.models.embm.insolation import \
    daily_insolation as t_daily
from uvic_tpu_torch.models.embm.model import AtmState as TAtmState
from uvic_tpu_torch.models.embm.model import EmbmModel as TEmbm
from uvic_tpu_torch.models.embm.rivers import RiverModel as TRivers
from uvic_tpu_torch.models.ice.evp import evp_dynamics as t_evp
from uvic_tpu_torch.models.ice.thermo import IceState as TIceState
from uvic_tpu_torch.models.ice.thermo import ice_advection as t_advect
from uvic_tpu_torch.models.ice.thermo import \
    ice_thermodynamics as t_thermo
from uvic_tpu_torch.models.land import mtlm as t_mtlm
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean
from uvic_tpu_torch.ops.convection import convection_extent as t_extent
from uvic_tpu_torch.ops.solvers import bicgstab_safe as t_bicgstab

RESTART = Path(__file__).resolve().parents[1] / "earth_accept" / \
    "restart.npz"
TOL = 1e-9
CONVERGED = dict(solver_tol=1e-13, solver_maxiter=1000)
EARTH_FIELDS = ("land_mask", "earth_depth", "earth_kmt", "atlantic_mask",
                "earth_wind_stress", "earth_surface_wind",
                "earth_atm_coalbedo", "earth_atm_diff", "earth_elevation")


def _cfgs(**embm):
    j, t = j_earth_config(dtype="float64"), t_earth_config(dtype="float64")
    return (j.replace(embm=dataclasses.replace(j.embm, **embm)),
            t.replace(embm=dataclasses.replace(t.embm, **embm)))


def _close(got, ref, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


def _tn(x):
    return torch.as_tensor(np.array(x, np.float64))


@pytest.fixture(scope="module")
def grids():
    jc, tc = _cfgs()
    return j_make_grid(jc.grid), t_make_grid(tc.grid)


@pytest.mark.parametrize("name", EARTH_FIELDS)
def test_earth_fields_bitwise(name, grids):
    jg, tg = grids
    got, ref = getattr(t_earth, name)(tg), getattr(j_earth, name)(jg)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_earth_initial_ts_bitwise(grids):
    jg, tg = grids
    kmt = j_earth.earth_kmt(jg)
    for a, b in zip(t_earth.earth_initial_ts(tg, kmt),
                    j_earth.earth_initial_ts(jg, kmt)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def models():
    """The two packages' earth oceans (the reference's, in float64)."""
    jc, tc = _cfgs()
    return (j_make_ocean(jc, topo_kind="earth"),
            t_make_ocean(tc, topo_kind="earth", device="cpu"))


def test_earth_topography_matches_reference(models):
    jm, tm = models
    jt, tt = jm.params.topo, tm.params.topo
    assert tt.nisle == jt.nisle == 6
    for name in ("kmt", "kmu", "perim_id", "perim_count", "land_map"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    assert tt.imain == jt.imain


# ----------------------------------------------------------------------
# bicgstab_safe


def _upstream_system(seed=0, n=(24, 30)):
    """Off-diagonals of a seeded, row-equilibrated 5-point
    upstream/diffusion operator (the EMBM's structure), a right-hand
    side and a first guess."""
    rng = np.random.default_rng(seed)
    c = [-0.3 * rng.random(n) for _ in range(4)]
    adv = 0.2 * rng.standard_normal(n)
    c[0] = c[0] - np.maximum(adv, 0.0)
    c[1] = c[1] + np.minimum(adv, 0.0)
    return c, rng.standard_normal(n), 0.1 * rng.standard_normal(n)


def test_bicgstab_matches_reference():
    c, b, x0 = _upstream_system()
    jc = [jnp.asarray(a) for a in c]
    tc = [_tn(a) for a in c]

    def j_mv(x):
        return (x + jc[0] * jnp.roll(x, 1, 0) + jc[1] * jnp.roll(x, -1, 0)
                + jc[2] * jnp.roll(x, 1, 1) + jc[3] * jnp.roll(x, -1, 1))

    def t_mv(x):
        return (x + tc[0] * torch.roll(x, 1, 0)
                + tc[1] * torch.roll(x, -1, 0)
                + tc[2] * torch.roll(x, 1, 1) + tc[3] * torch.roll(x, -1, 1))

    ref = j_bicgstab(j_mv, jnp.asarray(b), jnp.asarray(x0), lambda r: r,
                     1e-12, 500)
    got, trips = t_bicgstab(t_mv, _tn(b), _tn(x0), lambda r: r, 1e-12, 500,
                            check_every=1)
    assert 0 < int(trips) < 500
    _close(got, ref, "bicgstab x", tol=1e-12)


def test_bicgstab_loop_forms_bitwise():
    """The host-read form stops early, the capturable form runs every
    trip with the freeze: the same iterate, bitwise, and the same trip
    count; a capped solve stops at its cap in both."""
    c, b, x0 = _upstream_system(seed=1)
    tc = [_tn(a) for a in c]

    def t_mv(x):
        return (x + tc[0] * torch.roll(x, 1, 0)
                + tc[1] * torch.roll(x, -1, 0)
                + tc[2] * torch.roll(x, 1, 1) + tc[3] * torch.roll(x, -1, 1))

    for tol, maxiter in ((1e-8, 300), (1e-15, 20)):
        outs = [t_bicgstab(t_mv, _tn(b), _tn(x0), lambda r: r, tol, maxiter,
                           check_every=every) for every in (1, 7, None)]
        for x, k in outs[1:]:
            assert torch.equal(x, outs[0][0])
            assert int(k) == int(outs[0][1])
    assert int(outs[0][1]) == 20


# ----------------------------------------------------------------------
# EMBM


@pytest.fixture(scope="module")
def restart():
    with np.load(RESTART) as d:
        return {k: d[k].astype(np.float64) if d[k].dtype.kind == "f"
                else d[k] for k in d.files}


def test_insolation_matches_reference(grids):
    jg, _ = grids
    lat = np.deg2rad(np.broadcast_to(jg.yt[:, None], (jg.jmt, jg.imt)))
    for day in (0.3, 97.5, 181.25, 359.9):
        _close(t_daily(_tn(lat), _tn(day), 360.0),
               j_daily(jnp.asarray(lat), jnp.asarray(day), 360.0),
               f"daily insolation day {day}", tol=1e-12)
    _close(t_annual(_tn(lat)), j_annual(jnp.asarray(lat)),
           "annual-mean insolation", tol=1e-12)


def test_river_discharge_matches_reference(models):
    jm, _ = models
    g, kmt = jm.params.grid, np.asarray(jm.params.topo.kmt)
    area = g.cst[:, None] * g.dyt[:, None] * g.dxt[None, :]
    runoff = np.random.default_rng(2).random(kmt.shape) * 1e-5 * (kmt == 0)
    jr, tr = JRivers(kmt, area), TRivers(kmt, area)
    np.testing.assert_array_equal(tr.target.numpy(), np.asarray(jr.target))
    _close(tr.discharge(_tn(runoff)), jr.discharge(jnp.asarray(runoff)),
           "discharge", tol=1e-12)


def _embms(models, **embm):
    jm, tm = models
    from uvic_tpu.core.earth import (earth_atm_coalbedo, earth_atm_diff,
                                     earth_elevation, earth_surface_wind)
    g = jm.params.grid
    diff_t, diff_q = earth_atm_diff(g)
    winds, wspd = earth_surface_wind(g)
    kw = dict(elev=earth_elevation(g), winds=winds, wspd=wspd,
              diff_t=diff_t, diff_q=diff_q,
              atm_coalbedo=earth_atm_coalbedo(g), dry_soil_albedo=0.15)
    jc, tc = _cfgs(**(embm or CONVERGED))
    je = JEmbm(g, jm.params.topo, jc.embm, dtype=np.float64, **kw)
    te = TEmbm(tm.params.grid, tm.params.topo, tc.embm, dtype=torch.float64,
               check_every=1, **kw)
    return je, te


@pytest.mark.parametrize("mixing", [True, False])
def test_embm_step_matches_reference(mixing, models, restart):
    je, te = _embms(models)
    r = restart
    nats = 10 if mixing else 3
    sst = r["ocean/t"][0, 0]
    ja = JAtmState(at=jnp.asarray(r["atm/at"]), atm1=jnp.asarray(r["atm/atm1"]),
                   soilm=jnp.asarray(r["atm/soilm"]),
                   soilm1=jnp.asarray(r["atm/soilm1"]),
                   surf=jnp.asarray(r["atm/surf"]), nats=jnp.asarray(nats))
    ta = TAtmState(at=_tn(r["atm/at"]), atm1=_tn(r["atm/atm1"]),
                   soilm=_tn(r["atm/soilm"]), soilm1=_tn(r["atm/soilm1"]),
                   surf=_tn(r["atm/surf"]), nats=nats)
    jn, jd = je._step_impl(ja, jnp.asarray(sst), mixing=mixing)
    tn, td = te.step(ta, _tn(sst))
    assert tn.nats == int(jn.nats)
    for name in ("at", "atm1", "soilm", "soilm1", "surf"):
        _close(getattr(tn, name), getattr(jn, name), f"atm {name}")
    for name in ("precip", "psno", "evap", "rh", "dnswr", "outlwr", "uplwr",
                 "upsens", "upltnt", "runoff", "flux_shum"):
        _close(td[name], getattr(jd, name), f"flux {name}")
    assert all(0 < int(k) < 1000 for k in te.last_trips)


# ----------------------------------------------------------------------
# sea ice


def _ice_states(r):
    names = ("hice", "aice", "hsno", "tice", "uice", "sig")
    return (JIceState(**{n: jnp.asarray(r["ice/" + n]) for n in names}),
            TIceState(**{n: _tn(r["ice/" + n]) for n in names}))


def test_ice_thermodynamics_matches_reference(models, restart):
    jm, tm = models
    je, te = _embms(models)
    r = restart
    ji, ti = _ice_states(r)
    sst = r["ocean/t"][0, 0]
    sss = r["ocean/t"][1, 0] * 1000.0 + 35.0
    from uvic_tpu.models.ice.thermo import freezing_point
    frz = np.asarray(freezing_point(jnp.asarray(sss)))
    ja = JAtmState(at=jnp.asarray(r["atm/at"]), atm1=jnp.asarray(r["atm/atm1"]),
                   soilm=jnp.asarray(r["atm/soilm"]),
                   soilm1=jnp.asarray(r["atm/soilm1"]),
                   surf=jnp.asarray(r["atm/surf"]), nats=jnp.asarray(3))
    fl = {k: np.asarray(v) for k, v in
          je.fluxes(ja, jnp.asarray(sst), dts=108000.0).items()}
    lat = np.deg2rad(np.broadcast_to(jm.params.grid.yt[:, None],
                                     sst.shape))
    solins = np.asarray(j_daily(jnp.asarray(lat), jnp.asarray(200.0), 360.0))
    args = [r["atm/at"][0], r["atm/at"][1], fl["rh"], sst, frz, solins,
            np.asarray(je.aca), np.asarray(je.wspd), np.asarray(je.elev),
            np.asarray(je.tmsk), fl["dnswr"], fl["uplwr"], fl["upsens"],
            fl["upltnt"], fl["evap"]]
    zw1 = float(jm.params.grid.zw[0])
    jn, jf, jo = j_thermo(ji, *[jnp.asarray(a) for a in args], 108000.0,
                          zw1)
    tn, tf, to = t_thermo(ti, *[_tn(a) for a in args], 108000.0, zw1)
    for name in ("hice", "aice", "hsno", "tice"):
        _close(getattr(tn, name), getattr(jn, name), f"ice {name}")
    for name in jf:
        _close(tf[name], jf[name], f"flux {name}")
    for name in ("heat", "freshwater"):
        _close(to[name], jo[name], f"ocean adjustment {name}")


def test_ice_dynamics_and_advection_match_reference(models, restart):
    jm, tm = models
    r = restart
    g = jm.params.grid
    kmt, kmu = np.asarray(jm.params.topo.kmt), np.asarray(jm.params.topo.kmu)
    tmsk, umsk = (kmt > 0).astype(float), (kmu > 0).astype(float)
    f = 2.0 * 7.292e-5 * np.sin(np.deg2rad(g.yu))[:, None] \
        * np.ones((1, g.imt))
    stress = j_earth.earth_wind_stress(g)
    rng = np.random.default_rng(4)
    uocn, vocn = (2.0 * rng.standard_normal((2, g.jmt, g.imt))) * umsk
    args = [r["ice/uice"][0], r["ice/uice"][1], r["ice/hice"],
            r["ice/aice"], tmsk, umsk, f, stress[0], stress[1], uocn, vocn]
    ju, jv, jsig, jx, jy = j_evp(*[jnp.asarray(a) for a in args], jm.g,
                                 54000.0, 30, True,
                                 sig_in=jnp.asarray(r["ice/sig"]))
    tu, tv, tsig, tx, ty = t_evp(*[_tn(a) for a in args], tm.g, 54000.0, 30,
                                 True, sig_in=_tn(r["ice/sig"]))
    for name, a, b in (("uice", tu, ju), ("vice", tv, jv), ("sig", tsig, jsig),
                       ("xint", tx, jx), ("yint", ty, jy)):
        _close(a, b, f"evp {name}")
    for name in ("hice", "aice", "hsno"):
        _close(t_advect(_tn(r["ice/" + name]), tu, tv, tm.g, 108000.0),
               j_advect(jnp.asarray(r["ice/" + name]), ju, jv, jm.g,
                        108000.0), f"advected {name}")


# ----------------------------------------------------------------------
# land


def test_land_step_and_triffid_match_reference(models, restart):
    jm, _ = models
    r = restart
    kmt = np.asarray(jm.params.topo.kmt)
    lmask = (kmt == 0).astype(float)
    names = ("frac", "ht", "lai", "cs", "tsoil", "npp_acc", "gleaf_acc",
             "resp_w_acc", "resp_s_acc", "nacc", "gc", "m_soil", "mneg",
             "lying_snow")
    jl = j_mtlm.LandState(**{n: jnp.asarray(r["land/" + n]) for n in names})
    tl = t_mtlm.LandState(**{
        n: (torch.as_tensor(r["land/" + n]) if n == "nacc"
            else _tn(r["land/" + n])) for n in names})
    rng = np.random.default_rng(5)
    sat, shum = r["atm/at"]
    swr = 2.0e5 * (1.0 + 0.3 * rng.random(sat.shape))
    rh = np.clip(0.5 + 0.3 * rng.standard_normal(sat.shape), 0.0, 1.0)
    forcing = dict(precip=3e-5 * rng.random(sat.shape),
                   psno=1e-5 * rng.random(sat.shape),
                   wspd=5.0 + rng.random(sat.shape))
    args = [lmask, sat, shum, swr, rh, r["atm/soilm"] / 15.0]
    jn, jf = j_mtlm.mtlm_physics_step(
        jl, *[jnp.asarray(a) for a in args], co2_ppm=280.0,
        dt=432000.0, **{k: jnp.asarray(v) for k, v in forcing.items()})
    tn, tf = t_mtlm.mtlm_physics_step(
        tl, *[_tn(a) for a in args], co2_ppm=280.0, dt=432000.0,
        **{k: _tn(v) for k, v in forcing.items()})
    for n in names:
        if n != "nacc":
            _close(getattr(tn, n), getattr(jn, n), f"land {n}")
    assert int(tn.nacc) == int(jn.nacc) == 1
    for k in jf:
        _close(tf[k], jf[k], f"land flux {k}")
    jt, jd = j_mtlm.triffid_update(jn, jnp.asarray(lmask), 72.0)
    tt, td = t_mtlm.triffid_update(tn, _tn(lmask), 72.0)
    for n in names:
        if n != "nacc":
            _close(getattr(tt, n), getattr(jt, n), f"triffid {n}")
    for k in jd:
        _close(td[k], jd[k], f"triffid {k}")


# ----------------------------------------------------------------------
# convection extent


def test_convection_extent_matches_reference(models, restart):
    """On the restart's tracers with seeded noise (no two levels of a
    column exactly equal): equal depths and region counts.  On the
    restart's own tracers, whose mixed regions hold exactly equal T and
    S, the reference's jitted loop compares exactly equal densities
    with the round-off of its fused code; taken op by op (jit disabled)
    it agrees with the port exactly."""
    jm, tm = models
    t = restart["ocean/t"]
    noise = 1e-3 * np.random.default_rng(6).standard_normal(t.shape)
    for ts, eager in ((t + noise * (t != 0), False), (t, True)):
        jargs = (jm.kmt, jm.eos_c, jm.eos_to, jm.eos_so, jm.dztxcl,
                 jnp.asarray(jm.g.dzt))
        if eager:
            with jax.disable_jit():
                jd, jn = j_extent(jnp.asarray(ts), *jargs)
        else:
            jd, jn = j_extent(jnp.asarray(ts), *jargs)
        td, tn = t_extent(_tn(ts), tm.kmt, tm.eos_c, tm.eos_to, tm.eos_so,
                          tm.dztxcl, tm.g.dzt)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


# ----------------------------------------------------------------------
# why the comparisons above run the EMBM solves to convergence


def test_default_float64_temperature_solve_stops_unconverged(models,
                                                             restart):
    """The earth configuration's float64 solver (1e-10, 200 trips) stops
    the temperature solve at its cap, and a 1e-16 relative perturbation
    of the right-hand side then moves the iterate by more than 1e-8 of
    its largest value: two correct implementations that round
    differently do not agree to 1e-9 there."""
    _, tc = _cfgs()
    _, te = _embms(models, solver_tol=tc.embm.solver_tol)
    assert te.solver_tol == 1e-10
    dts = 2.0 * tc.embm.dtatm
    cc, cn, cs, ce, cw = te._coef(te.diff_t, dts)
    d = 1.0 / cc
    sc = (None, cn * d, cs * d, ce * d, cw * d)
    rhs = te._zero_cols(te._bc(_tn(restart["atm/atm1"][0])) * d)
    x0 = te._zero_cols(_tn(restart["atm/at"][0]))
    rng = np.random.default_rng(7)
    rhs2 = rhs * (1.0 + 1e-16 * _tn(rng.standard_normal(rhs.shape)))

    def solve(b):
        return t_bicgstab(lambda v: te._transport_matvec(v, sc), b, x0,
                          lambda r: r, tc.embm.solver_tol,
                          tc.embm.solver_maxiter, check_every=1)

    (x1, k1), (x2, k2) = solve(rhs), solve(rhs2)
    assert int(k1) == int(k2) == tc.embm.solver_maxiter == 200
    moved = float((x1 - x2).abs().max() / x1.abs().max())
    assert moved > 1e-8
