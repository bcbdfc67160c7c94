"""Every ocean option on the rank-decomposed step, and what the
reference's sharded core does with them.

``ShardedOceanStep`` takes every option of the port's ``OceanModel`` and
computes it as the unsharded ``step`` computes it.  The reference's
explicit sharded core refuses five of them by assertion (the
surface-pressure modes, ppmix, walls, Smagorinsky mixing, QUICKER) and
takes two without a word but computes them otherwise than its
unsharded step: Euler-backward mixing (its mixing step is a forward
step either way) and the 9-point operator (whose checkerboard deflation
leaves psi's ghost columns other than the columns they stand for,
which its window's periodic images cannot reproduce; shown below on
the reference itself).  Each option runs on a (2, 2) mesh of gloo CPU
ranks, a mixing and two leapfrog steps, within 1e-12 of the port's
unsharded step (generic tracer path), the replicated fields (the
barotropic fields and the surface-pressure modes' ubar) bitwise equal
on every rank; walls also on (1, 4) and (2, 4), where a rank has a
wall on one side only, at 34x44 (the halo of 11 needs 11 columns a
rank).

The polar bottom drag is the reference's own gap: its sharded core
takes the scalar ``cdbot`` (``uvic_tpu/parallel/shard_step.py:197-201``)
where its ``_step`` takes ``cdbot2d``, enhanced north of
``cdbot_polar_lat`` (83 deg; ``earth_config`` sets the scale to 20).  On
the small grid, which has ocean at 84.4 deg, the JAX package's sharded
and unsharded steps part beyond its own test's tolerance; the port's
sharded step, which carries ``cdbot2d`` as a static, matches both the
port's and the JAX package's unsharded step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvic_tpu.core.state import OceanState as JOceanState
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean
from uvic_tpu.parallel.mesh import make_mesh as j_make_mesh
from uvic_tpu.parallel.mesh import shard_pytree as j_shard_pytree
from uvic_tpu.parallel.shard_step import ShardedOceanStep as JStep

from uvic_tpu_torch.config import BgcConfig, small_config
from uvic_tpu_torch.models.ocean.model import make_ocean
from uvic_tpu_torch.parallel.mesh import RankMesh
from uvic_tpu_torch.parallel.shard_step import ShardedOceanStep

from torch_shard_runs import (BASE, TOL_JAX, assert_jax_tolerances,
                              assert_port_equal, assert_replicated, configs,
                              j_forcing, j_state_dict, jax_steps, job,
                              port_setup, port_steps, setup, sharded_meshes,
                              wind)
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

SHAPE = (2, 2)
SCHEDULE = (False, True, True)
# the options the reference's sharded core refuses, or takes but computes
# otherwise than its unsharded step: option -> (ocean options, grid
# options, what the reference's assertion names)
REFERENCE_CORE = {
    "surface_pressure": (dict(barotropic="surface_pressure"), {},
                         "barotropic=surface_pressure"),
    "free_surface": (dict(barotropic="implicit_free_surface"), {},
                     "barotropic=implicit_free_surface"),
    "ppmix": (dict(vmix="ppmix"), {}, "vmix=ppmix"),
    "walls": ({}, dict(cyclic=False), "cyclic=False"),
    "smagnl": (dict(hmix="smagnl"), {}, "hmix=smagnl"),
    "quicker": (dict(tracer_advection="quicker"), {},
                "tracer_advection=quicker"),
    "eb": (dict(eb=True), {}, "eb"),
    "sf_npt_9": (dict(sf_npt=9), {}, "sf_npt=9"),
}
# what the reference's sharded step takes but computes otherwise than
# its unsharded step
REFERENCE_GAPS = ("eb", "sf_npt_9")
# options of OceanModel.step that the sharded core computes as it does:
# option -> (ocean options, grid options)
COMPUTED = {
    "neptune": (dict(neptune=True), {}),
    "full_tensor": (dict(isopycmix=True, gent_mcwilliams=True,
                         full_tensor=True), {}),
    "biharmonic": (dict(hmix="biharmonic"), {}),
    "acor": (dict(acor=0.5), {}),
    "ncon_bryan_lewis_shortwave": (dict(convection="ncon", ncon=2,
                                        vmix="bryan_lewis", shortwave=True),
                                   {}),
    "brine": (dict(convect_brine=True), {}),
    "npzd": (dict(), {}),
    "plain": (dict(), {}),
    # taken before without a test
    "fourier": (dict(hlat_filter="fourier"), {}),
    "dlm2_fct_3d": (dict(fct_variant="dlm2", fct_3d=True), {}),
    "dm_taper": (dict(dm_taper=True), {}),
    "dtxcel_deep": (dict(dtxcel_deep=4.0), {}),
    "gthflx": (dict(gthflx=True), {}),
    **{name: (ocean, grid)
       for name, (ocean, grid, _) in REFERENCE_CORE.items()},
}
# walls where a rank has a wall on one side only: mesh -> imt
WALL_MESHES = {(1, 4): 44, (2, 4): 44}
POLAR = dict(cdbot_polar_scale=20.0)
# three leapfrog steps show the reference's polar-drag gap (one JAX
# compile each way fewer than with a mixing step first)
POLAR_SCHEDULE = (True, True, True)


def _port_config(ocean, grid=None, bgc=None):
    grid = dict(grid or {})
    cfg = small_config(imt=grid.pop("imt", 40), jmt=34, km=8)
    cfg = cfg.replace(ocean=dataclasses.replace(cfg.ocean,
                                                **{**BASE, **ocean}))
    if grid:
        cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, **grid))
    if bgc:
        cfg = cfg.replace(bgc=bgc)
    return cfg


@pytest.mark.parametrize("name", sorted(REFERENCE_CORE))
def test_refused_options_are_named(name):
    """The reference's sharded core still refuses six of the options by
    name (and takes the other two); the port's step takes all eight."""
    ocean, grid, named = REFERENCE_CORE[name]
    m = make_ocean(_port_config(ocean, grid), device="cpu")
    ss = ShardedOceanStep(m, RankMesh((1, 1), device="cpu"))
    assert ss.w == ShardedOceanStep.halo_width(m.cfg.ocean, m.cyclic)
    if name in REFERENCE_GAPS:
        return
    jc, _ = configs(ocean)
    if grid:
        jc = jc.replace(grid=dataclasses.replace(jc.grid, **grid))
    with pytest.raises(AssertionError, match="shard_map path"):
        JStep(j_make_ocean(jc), j_make_mesh(SHAPE))


def _brine_forcing(grid, tmask0, nt):
    rng = np.random.default_rng(7)
    f = wind(grid, nt)
    shape = (2, grid.jmt, grid.imt)
    f["cba"] = 0.3 * rng.random(shape) * tmask0
    f["cbf"] = 2e-6 * rng.random(shape) * tmask0
    return f


def _case(name, ocean, grid):
    """(port config, primed state, forcing) of a computed option."""
    bgc = BgcConfig(suite="npzd") if name == "npzd" else None
    tc = _port_config(ocean, grid, bgc=bgc)
    m = make_ocean(tc, device="cpu")
    g = m.params.grid
    forcing = (_brine_forcing(g, np.asarray(m.params.topo.tmask)[0], m.nt)
               if name == "brine" else wind(g, m.nt))
    return tc, port_setup(tc, forcing), forcing


@pytest.fixture(scope="module")
def runs():
    """Every computed option: the port's unsharded and sharded runs; the
    polar-drag case in both packages, sharded and not.  One spawn of
    eight ranks for every mesh."""
    out, jobs = {}, []
    for name, (ocean, grid) in COMPUTED.items():
        tc, primed, forcing = _case(name, ocean, grid)
        out[name] = dict(port=port_steps(tc, primed, forcing, SCHEDULE))
        jobs.append(job(tc, primed, forcing, SCHEDULE))

    # the polar drag in both packages, sharded and not
    jc, tc = configs(POLAR)
    jm, primed, forcing = setup(jc, tc)
    polar = dict(jax=jax_steps(jm, primed, forcing, POLAR_SCHEDULE),
                 port=port_steps(tc, primed, forcing, POLAR_SCHEDULE))
    mesh = j_make_mesh(SHAPE)
    ss = JStep(jm, mesh)
    s = j_shard_pytree(JOceanState(**{k: jnp.asarray(v)
                                      for k, v in primed.items()}), mesh)
    f = j_shard_pytree(j_forcing(forcing), mesh)
    for lf in POLAR_SCHEDULE:
        s = ss.step(s, f, leapfrog=lf)
    polar["jax_sharded"] = j_state_dict(jax.device_get(s))
    out["polar_drag"] = polar
    jobs.append(job(tc, primed, forcing, POLAR_SCHEDULE))

    # walls on meshes where a rank has a wall on one side only
    by_shape = {SHAPE: jobs}
    for shape, imt in WALL_MESHES.items():
        tc, primed, forcing = _case("walls", {}, dict(cyclic=False,
                                                      imt=imt))
        by_shape[shape] = [job(tc, primed, forcing, SCHEDULE)]
        out[_walls_name(shape)] = dict(
            port=port_steps(tc, primed, forcing, SCHEDULE))
    results = sharded_meshes(by_shape)
    for name, res in zip(list(COMPUTED) + ["polar_drag"], results[SHAPE]):
        out[name]["sharded"] = res
    for shape in WALL_MESHES:
        out[_walls_name(shape)]["sharded"], = results[shape]
    return out


def _walls_name(shape):
    return "walls_%dx%d" % shape


@pytest.mark.parametrize("name", sorted(COMPUTED) + sorted(
    _walls_name(shape) for shape in WALL_MESHES))
def test_computed_options_match_the_unsharded_step(runs, name):
    r = runs[name]
    assert_port_equal(r["sharded"]["state"], r["port"])
    assert_replicated(r["sharded"])


def test_brine_and_npzd_runs_reach_their_paths(runs):
    """The brine run convects under ice (its fields leave the plain
    run's), and the npzd run steps its bgc tracers."""
    brine, plain = runs["brine"]["port"], runs["plain"]["port"]
    assert not np.allclose(brine["t"][1], plain["t"][1])
    assert runs["npzd"]["port"]["t"].shape[0] > 2


def test_reference_sharded_step_leaves_out_the_polar_drag(runs):
    """The reference's gap: its sharded step parts from its unsharded
    step beyond its test's velocity tolerance, where the port's does
    not."""
    r = runs["polar_drag"]
    rtol, atol = TOL_JAX["u"]
    gap = np.abs(r["jax_sharded"]["u"] - r["jax"]["u"])
    assert not np.all(gap <= atol + rtol * np.abs(r["jax"]["u"]))
    # the tracers and the rest of the domain stay within the contract
    np.testing.assert_allclose(r["jax_sharded"]["t"], r["jax"]["t"],
                               rtol=1e-9, atol=1e-11)
    assert_jax_tolerances(r["sharded"]["state"], r["jax"])
    assert_port_equal(r["sharded"]["state"], r["port"])
    assert_replicated(r["sharded"])


def test_reference_sharded_step_departs_with_the_9_point_operator():
    """The reference's second gap: with ``sf_npt=9`` psi's ghost columns
    are not the real columns they stand for (the checkerboard null
    vector is zero on the border), and one leapfrog step of the JAX
    package's sharded step leaves its own test's contract (which its
    5-point step keeps, ``tests/test_shardmap_step.py``)."""
    jc, tc = configs(dict(sf_npt=9))
    jm, primed, forcing = setup(jc, tc)
    ref = jax_steps(jm, primed, forcing, (True,))
    mesh = j_make_mesh(SHAPE)
    ss = JStep(jm, mesh)
    s = j_shard_pytree(JOceanState(**{k: jnp.asarray(v)
                                      for k, v in primed.items()}), mesh)
    s = ss.step(s, j_shard_pytree(j_forcing(forcing), mesh), leapfrog=True)
    got = j_state_dict(jax.device_get(s))
    assert np.abs(ref["psi0"][:, 0] - ref["psi0"][:, -2]).max() > 0.0
    with pytest.raises(AssertionError):
        assert_jax_tolerances(got, ref)
