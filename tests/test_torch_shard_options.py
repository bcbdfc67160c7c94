"""Which ocean options the rank-decomposed step takes, and how.

``ShardedOceanStep`` refuses, with a ``ConfigError`` that names them,
the options the reference's sharded step refuses by assertion (the
surface-pressure modes, ppmix, walls, Smagorinsky mixing, QUICKER) and
two that the reference's sharded step takes without a word but computes
otherwise than its unsharded step: Euler-backward mixing (its mixing
step is a forward step either way) and the 9-point operator (whose
checkerboard deflation leaves psi's ghost columns other than the
columns they stand for, which the window's periodic images cannot
reproduce; shown below on the reference itself).  The
options its core takes are computed as the port's unsharded ``_step``
computes them: each runs on a (2, 2) mesh of gloo CPU ranks, a forward
and two leapfrog steps, within 1e-12 of the unsharded step (generic
tracer path), the replicated fields bitwise equal on every rank.

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

from uvic_tpu_torch.checks import ConfigError
from uvic_tpu_torch.config import BgcConfig, small_config
from uvic_tpu_torch.models.ocean.model import make_ocean
from uvic_tpu_torch.parallel.mesh import RankMesh
from uvic_tpu_torch.parallel.shard_step import ShardedOceanStep

from torch_shard_runs import (BASE, TOL_JAX, assert_jax_tolerances,
                              assert_port_equal, assert_replicated, configs,
                              j_forcing, j_state_dict, jax_steps, job,
                              port_setup, port_steps, setup, sharded, wind)

SHAPE = (2, 2)
SCHEDULE = (False, True, True)
# option -> (ocean options, grid options, what the message names)
REFUSED = {
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
# options of OceanModel._step that the sharded core computes as it does
COMPUTED = {
    "neptune": dict(neptune=True),
    "full_tensor": dict(isopycmix=True, gent_mcwilliams=True,
                        full_tensor=True),
    "biharmonic": dict(hmix="biharmonic"),
    "acor": dict(acor=0.5),
    "ncon_bryan_lewis_shortwave": dict(convection="ncon", ncon=2,
                                       vmix="bryan_lewis", shortwave=True),
    "brine": dict(convect_brine=True),
    "npzd": dict(),
    "plain": dict(),
}
POLAR = dict(cdbot_polar_scale=20.0)
# three leapfrog steps show the reference's polar-drag gap (one JAX
# compile each way fewer than with a mixing step first)
POLAR_SCHEDULE = (True, True, True)


def _port_config(ocean, grid=None, bgc=None):
    cfg = small_config(imt=40, jmt=34, km=8)
    cfg = cfg.replace(ocean=dataclasses.replace(cfg.ocean,
                                                **{**BASE, **ocean}))
    if grid:
        cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, **grid))
    if bgc:
        cfg = cfg.replace(bgc=bgc)
    return cfg


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_options_are_named(name):
    ocean, grid, named = REFUSED[name]
    m = make_ocean(_port_config(ocean, grid), device="cpu")
    with pytest.raises(ConfigError, match=named):
        ShardedOceanStep(m, RankMesh(SHAPE, device="cpu"))
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


@pytest.fixture(scope="module")
def runs():
    """Every computed option: the port's unsharded and sharded runs; the
    polar-drag case in both packages, sharded and not.  One spawn."""
    out, jobs = {}, []
    for name, ocean in COMPUTED.items():
        bgc = BgcConfig(suite="npzd") if name == "npzd" else None
        tc = _port_config(ocean, bgc=bgc)
        m = make_ocean(tc, device="cpu")
        g = m.params.grid
        forcing = (_brine_forcing(g, np.asarray(m.params.topo.tmask)[0],
                                  m.nt)
                   if name == "brine" else wind(g, m.nt))
        primed = port_setup(tc, forcing)
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

    for name, res in zip(list(COMPUTED) + ["polar_drag"],
                         sharded(SHAPE, jobs)):
        out[name]["sharded"] = res
    return out


@pytest.mark.parametrize("name", sorted(COMPUTED))
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
