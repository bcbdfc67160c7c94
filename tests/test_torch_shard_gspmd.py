"""The slice as a whole: the port's rank-decomposed step on two option
models against the JAX package's own GSPMD sharding of its unsharded
step.

The reference partitions any ``OceanModel`` step over its mesh with
``uvic_tpu.parallel.mesh.shard_step`` (``jax.jit`` with spatial
shardings; ``tests/test_sharding.py``), where its explicit sharded core
refuses the options below.  Two models, the small forms (34x40x8, the
sharded tests' settings, ``torch_shard_runs.BASE``) of ``chip_smoke.py``
phase 13's option models:

- ``g1``: walls, ppmix, the 9-point operator, the Fourier filter,
  Euler-backward mixing and the full isopycnal tensor;
- ``g3``: the implicit free surface, QUICKER and biharmonic mixing.

Each takes a mixing step and two leapfrog steps from the primed state:
in the JAX package as one GSPMD-sharded function on a (2, 2) mesh of the
virtual CPU devices of ``tests/conftest.py`` (one compile a model), in
the port on a (2, 2) mesh of gloo CPU ranks (``ShardedOceanStep``, one
spawn for both).  The port's gathered state is held at
``tests/test_sharding.py``'s tolerances: t at rtol 1e-9 / atol 1e-11, and
psi (the surface pressure of the free surface) de-meaned on wet points
within 5e-3 of its scale (the solver-limited level); the port's ranks
hold their replicated fields bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvic_tpu.core.state import OceanState as JOceanState
from uvic_tpu.parallel.mesh import make_mesh, shard_pytree, shard_step

from torch_shard_runs import (assert_replicated, configs, j_forcing,
                              j_state_dict, job, setup, sharded)

SHAPE = (2, 2)
SCHEDULE = (False, True, True)
# name: (ocean options, grid options)
MODELS = {
    "g1": (dict(vmix="ppmix", sf_npt=9, hlat_filter="fourier", eb=True,
                full_tensor=True), dict(cyclic=False)),
    "g3": (dict(barotropic="implicit_free_surface",
                tracer_advection="quicker", hmix="biharmonic"), {}),
}


def _configs(ocean, grid):
    import dataclasses
    jc, tc = configs(ocean)
    if grid:
        jc, tc = (c.replace(grid=dataclasses.replace(c.grid, **grid))
                  for c in (jc, tc))
    return jc, tc


def gspmd_steps(jm, primed, forcing):
    """``SCHEDULE`` through the JAX package's ``mesh.shard_step``: one
    jitted function of the three steps, sharded over a (2, 2) mesh."""
    mesh = make_mesh(SHAPE)
    s = shard_pytree(JOceanState(**{k: jnp.asarray(v)
                                    for k, v in primed.items()}), mesh)
    f = shard_pytree(j_forcing(forcing), mesh)

    def steps(s, f):
        for lf in SCHEDULE:
            s = jm.step(s, f, leapfrog=lf)
        return s
    out = shard_step(steps, mesh, s, f)(s, f)
    return j_state_dict(jax.device_get(out))


@pytest.fixture(scope="module")
def runs():
    out, jobs = {}, []
    for name, (ocean, grid) in MODELS.items():
        jc, tc = _configs(ocean, grid)
        jm, primed, forcing = setup(jc, tc)
        out[name] = dict(jax=gspmd_steps(jm, primed, forcing), tc=tc,
                         wet=np.asarray(jm.params.topo.tmask)[0] > 0)
        jobs.append(job(tc, primed, forcing, SCHEDULE))
    for name, res in zip(MODELS, sharded(SHAPE, jobs)):
        out[name]["port"] = res
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tracers_match_gspmd(runs, name):
    r = runs[name]
    np.testing.assert_allclose(r["port"]["state"]["t"], r["jax"]["t"],
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_psi_matches_gspmd_at_the_solver_level(runs, name):
    """psi (or the surface pressure) de-meaned on wet points, within
    5e-3 of its scale (``test_sharding.py:76-90``)."""
    r = runs[name]
    wet = r["wet"]
    ref = r["jax"]["psi0"] - r["jax"]["psi0"][wet].mean()
    got = r["port"]["state"]["psi0"]
    got = got - got[wet].mean()
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got[wet] / scale, ref[wet] / scale,
                               atol=5e-3)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_replicated_fields_bitwise(runs, name):
    assert_replicated(runs[name]["port"])
    assert runs[name]["port"]["state"]["itt"] == runs[name]["jax"]["itt"]


def test_models_take_their_options(runs):
    """The port's models are the options they stand for."""
    g1, g3 = runs["g1"]["tc"].ocean, runs["g3"]["tc"].ocean
    assert not runs["g1"]["tc"].grid.cyclic
    assert (g1.vmix, g1.sf_npt, g1.hlat_filter, g1.eb, g1.full_tensor) \
        == ("ppmix", 9, "fourier", True, True)
    assert (g3.barotropic, g3.tracer_advection, g3.hmix) \
        == ("implicit_free_surface", "quicker", "biharmonic")
