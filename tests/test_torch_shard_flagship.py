"""The slice as a whole: the flagship ocean, rank-decomposed, against the
JAX package's unsharded step.

The full-width flagship physics (102x102x19, nt=2: isopycnal/GM mixing,
FCT, full convection, tidal kv, geothermal heat, anisotropic and zonal
viscosity, FIR filters, the island-constrained streamfunction) on a
(2, 4) mesh of gloo CPU ranks with the derived halo (11; the window pads
to 104 columns), three leapfrog steps from the JAX-primed state; and the
full-MOBI suite (nt=41) at 34x40x8 on a (2, 2) mesh, the twin of
``tests/test_shardmap_step.py::test_shardmap_flagship_standard_grid_mobi``
at a size the CPU steps in seconds.  Both in float64, at the JAX tests'
tolerances against ``uvic_tpu``'s ``_step`` and within 1e-12 of the
port's own unsharded step; the replicated fields bitwise equal on every
rank.
"""

import pytest

from uvic_tpu_torch.parallel.shard_step import ShardedOceanStep

from torch_shard_runs import (assert_jax_tolerances, assert_port_equal,
                              assert_replicated, configs, jax_steps, job,
                              port_steps, setup, sharded)

SCHEDULE = (True, True, True)
CASES = {"flagship": (dict(flagship=True), (2, 4)),
         "mobi": (dict(mobi=True), (2, 2))}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    kw, shape = CASES[request.param]
    jc, tc = configs({}, **kw)
    jm, primed, forcing = setup(jc, tc)
    return dict(name=request.param, tc=tc, shape=shape,
                jax=jax_steps(jm, primed, forcing, SCHEDULE),
                port=port_steps(tc, primed, forcing, SCHEDULE),
                sharded=sharded(shape, [job(tc, primed, forcing,
                                            SCHEDULE)])[0])


def test_sharded_matches_jax(run):
    assert_jax_tolerances(run["sharded"]["state"], run["jax"])


def test_sharded_matches_the_port_unsharded(run):
    assert_port_equal(run["sharded"]["state"], run["port"])


def test_barotropic_fields_replicated_bitwise(run):
    assert_replicated(run["sharded"])


def test_derived_halo_and_blocks(run):
    """The halo is derived and the window padded where the mesh does not
    divide the grid.  On the CPU the kernel wrappers take their plain
    versions and count no launch (``chip_smoke.py`` phase 13 reads the
    counts on the card)."""
    assert ShardedOceanStep.required_halo(run["tc"].ocean) == 11
    t = run["sharded"]["ranks_blocks"][0]["t"]
    if run["name"] == "flagship":
        assert t.shape == (2, 19, 51, 26)       # 102 x 104 over (2, 4)
    else:
        assert t.shape == (41, 8, 17, 20)
    assert run["sharded"]["launches"] == {"fct_tracer_step": 0,
                                          "apply_region_means": 0,
                                          "congrad": 0}
    assert run["sharded"]["transport"] == "gloo, cpu tensors"
    assert len(run["sharded"]["cg_iters"]) == len(SCHEDULE)
