"""The port's rank-decomposed ocean step (``parallel.shard_step``) against
the JAX package's unsharded step, the twins of
``tests/test_shardmap_step.py``.

Each case's ranks are gloo CPU processes (``launch.spawn``), one block
of the mesh each, in float64; one spawn of eight ranks runs every mesh
of the file (the (2, 2) mesh on the first four).
The gathered state is held against ``uvic_tpu``'s ``_step`` at that
file's tolerances, and against the port's own unsharded ``_step`` on the
same tracer path (the generic step) within 1e-12 of each field's scale
(``tests/torch_shard_runs.py``); each rank's replicated psi0, psi1, ptd
and ptdb are bitwise equal to the others'.  On the standard 102x102
grid the meshes pad the window (104 columns on (2, 4)): each rank's
ghost and image columns hold what ``setbcx`` and ``pad_window`` give the
global field, and the rows beyond the wall are zero.
"""

import dataclasses

import numpy as np
import pytest

from uvic_tpu.config import ModelConfig as JModelConfig
from uvic_tpu.parallel.shard_step import ShardedOceanStep as JStep

from uvic_tpu_torch.config import ModelConfig
from uvic_tpu_torch.parallel.mesh import padded_window
from uvic_tpu_torch.parallel.shard_step import ShardedOceanStep

from torch_shard_runs import (assert_jax_tolerances, assert_port_equal,
                              assert_replicated, configs, jax_steps, job,
                              port_steps, setup, sharded_meshes)
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

# name: (isopycnal, mesh, halo, jmt, imt, schedule); test_shardmap_step's
# cases, its forward step and its standard grid on both meshes
CASES = {
    "plain_2x4": (False, (2, 4), 8, 34, 40, (True,) * 3),
    "plain_1x8": (False, (1, 8), 5, 34, 56, (True,) * 3),
    "isopycnal_2x2": (True, (2, 2), 10, 34, 40, (True,) * 3),
    "forward_2x4": (False, (2, 4), 8, 34, 40, (False,)),
    "standard_2x4": (False, (2, 4), 8, 102, 102, (True,) * 2),
    "standard_1x8": (False, (1, 8), 5, 102, 102, (True,) * 2),
}
# the forward and standard-grid cases' velocity tolerances
# (test_shardmap_step.py:106-107, :135-136)
TOL_U_TIGHT = (1e-7, 1e-9)


@pytest.fixture(scope="module")
def runs():
    """Every case: the JAX and port unsharded references and the
    sharded run (one spawn per mesh)."""
    out, by_mesh, models, refs = {}, {}, {}, {}
    for name, (iso, shape, halo, jmt, imt, schedule) in CASES.items():
        key = (iso, jmt, imt)
        if key not in models:
            jc, tc = configs(dict(isopycmix=iso, gent_mcwilliams=iso),
                             jmt=jmt, imt=imt)
            models[key] = (tc,) + setup(jc, tc)
        tc, jm, primed, forcing = models[key]
        if key + (schedule,) not in refs:      # the standard grid's twice
            refs[key + (schedule,)] = dict(
                jax=jax_steps(jm, primed, forcing, schedule),
                port=port_steps(tc, primed, forcing, schedule))
        out[name] = dict(refs[key + (schedule,)])
        by_mesh.setdefault(shape, []).append(
            (name, job(tc, primed, forcing, schedule, halo)))
    results = sharded_meshes({shape: [j for _, j in jobs]
                              for shape, jobs in by_mesh.items()})
    for shape, jobs in by_mesh.items():
        for (name, _), res in zip(jobs, results[shape]):
            out[name]["sharded"] = res
    return out


@pytest.mark.parametrize("name", ["plain_2x4", "plain_1x8",
                                  "isopycnal_2x2"])
def test_sharded_step_equivalence(runs, name):
    r = runs[name]
    got = r["sharded"]["state"]
    assert_jax_tolerances(got, r["jax"])
    assert_port_equal(got, r["port"])
    assert_replicated(r["sharded"])


def test_sharded_forward_step(runs):
    """A mixing (forward) step also agrees."""
    r = runs["forward_2x4"]
    got = r["sharded"]["state"]
    np.testing.assert_allclose(got["t"], r["jax"]["t"], rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(got["u"], r["jax"]["u"], rtol=TOL_U_TIGHT[0],
                               atol=TOL_U_TIGHT[1])
    assert_port_equal(got, r["port"])
    assert_replicated(r["sharded"])


@pytest.mark.parametrize("name", ["standard_2x4", "standard_1x8"])
def test_sharded_standard_grid(runs, name):
    """The standard 102x102 grid on meshes that do not divide it."""
    r = runs[name]
    got = r["sharded"]["state"]
    np.testing.assert_allclose(got["t"], r["jax"]["t"], rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(got["u"], r["jax"]["u"], rtol=TOL_U_TIGHT[0],
                               atol=TOL_U_TIGHT[1])
    assert_port_equal(got, r["port"])
    assert_replicated(r["sharded"])


@pytest.mark.parametrize("name", ["standard_2x4", "standard_1x8",
                                  "plain_2x4"])
def test_ghost_and_image_columns(runs, name):
    """Each rank's blocks of t and u, assembled into the padded window:
    the real columns are the gathered field, column 0 holds column
    imt-2, columns imt-1 .. imt_p-1 the real columns they mirror, and
    the rows beyond the wall are zero — what setbcx and pad_window give
    the global field."""
    _, shape, _, jmt, imt, _ = CASES[name]
    ny, nx = shape
    jmt_p, imt_p = padded_window(jmt, imt, shape)
    assert (jmt_p, imt_p) != (jmt, imt) or name == "plain_2x4"
    res = runs[name]["sharded"]
    for field in ("t", "u"):
        blocks = [b[field] for b in res["ranks_blocks"]]
        rows = [np.concatenate(blocks[iy * nx:(iy + 1) * nx], axis=-1)
                for iy in range(ny)]
        window = np.concatenate(rows, axis=-2)
        assert window.shape[-2:] == (jmt_p, imt_p)
        np.testing.assert_array_equal(window[..., :jmt, :imt],
                                      res["state"][field])
        np.testing.assert_array_equal(window[..., :jmt, 0],
                                      window[..., :jmt, imt - 2])
        images = [((g - 1) % (imt - 2)) + 1 for g in range(imt - 1, imt_p)]
        np.testing.assert_array_equal(window[..., :jmt, imt - 1:],
                                      window[..., :jmt, images])
        assert not window[..., jmt:, :].any()


def test_required_halo_is_the_reference_law():
    """The derived halo (one definition, ``ShardedOceanStep``) equals the
    JAX package's for every scheme combination, and dominates every
    hand-picked width of test_shardmap_step.py."""
    for adv in ("centered", "upstream", "fct", "quicker"):
        for iso in (False, True):
            for hmix in ("const", "biharmonic", "smagnl"):
                kw = dict(tracer_advection=adv, isopycmix=iso, hmix=hmix)
                jo = dataclasses.replace(JModelConfig().ocean, **kw)
                to = dataclasses.replace(ModelConfig().ocean, **kw)
                assert ShardedOceanStep.required_halo(to) \
                    == JStep.required_halo(jo)
    cfg = ModelConfig().ocean                       # FCT + isopycnal
    assert ShardedOceanStep.required_halo(cfg) >= 10
    plain = dataclasses.replace(cfg, isopycmix=False, gent_mcwilliams=False,
                                tracer_advection="centered")
    assert ShardedOceanStep.required_halo(plain) >= 5
    fct = dataclasses.replace(cfg, isopycmix=False, gent_mcwilliams=False)
    assert ShardedOceanStep.required_halo(fct) >= 8
