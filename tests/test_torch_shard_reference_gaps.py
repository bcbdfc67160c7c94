"""Two more options that the reference's sharded step takes without an
assertion but computes otherwise than its ``OceanModel._step``, shown on
the JAX package itself (``uvic_tpu/`` is not edited; ROADMAP Queue C).

- Neptune: its core calls ``clinic_step`` without ``unep``
  (``uvic_tpu/parallel/shard_step.py:247-250``), so the sharded step
  leaves its own test's contract.
- The full tensor: its core hands ``compute_isopyc`` the traced local
  bag, from which ``isopyc.full_tensor_delta`` reads NumPy, and tracing
  fails.

The port computes both as ``_step`` does (``unep`` and the band of the
global grid as statics): ``tests/test_torch_shard_options.py``.  The
polar drag and the 9-point operator are shown there.
"""

import jax
import jax.numpy as jnp
import pytest

from uvic_tpu.core.state import OceanState as JOceanState
from uvic_tpu.parallel.mesh import make_mesh, shard_pytree
from uvic_tpu.parallel.shard_step import ShardedOceanStep as JStep

from torch_shard_runs import (assert_jax_tolerances, configs, j_forcing,
                              j_state_dict, jax_steps, setup)
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

SHAPE = (2, 2)
SCHEDULE = (True,)         # one leapfrog step shows the gap


def _jax_sharded(jm, primed, forcing, schedule):
    mesh = make_mesh(SHAPE)
    ss = JStep(jm, mesh)
    s = shard_pytree(JOceanState(**{k: jnp.asarray(v)
                                    for k, v in primed.items()}), mesh)
    f = shard_pytree(j_forcing(forcing), mesh)
    for lf in schedule:
        s = ss.step(s, f, leapfrog=lf)
    return j_state_dict(jax.device_get(s))


def test_reference_sharded_step_leaves_out_neptune():
    jc, tc = configs(dict(neptune=True))
    jm, primed, forcing = setup(jc, tc)
    assert jm.unep is not None
    ref = jax_steps(jm, primed, forcing, SCHEDULE)
    got = _jax_sharded(jm, primed, forcing, SCHEDULE)
    with pytest.raises(AssertionError):
        assert_jax_tolerances(got, ref)


def test_reference_sharded_step_fails_on_the_full_tensor():
    jc, tc = configs(dict(isopycmix=True, gent_mcwilliams=True,
                          full_tensor=True))
    jm, primed, forcing = setup(jc, tc)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        _jax_sharded(jm, primed, forcing, SCHEDULE)
