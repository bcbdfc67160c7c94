"""The island sums of the barotropic solve add in a fixed order.

On a card, ``index_add_`` adds with atomics in an order that changes from
call to call and from process to process; the CG kernel's preconditioner
(``make_inv``) summed the island diagonals that way, so two processes
solving the same system parted by round-off.  There ``island_sum`` takes
one masked reduction per island (``island_sum_by_reduction``), held here
on the CPU against the scatter-add, the reference's order, on the world
topography's islands.
"""

import numpy as np
import pytest
import torch

from uvic_tpu_torch.config import ModelConfig, small_config
from uvic_tpu_torch.models.ocean.model import make_ocean
from uvic_tpu_torch.ops.solvers import (island_sum, island_sum_by_reduction,
                                        make_inv)
from torch_threads import torch_one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("cfg", [small_config(imt=40, jmt=34, km=8),
                                 ModelConfig()], ids=["small", "standard"])
def test_reduction_form_matches_the_scatter_add(cfg):
    m = make_ocean(cfg, device="cpu")
    assert m.isl.nisle >= 1
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        m.isl.perim_id.shape))
    got = island_sum_by_reduction(x, m.isl)
    ref = island_sum(x, m.isl)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-13,
                               atol=1e-13 * float(x.abs().sum()))
    np.testing.assert_array_equal(
        island_sum_by_reduction(x, m.isl).numpy(), got.numpy())


def test_preconditioner_of_the_reduction_form():
    """make_inv's island diagonals from either form agree to round-off."""
    m = make_ocean(small_config(imt=40, jmt=34, km=8), device="cpu")
    z = make_inv(m.cf_unit, m.isl)
    diag = m.cf_unit[1, 1]
    sums = island_sum_by_reduction(diag, m.isl)
    on = m.isl.perim_id >= 0
    rep = sums[torch.clamp(m.isl.perim_id, 0, m.isl.nisle - 1)]
    np.testing.assert_allclose((1.0 / rep[on]).numpy(), z[on].numpy(),
                               rtol=1e-13)
