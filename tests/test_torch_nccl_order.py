"""The rank-decomposed exchanges pair their messages by posting order.

NCCL ignores tags: between two ranks it matches the k-th send to the
k-th receive.  gloo matches by peer and tag, so the gloo runs of the
other shard tests cannot show that the port's exchanges are right for
NCCL.  Here the rank function puts every message of
``RankMesh.exchange`` under one tag (``torch_rank_fns.with_one_tag``),
so that gloo too can pair them by peer and order only, and each run
must equal the same run with the tags bitwise:

- the flagship's physics on the small grid (34x40x8: isopycnal/GM,
  tidal kv, geothermal heat, anisotropic and zonal viscosity, FCT, full
  convection, the island streamfunction), a forward and a leapfrog step
  on (2, 2) and (1, 2) meshes;
- ``halo.pack_exchange_ring`` with pad columns (pad > 0): on 34x40 over
  (1, 3), and on 34x41 over (1, 2) and (2, 2), where the two x-ring
  messages to the one peer differ in size.

The padded blocks are also held against the ring of imt columns cut
from the whole field (``halo.extend_yx(..., ring=True)``).  One spawn of
four gloo CPU ranks runs every mesh.
"""

import numpy as np
import pytest

from uvic_tpu_torch.parallel.halo import extend_yx
from uvic_tpu_torch.parallel.shard_step import run_sharded

import torch_rank_fns
from torch_shard_runs import (FIELDS, FLAGSHIP, configs, job, port_setup,
                              spawn_meshes, wind)
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

SCHEDULE = (False, True)
STEP_MESHES = ((2, 2), (1, 2))
W = 3
# mesh: (jmt, imt) of the ring exchange's fields
RING = {(1, 3): (34, 40), (1, 2): (34, 41), (2, 2): (34, 41)}


def ring_fields(jmt, imt):
    rng = np.random.default_rng(19)
    return [rng.standard_normal((2, 3, jmt, imt)),
            rng.standard_normal((jmt, imt))]


@pytest.fixture(scope="module")
def runs():
    _, tc = configs(FLAGSHIP)
    forcing = wind(*_grid_of(tc))
    step = job(tc, port_setup(tc, forcing), forcing, SCHEDULE)
    calls = {shape: [] for shape in set(STEP_MESHES) | set(RING)}
    for shape in STEP_MESHES:
        calls[shape] += [(run_sharded, step),
                         (torch_rank_fns.with_one_tag,
                          dict(fn=run_sharded, **step))]
    for shape, (jmt, imt) in RING.items():
        ring = dict(fields=ring_fields(jmt, imt), w=W)
        calls[shape] += [(torch_rank_fns.ring_blocks, ring),
                         (torch_rank_fns.with_one_tag,
                          dict(fn=torch_rank_fns.ring_blocks, **ring))]
    return spawn_meshes(calls)


def _grid_of(tc):
    from uvic_tpu_torch.models.ocean.model import make_ocean
    m = make_ocean(tc, device="cpu")
    return m.params.grid, m.nt


@pytest.mark.parametrize("shape", STEP_MESHES, ids=str)
def test_flagship_steps_pair_messages_by_order(runs, shape):
    """One tag, the same bits: the gathered state on rank 0, and every
    rank's replicated fields and blocks."""
    ranks = runs[shape]
    tagged, (one, sent) = ranks[0][:2]
    assert sent > 0
    for name in FIELDS + ("ubar", "ubarm1", "itt", "nconv"):
        np.testing.assert_array_equal(one["state"][name],
                                      tagged["state"][name], err_msg=name)
    for rank in ranks:
        tagged, (one, _) = rank[:2]
        for part in ("barotropic", "blocks"):
            for name, a in tagged[part].items():
                np.testing.assert_array_equal(one[part][name], a,
                                              err_msg=(part, name))


@pytest.mark.parametrize("shape", sorted(RING), ids=str)
def test_ring_exchange_with_pad_pairs_messages_by_order(runs, shape):
    """The padded blocks of the pad > 0 ring exchange: one tag equal to
    the tags bitwise, and both the ring of imt columns around the
    rank's part of the padded window (zero rows beyond the walls)."""
    jmt, imt = RING[shape]
    ny, nx = shape
    jmt_p, imt_p = -(-jmt // ny) * ny, -(-imt // nx) * nx
    assert imt_p > imt
    ly, lx = jmt_p // ny, imt_p // nx
    whole = [extend_yx(a, W, fill="zero", jmt_p=jmt_p, imt_p=imt_p,
                       ring=True) for a in ring_fields(jmt, imt)]
    for r, rank in enumerate(runs[shape]):
        tagged, (one, sent) = rank[-2:]
        assert sent > 0
        iy, ix = divmod(r, nx)
        for got, ref, a in zip(one, tagged, whole):
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(
                ref, a[..., iy * ly:iy * ly + ly + 2 * W,
                       ix * lx:ix * lx + lx + 2 * W])
