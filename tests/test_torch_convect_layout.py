"""Host-side geometry of the region-mean apply (csrc/convect_apply.cu), on
the CPU.

``region_means_launch`` gives the kernel's blocks, tile columns, tracer
stages and shared memory; it is held to the H100's limits here, and a
plain-PyTorch emulation of the kernel's schedule (tiles of the plane, a
ring of staged tracer tiles refilled ``stages`` tracers ahead, one
multiply-add chain per output over the levels' differences from the top
of the output's region) is held bitwise against
``apply_region_means_ref``, which the kernel is held against on the card.
"""

import numpy as np
import pytest
import torch

from uvic_tpu_torch.ops.convection import (MAX_KM, MAX_THREADS, STAGES,
                                           apply_region_means_ref,
                                           column_stride, region_means_launch)
from uvic_tpu_torch.ops.tracer_kernel import SMEM_LIMIT

H100_SMS = 132
SM_THREADS = 2048           # resident threads an SM holds
SMSP_REGISTERS = 65536 // 4  # each of an SM's four partitions holds its warps
STATIC_SMEM = 48 * 1024     # the launcher sets no opt-in attribute
# registers a thread of the km <= 20 instantiation takes: 40 by ptxas
# (chip_smoke.py phase 1 prints it on the H100), allocated in units of 8
FLAGSHIP_REGISTERS = 40

FLAGSHIP = [(2, 19, 102, 102), (41, 19, 102, 102)]
# chip_smoke.py CONVECT_SHAPES: odd planes, km 1 to 64, nt 1 to 41
ODD = [(41, 19, 7, 13), (1, 1, 5, 7), (41, 1, 4, 9), (41, 8, 9, 11),
       (2, 19, 10, 10), (1, 19, 6, 7), (8, 19, 5, 9), (9, 8, 3, 11),
       (1, 64, 6, 10), (41, 64, 3, 7)]


@pytest.mark.parametrize("shape", FLAGSHIP + ODD, ids=str)
def test_launch_fits_the_card(shape):
    nt, km, jmt, imt = shape
    plane = jmt * imt
    blocks, cols, slots, smem = region_means_launch(nt, km, jmt, imt)
    assert 32 <= cols * km <= MAX_THREADS <= 1024
    assert (blocks - 1) * cols < plane <= blocks * cols
    assert 1 <= slots == min(nt, STAGES)
    stride = column_stride(km)
    assert km <= stride and stride % 8 == 4 and smem == 4 * slots * cols * stride
    assert smem <= STATIC_SMEM <= SMEM_LIMIT


@pytest.mark.parametrize("nt", [2, 41])
def test_flagship_grid_takes_under_two_waves(nt):
    """4 blocks an SM by registers, each of the SM's four partitions
    holding 12 warps of 40-register threads (the card's occupancy query,
    printed by chip_smoke.py, agrees): 651 blocks in 1.23 waves of
    528."""
    blocks, cols, _, smem = region_means_launch(nt, 19, 102, 102)
    warps = -(-cols * 19 // 32)
    per_sm = min(SM_THREADS // (32 * warps),
                 4 * (SMSP_REGISTERS // (32 * FLAGSHIP_REGISTERS)) // warps,
                 SMEM_LIMIT // (smem + 1024))
    assert (blocks, cols, warps, per_sm) == (651, 16, 10, 4)
    assert H100_SMS * per_sm < blocks < 2 * H100_SMS * per_sm


@pytest.mark.parametrize("km", [0, MAX_KM + 1, 100])
def test_levels_the_kernel_does_not_take_raise(km):
    with pytest.raises(ValueError, match="levels"):
        region_means_launch(2, km, 4, 4)


def region_means_tiled(ts, mnorm, ocean):
    """The kernel's schedule in plain PyTorch: slot n % STAGES holds
    tracer n, filled STAGES - 1 tracers ahead into the slot of tracer
    n - 1 (the ring is ``slots`` long when nt < STAGES)."""
    nt, km, jmt, imt = ts.shape
    plane = jmt * imt
    blocks, cols, slots, _ = region_means_launch(nt, km, jmt, imt)
    t = ts.reshape(nt, km, plane)
    m = mnorm.reshape(km, km, plane)
    wet_all = ocean.reshape(km, plane) > 0
    out = torch.full_like(t, float("nan"))
    for b in range(blocks):
        c0 = b * cols
        w = min(cols, plane - c0)
        ring = [None] * slots
        for s in range(min(STAGES - 1, nt)):
            ring[s] = t[s, :, c0:c0 + w].clone()
        mrow, wet = m[:, :, c0:c0 + w], wet_all[:, c0:c0 + w]
        # each thread's reference level: the first l with M[k, l] != 0
        nz = mrow != 0
        own = torch.arange(km)[:, None].expand(km, w)
        lref = torch.where(nz.any(1), nz.to(torch.uint8).argmax(1), own)
        for n in range(nt):
            ahead = n + STAGES - 1
            if ahead < nt:
                ring[(n - 1) % STAGES] = t[ahead, :, c0:c0 + w].clone()
            tile = ring[n % STAGES]
            r = torch.gather(tile, 0, lref)
            acc = mrow[:, 0] * (tile[0][None] - r)
            for l in range(1, km):
                acc = acc + mrow[:, l] * (tile[l][None] - r)
            out[n, :, c0:c0 + w] = torch.where(wet, r + acc, tile)
    return out.reshape(ts.shape)


@pytest.mark.parametrize("shape", ODD, ids=str)
def test_tiled_schedule_equals_the_plain_version(shape):
    nt, km, jmt, imt = shape
    rng = np.random.default_rng(5)
    kmt = rng.integers(0, km + 1, size=(jmt, imt))
    ocean = (np.arange(km)[:, None, None] < kmt[None]).astype(np.float32)
    ts = 15.0 + 5.0 * rng.standard_normal((nt, km, jmt, imt))
    m = rng.uniform(0.0, 2.0 / km, (km, km, jmt, imt))
    args = [torch.as_tensor(x, dtype=torch.float32) for x in (ts, m, ocean)]
    got = region_means_tiled(*args)
    assert torch.equal(got, apply_region_means_ref(*args))
