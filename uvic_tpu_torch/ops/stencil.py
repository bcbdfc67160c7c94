"""Stencil shift helpers and boundary conditions (torch).

Fields are whole-domain tensors ``(..., jmt, imt)`` and stencils are
composed from shift operators, as in ``uvic_tpu.ops.stencil``
(reference: fdift.h/fdifm.h statement functions, util.F:789-815).

Index conventions (0-based):
- ``E(a)[..., j, i] == a[..., j, i+1]`` (east neighbor), periodic in x,
- ``N(a)[..., j, i] == a[..., j+1, i]``, periodic in y; the wrapped rows
  0/jmt-1 are solid walls that callers mask,
- ``DN(a)[..., k, j, i] == a[..., k+1, j, i]`` (level below), zero-filled
  beyond the bottom; ``UP`` the level above.
"""

from __future__ import annotations

import torch


def E(a):
    return torch.roll(a, -1, dims=-1)


def W(a):
    return torch.roll(a, 1, dims=-1)


def N(a):
    return torch.roll(a, -1, dims=-2)


def S(a):
    return torch.roll(a, 1, dims=-2)


def DN(a, fill=0.0):
    """Shift in k so index k holds level k+1; bottom filled with ``fill``."""
    pad = torch.full_like(a[..., -1:, :, :], fill)
    return torch.cat([a[..., 1:, :, :], pad], dim=-3)


def UP(a, fill=0.0):
    """Shift in k so index k holds level k-1; top filled with ``fill``."""
    pad = torch.full_like(a[..., :1, :, :], fill)
    return torch.cat([pad, a[..., :-1, :, :]], dim=-3)


class BlockColumns:
    """The zonal boundary columns of one rank's halo-padded block of the
    window (``parallel.shard_step``): ``west`` and ``east``, the block's
    columns that stand for the window's columns 0 and imt-1.  The block's
    columns follow the ring of imt columns that the whole field's rolls
    go round, so column imt-2 lies two to the west of column 0 and
    column 1 two to the east of column imt-1.  ``setbcx`` treats them as
    the whole field's: cyclic, each takes the column it duplicates
    (where the block holds it), at walls they are zeroed; ``zero_east``
    zeroes the east ones.  Passed as a function's ``cyclic`` flag, it is
    true for a cyclic window."""

    def __init__(self, west, east, width: int, cyclic: bool):
        self.cyclic = bool(cyclic)
        self.west = sorted(int(c) for c in west)
        self.east = sorted(int(c) for c in east)
        self.cols = sorted(self.west + self.east)
        pairs = ([(c, c - 2) for c in self.west if c >= 2]
                 + [(c, c + 2) for c in self.east if c + 2 < width])
        self.dst = [d for d, _ in pairs]
        self.src = [s for _, s in pairs]

    def __bool__(self):
        return self.cyclic


def setbcx(a, cyclic: bool = True):
    """Zonal boundary condition on the duplicated boundary columns
    (util.F:789-815): cyclic wrap col 0 <- col imt-2, col imt-1 <- col 1;
    solid walls zero the boundary columns otherwise (a ``BlockColumns``:
    the block's columns that stand for them).  Returns a new tensor."""
    out = a.clone()
    if isinstance(cyclic, BlockColumns):
        if cyclic.cyclic:
            if cyclic.dst:
                out[..., cyclic.dst] = a[..., cyclic.src]
        elif cyclic.cols:
            out[..., cyclic.cols] = 0.0
    elif cyclic:
        out[..., 0] = a[..., -2]
        out[..., -1] = a[..., 1]
    else:
        out[..., 0] = 0.0
        out[..., -1] = 0.0
    return out


def zero_east(a, walls=False):
    """A copy of ``a`` with the walled east boundary column (imt-1)
    zeroed; with a ``BlockColumns``, the block's columns that stand for
    it."""
    out = a.clone()
    if isinstance(walls, BlockColumns):
        if walls.east:
            out[..., walls.east] = 0.0
    else:
        out[..., -1] = 0.0
    return out


def zero_boundary_rows(a):
    """Zero the meridional boundary rows j=0 and j=jmt-1 (a new
    tensor)."""
    out = a.clone()
    out[..., 0, :] = 0.0
    out[..., -1, :] = 0.0
    return out


def interior_mask(jmt: int, imt: int, dtype, device="cpu"):
    """1 on computed cells (j in 1..jmt-2, i in 1..imt-2), else 0."""
    m = torch.zeros((jmt, imt), dtype=dtype, device=device)
    m[1:-1, 1:-1] = 1.0
    return m
