"""Explicit halo exchange for the rank-decomposed ocean step (torch).

Port of ``uvic_tpu.parallel.halo``.  Every field that feeds the step's
stencil cascade is packed into ONE array, exchanged ONCE per step with a
halo wide enough to cover the whole stencil composition depth, and the
port's unchanged whole-domain functions then run on the halo-padded
local block.  Shard-edge cells within the halo compute garbage (rolls
wrap local data) and are cropped; everything a kept cell reads is valid
because the halo is wider than the stencil depth.  The exchange is one
round of point-to-point messages along the cyclic x ring, then one along
the walled y line, through ``mesh.RankMesh.exchange``.

``exchange_pad`` and ``extend_x`` are the reference's: outside the
window's stored columns they place the periodic images of its real
columns.  The port's step pads with what the whole field's rolls read
instead (``exchange_pad_ring``, ``extend_x(..., ring=True)``, ``BlockCut``):
the ring of imt columns on which the ghost columns 0 and imt-1 are
columns of their own, so that a walled window, and ghost columns that
are not the columns they duplicate, compute as on the whole field.

Grid conventions (``core/grid.py``): arrays carry duplicated zonal ghost
columns (col 0 = col imt-2, col imt-1 = col 1), so the true zonal period
is imt-2.  Static per-cell constants (grid factors, masks, kmt, operator
coefficients) are *extended* on the host with that periodicity in x and
edge-clamp or zero fill in y; each rank slices its padded local view once
(``ExtendedStatics.bag``).  The meridional boundary rows are solid walls:
y halos beyond the walls are zero-filled, which matches the global
computation because every stencil masks those rows.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

# classification of the per-cell constant arrays in the kernel
# parameter bag (model.py `bag`): which trailing axes are spatial
# 'x'  : last axis is imt      'y'  : last axis is jmt
# 'yx' : trailing axes (jmt, imt)    'k'/'scalar': replicated
BAG_AXES = {
    "dxt": "x", "dxu": "x", "dxtr": "x", "dxt2r": "x", "dxt4r": "x",
    "dxu2r": "x", "dxu4r": "x", "dxur": "x", "dxmetr": "x",
    "duw": "x", "due": "x",
    "dyt": "y", "dyu": "y", "cst": "y", "csu": "y", "dytr": "y",
    "dyt2r": "y", "dyu2r": "y", "dyu4r": "y", "dyur": "y",
    "cstr": "y", "csur": "y", "dus": "y", "dun": "y",
    "cstdyt2r": "y", "csudyu2r": "y",
    "advmet": "y", "amc_north": "y", "amc_south": "y",
    "ahc_north": "y", "ahc_south": "y", "am3": "y", "am4": "y",
    "cstdxt2r": "yx", "cstdxtr": "yx", "cstdxur": "yx",
    "csudxur": "yx", "csudxu2r": "yx", "hr": "yx", "h": "yx",
    "cori": "yx",
    "dzt": "k", "dzw": "k", "dzt2r": "k", "dztr": "k", "dzwr": "k",
    "dztur": "k", "dztlr": "k", "dtxcel": "k",
    "ah": "scalar", "am": "scalar", "grav_rho0r": "scalar",
    "quicker": "skip",
}

# message tags of the two rounds (gloo matches a receive by peer and tag)
TAG_EAST, TAG_WEST, TAG_NORTH, TAG_SOUTH = 1, 2, 3, 4


# ----------------------------------------------------------------------
# host-side extension of static constants
#
# The window may be PADDED beyond the reference layout to make the
# grid divisible by the mesh: window position g (0-based) holds the
# periodic image of real column ((g - 1) mod m) + 1 with m = imt - 2
# (positions 0 and imt-1 reproduce the standard duplicated ghost
# columns; positions >= imt are extra images).  Rows beyond jmt - 1
# are "beyond the wall": clamp (grid factors) or zero (masked fields).

def x_images(p, n: int, ring: bool = False) -> np.ndarray:
    """The stored column each window position ``p`` holds: itself in
    [0, n); outside, the periodic image ((p - 1) mod (n - 2)) + 1 of the
    real columns, or with ``ring`` the column p mod n that the whole
    field's rolls read (on that ring the ghost columns 0 and n-1 are
    columns of their own)."""
    p = np.asarray(p)
    image = p % n if ring else ((p - 1) % (n - 2)) + 1
    return np.where((p >= 0) & (p < n), p, image)


def extend_x(a: np.ndarray, w: int, axis: int = -1,
             n_out: int | None = None, ring: bool = False) -> np.ndarray:
    """Periodic window extension: output position p in [0, n) keeps the
    stored column (incl. the duplicated ghosts); outside, p maps to the
    periodic image ((p - 1) mod (n - 2)) + 1 (``x_images``; with
    ``ring``, to p mod n)."""
    a = np.asarray(a)
    n = a.shape[axis]
    n_out = n if n_out is None else n_out
    return np.take(a, x_images(np.arange(-w, n_out + w), n, ring),
                   axis=axis)


def extend_y(a: np.ndarray, w: int, axis: int = -1,
             fill: str = "clamp", n_out: int | None = None) -> np.ndarray:
    """Extend beyond the wall rows: 'clamp' repeats the edge value
    (grid factors — finite, multiplied by zero-masked data), 'zero'
    pads zeros (masks and physical fields)."""
    a = np.asarray(a)
    n = a.shape[axis]
    n_out = n if n_out is None else n_out
    gi = np.arange(-w, n_out + w)
    if fill == "clamp":
        return np.take(a, np.clip(gi, 0, n - 1), axis=axis)
    out = np.take(a, np.clip(gi, 0, n - 1), axis=axis)
    mask_shape = [1] * a.ndim
    mask_shape[axis] = len(gi)
    valid = ((gi >= 0) & (gi < n)).reshape(mask_shape)
    return np.where(valid, out, np.zeros_like(out))


def extend_yx(a: np.ndarray, w: int, fill: str = "clamp",
              jmt_p: int | None = None,
              imt_p: int | None = None, ring: bool = False) -> np.ndarray:
    """Extend trailing (jmt, imt) axes: x periodic (``ring``: as
    ``extend_x``), y clamp/zero."""
    return extend_y(extend_x(a, w, axis=-1, n_out=imt_p, ring=ring), w,
                    axis=-2, fill=fill, n_out=jmt_p)


class ExtendedStatics:
    """Host-extends a dict of named constants once and gives each rank
    its padded local views.

    jmt_p/imt_p: PADDED window sizes (multiples of ny/nx); positions
    beyond the reference layout carry periodic x images / beyond-wall
    y fill, so any grid shards on any mesh; ``ring``: the x images that
    the whole field's rolls read (``x_images``).  A view keeps its
    constant's dtype and device."""

    def __init__(self, arrays: dict, axes: dict, jmt: int, imt: int,
                 ny: int, nx: int, w: int, fills: dict | None = None,
                 jmt_p: int | None = None, imt_p: int | None = None,
                 ring: bool = False):
        jmt_p = jmt if jmt_p is None else jmt_p
        imt_p = imt if imt_p is None else imt_p
        if jmt_p % ny or imt_p % nx:
            raise ValueError(f"padded grid {jmt_p}x{imt_p} not divisible "
                             f"by mesh {ny}x{nx}")
        self.ly, self.lx = jmt_p // ny, imt_p // nx
        self.w = w
        self.axes = axes
        fills = fills or {}
        self.ext = {}
        for name, a in arrays.items():
            kind = axes[name]
            if kind in ("k", "scalar", "skip") or a is None:
                self.ext[name] = a
                continue
            fill = fills.get(name, "clamp")
            h = a.detach().cpu().numpy()
            if kind == "x":
                e = extend_x(h, w, axis=-1, n_out=imt_p, ring=ring)
            elif kind == "y":
                e = extend_y(h, w, axis=-1, fill=fill, n_out=jmt_p)
            else:
                e = extend_yx(h, w, fill=fill, jmt_p=jmt_p, imt_p=imt_p,
                              ring=ring)
            self.ext[name] = torch.as_tensor(e, device=a.device)

    def local(self, name: str, iy: int, ix: int):
        """Padded local view (size l+2w on each sharded axis)."""
        a = self.ext[name]
        kind = self.axes[name]
        if kind in ("k", "scalar", "skip") or a is None:
            return a
        w = self.w
        if kind == "x":
            v = a[..., ix * self.lx:ix * self.lx + self.lx + 2 * w]
        elif kind == "y":
            v = a[..., iy * self.ly:iy * self.ly + self.ly + 2 * w]
        else:
            v = a[..., iy * self.ly:iy * self.ly + self.ly + 2 * w,
                  ix * self.lx:ix * self.lx + self.lx + 2 * w]
        return v.contiguous()

    def bag(self, iy: int, ix: int) -> SimpleNamespace:
        return SimpleNamespace(
            **{k: self.local(k, iy, ix) for k in self.ext})


# ----------------------------------------------------------------------
# runtime halo exchange

def exchange_pad(f, w: int, mesh, gx: int = 2):
    """Pad a local block (..., ly, lx) to (..., ly+2w, lx+2w) with
    neighbor data: one round of messages along the cyclic x ring
    (honoring the duplicated ghost columns) and one along the walled y
    line.  Corners are correct because the y round runs on the x-padded
    array.  A mesh axis of size 1 sends nothing: the x ring wraps the
    rank's own block, the y line gets zeros.

    gx: trailing ghost/image column count of the global window — 2 for
    the standard layout, 2 + pad when the window is padded to make imt
    divisible by nx (window position g holds real ((g-1) mod m) + 1,
    m = true zonal period)."""
    ny, nx = mesh.shape
    lx = f.shape[-1]
    # --- x ring: the true zonal period excludes the gx trailing image
    # columns (and 1 leading ghost), so the first/last ranks send their
    # *real* periodic-continuation columns
    send_e = (f[..., lx - gx - w:lx - gx] if mesh.ix == nx - 1
              else f[..., lx - w:])
    send_w = f[..., gx:gx + w] if mesh.ix == 0 else f[..., :w]
    if nx == 1:
        wh, eh = send_e, send_w
    else:
        east, west = mesh.x_neighbours()
        # sends before receives, east-bound first on both sides: with
        # two ranks both messages go to the same peer and arrive in order
        wh, eh = mesh.exchange(
            [(send_e, east, TAG_EAST), (send_w, west, TAG_WEST)],
            [(send_e, west, TAG_EAST), (send_w, east, TAG_WEST)])
    f = torch.cat([wh, f, eh], dim=-1)
    return _exchange_y(f, w, mesh)


def _exchange_y(f, w: int, mesh):
    """The y round of the exchange on the x-padded block: ranks at the
    walls receive zeros, matching the masked wall rows."""
    ly = f.shape[-2]
    north, south = mesh.y_neighbours()
    sends, recvs = [], []
    if north is not None:
        sends.append((f[..., ly - w:, :], north, TAG_NORTH))
    if south is not None:
        sends.append((f[..., :w, :], south, TAG_SOUTH))
    if south is not None:
        recvs.append((f[..., :w, :], south, TAG_NORTH))
    if north is not None:
        recvs.append((f[..., ly - w:, :], north, TAG_SOUTH))
    got = mesh.exchange(sends, recvs) if sends else []
    zeros = torch.zeros_like(f[..., :w, :])
    sh = got.pop(0) if south is not None else zeros   # from the south
    nh = got.pop(0) if north is not None else zeros   # from the north
    return torch.cat([sh, f, nh], dim=-2)


def exchange_pad_ring(f, w: int, mesh, pad: int = 0):
    """``exchange_pad`` with the x images of the ring of imt columns that
    the whole field's rolls go round (``x_images(..., ring=True)``): the
    window position p >= imt holds column p - imt, p < 0 column imt + p,
    the ghost columns 0 and imt-1 stay what the blocks hold.  ``pad``:
    the window's columns beyond imt (``padded_window``), which the last
    rank of the x ring takes from the first rank's columns 0 .. pad-1
    (whatever its block holds there), with the halo beyond them."""
    nx = mesh.shape[1]
    lx = f.shape[-1]
    last = mesh.ix == nx - 1
    send_e = f[..., lx - pad - w:lx - pad] if last else f[..., lx - w:]
    send_w = f[..., :pad + w] if mesh.ix == 0 else f[..., :w]
    if nx == 1:
        wh, eh = send_e, send_w
    else:
        east, west = mesh.x_neighbours()
        # the first rank's west-bound message carries the pad columns too
        like_e = f[..., :pad + w] if last else f[..., :w]
        wh, eh = mesh.exchange(
            [(send_e, east, TAG_EAST), (send_w, west, TAG_WEST)],
            [(f[..., :w], west, TAG_EAST), (like_e, east, TAG_WEST)])
    body = f[..., :lx - pad] if last else f
    f = torch.cat([wh, body, eh], dim=-1)
    return _exchange_y(f, w, mesh)


def pack_exchange_ring(fields: list, w: int, mesh, pad: int = 0) -> list:
    """``pack_exchange`` through ``exchange_pad_ring``."""
    packed, meta = pack(fields)
    return unpack(exchange_pad_ring(packed, w, mesh, pad), meta)


def crop(f, w: int):
    """Drop the halo frame."""
    return f[..., w:f.shape[-2] - w, w:f.shape[-1] - w]


def pad_zeros(f, w: int):
    """Shape-match a field that needs no neighbor data (pointwise use
    only, e.g. surface fluxes, bgc sources)."""
    return torch.nn.functional.pad(f, (w, w, w, w))


# ----------------------------------------------------------------------
# window padding (divisibility lift): global fields are padded from
# (jmt, imt) to (jmt_p, imt_p) — x pad columns gather the periodic
# images of REAL columns, y pad rows are zeros (beyond the wall, always
# masked) — and cropped back after.

def pad_window(f, jmt_p: int, imt_p: int):
    jmt, imt = f.shape[-2:]
    if imt_p > imt:
        idx = torch.as_tensor(x_images(np.arange(imt, imt_p), imt),
                              device=f.device)
        f = torch.cat([f, torch.index_select(f, -1, idx)], dim=-1)
    if jmt_p > jmt:
        f = torch.nn.functional.pad(f, (0, 0, 0, jmt_p - jmt))
    return f


def crop_window(f, jmt: int, imt: int):
    return f[..., :jmt, :imt]


class BlockCut:
    """One rank's halo-padded block of a whole (..., jmt, imt) field, as
    ``ExtendedStatics(..., ring=True)`` cuts a constant with zero fill:
    for fields that every rank holds whole (the barotropic fields) and
    that the step reads on its padded block.  The index tables are built
    once."""

    def __init__(self, jmt: int, imt: int, iy: int, ix: int, ly: int,
                 lx: int, w: int, device):
        rows = np.arange(iy * ly - w, (iy + 1) * ly + w)
        self.rows = torch.as_tensor(np.clip(rows, 0, jmt - 1), device=device)
        self.wall_rows = torch.as_tensor(
            np.nonzero((rows < 0) | (rows >= jmt))[0], device=device)
        self.cols = torch.as_tensor(
            x_images(np.arange(ix * lx - w, (ix + 1) * lx + w), imt,
                     ring=True),
            device=device)

    def __call__(self, a):
        out = a.index_select(-2, self.rows).index_select(-1, self.cols)
        if self.wall_rows.numel():
            out[..., self.wall_rows, :] = 0.0
        return out


def pack(fields: list):
    """Flatten each (..., ly, lx) field's leading dims and concatenate
    them in the first field's dtype: (packed, meta for ``unpack``)."""
    ly, lx = fields[0].shape[-2:]
    dtype = fields[0].dtype
    flat, meta = [], []
    for f in fields:
        lead = tuple(f.shape[:-2])
        n = int(np.prod(lead)) if lead else 1
        flat.append(f.to(dtype).reshape((n, ly, lx)))
        meta.append((lead, n, f.dtype))
    return torch.cat(flat, dim=0), meta


def unpack(packed, meta) -> list:
    outs, off = [], 0
    for lead, n, dt in meta:
        blk = packed[off:off + n].to(dt)
        outs.append(blk.reshape(lead + tuple(blk.shape[-2:])))
        off += n
    return outs


def pack_exchange(fields: list, w: int, mesh, gx: int = 2) -> list:
    """Halo-pad a list of (..., ly, lx) arrays with ONE exchange:
    flatten leading dims, concatenate, exchange, split back."""
    packed, meta = pack(fields)
    return unpack(exchange_pad(packed, w, mesh, gx=gx), meta)
