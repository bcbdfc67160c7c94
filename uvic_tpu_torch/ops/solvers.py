"""Elliptic solver: island-constrained preconditioned conjugate gradient.

Port of ``uvic_tpu.ops.solvers`` (source/mom/congrad.F, Dukowicz, Smith
& Malone 1993).  The island-perimeter machinery (iperm/jperm gather
loops, congrad.F:933-1040) becomes dense segment reductions over a
perimeter-id map.  ``congrad`` is the plain PyTorch version of the
single-launch CUDA solver in ``ops/cg_kernel.py``: the iteration loop
runs on the host with the reference's geometric-series error
extrapolation as the stop rule (congrad.F:62-105,415-426).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class IslandIndex:
    """Dense island-perimeter indexing (replaces iperm/jperm/iofs lists)."""
    perim_id: Any          # (jmt, imt) int64: island index or -1
    nisle: int
    counts: Any            # (nisle,) perimeter cell counts
    imain: int             # island whose psi is normalized to zero
    ocean_mask: Any        # (jmt, imt) 1.0 where land_map <= 0 (ocean+perim)


def island_sum(x, isl: IslandIndex):
    """Per-island sum of x over perimeter cells -> (nisle,) vector."""
    pid = torch.clamp(isl.perim_id, 0, max(isl.nisle - 1, 0))
    contrib = torch.where(isl.perim_id >= 0, x, torch.zeros_like(x))
    out = torch.zeros(max(isl.nisle, 1), dtype=x.dtype, device=x.device)
    return out.index_add_(0, pid.reshape(-1), contrib.reshape(-1))


def _dist(x, isl, sums):
    rep = sums[torch.clamp(isl.perim_id, 0, isl.nisle - 1)]
    return torch.where(isl.perim_id >= 0, rep, x)


def sum_dist(x, isl: IslandIndex):
    """Sum perimeter contributions per island, replicate the sum at every
    perimeter cell (congrad.F:933-986)."""
    if isl.nisle == 0:
        return x
    return _dist(x, isl, island_sum(x, isl))


def avg_dist(x, isl: IslandIndex):
    """Average perimeter contributions per island, replicate
    (congrad.F:988-1040)."""
    if isl.nisle == 0:
        return x
    return _dist(x, isl, island_sum(x, isl) / isl.counts)


def border(v, cyclic=True):
    """Zero meridional boundary rows, apply zonal cyclic wrap
    (poisson.F:1-60 `border`, no-symmetry branch).  Returns a new tensor."""
    v = v.clone()
    v[0, :] = 0.0
    v[-1, :] = 0.0
    if cyclic:
        v[:, 0] = v[:, -2]
        v[:, -1] = v[:, 1]
    else:
        v[:, 0] = 0.0
        v[:, -1] = 0.0
    return v


def apply_op9(cf, x):
    """res = A x for the 3x3-stencil operator; cf is (3, 3, jmt, imt)
    indexed [dj+1, di+1] (congrad.F op5_vec/op9_vec). Interior only;
    borders zeroed."""
    res = torch.zeros_like(x)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            res = res + cf[dj + 1, di + 1] * torch.roll(x, (-dj, -di),
                                                        dims=(0, 1))
    res[0, :] = 0.0
    res[-1, :] = 0.0
    res[:, 0] = 0.0
    res[:, -1] = 0.0
    return res


def dot2(a, b):
    """Interior dot product (congrad.F:615-638)."""
    return torch.sum(a[1:-1, 1:-1] * b[1:-1, 1:-1])


def absmax(a):
    return torch.max(torch.abs(a))


def make_inv(cf, isl: IslandIndex):
    """Diagonal preconditioner Z = 1/diag(A), with island diagonals summed
    over perimeters and replicated (congrad.F:862-930)."""
    z = sum_dist(cf[1, 1], isl)
    return torch.where(z != 0.0, 1.0 / torch.where(z == 0.0,
                                                   torch.ones_like(z), z),
                       torch.zeros_like(z))


def congrad(cf, guess, forc, isl: IslandIndex, tol, max_iter: int,
            cyclic=True):
    """Preconditioned CG with island constraint equations (congrad.F:1-470).

    Solves A dpsi = forc where A is the 5/9-point operator ``cf`` with
    Dirichlet island constraints folded in via perimeter sum/replicate.
    Returns (dpsi, iterations, estimated_error, converged) with python
    scalars for the last three.

    Constant-mode deflation, as in ``uvic_tpu``: ones on the active set
    (nonzero preconditioner diagonal) is an exact null vector of the
    curl-form operator; it is projected out of the preconditioned
    residual and the returned iterate so round-off in the forcing cannot
    grow along it.
    """
    dpsi = border(guess, cyclic)
    z = border(make_inv(cf, isl), cyclic)
    w = border((z != 0.0).to(z.dtype), cyclic)
    ww = dot2(w, w)

    def deflate(x):
        return x - (dot2(x, w) / ww) * w

    res = forc - apply_op9(cf, dpsi)
    res = deflate(border(res, cyclic))

    def inv_op(r):
        return border(sum_dist(z * r, isl), cyclic)

    zres0 = inv_op(res)
    done = bool(100.0 * absmax(zres0) < tol)
    trivially_done = done
    k = 0
    s = torch.zeros_like(dpsi)
    betakm1 = 1.0
    step1 = 0.0
    est = float(100.0 * absmax(zres0))
    while not done and k < max_iter:
        k += 1
        zres = deflate(inv_op(res))
        betak = float(dot2(zres, res))
        # guard the recurrence against an exactly-zero betakm1
        denom_b = betakm1 if abs(betakm1) > 0.0 else 1.0
        s = zres + (betak / denom_b) * s
        As = border(apply_op9(cf, s), cyclic)
        s_dot_As = float(dot2(s, As))
        safe = abs(s_dot_As) > abs(betak) * 1.0e-10
        alpha = betak / s_dot_As if safe else 0.0
        dpsi = dpsi + alpha * s
        res = deflate(border(avg_dist(res - alpha * As, isl), cyclic))
        step = abs(alpha) * float(absmax(s))
        if k == 1:
            step1 = step
        # geometric-series error extrapolation (congrad.F:415-426)
        small = step < tol
        if k == 1:
            est = step
            done = step < tol
        elif small:
            rate = math.exp(math.log(max(step / step1, 1e-300)) / (k - 1))
            est = step * rate / (1.0 - rate) if rate != 1.0 else math.inf
            done = est < tol
        done = done or not safe
        betakm1 = betak
    return deflate(dpsi), k, est, done or trivially_done
