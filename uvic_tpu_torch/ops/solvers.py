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
    """Per-island sum of x over perimeter cells -> (nisle,) vector, added
    in the same order on every call: in cell order on the CPU (the
    reference's scatter-add), by one reduction per island on a card,
    where ``index_add_`` adds with atomics in an order that changes from
    call to call and from process to process (ranks that solve the same
    system would then part by round-off)."""
    if x.device.type != "cpu":
        return island_sum_by_reduction(x, isl)
    pid = torch.clamp(isl.perim_id, 0, max(isl.nisle - 1, 0))
    contrib = torch.where(isl.perim_id >= 0, x, torch.zeros_like(x))
    out = torch.zeros(max(isl.nisle, 1), dtype=x.dtype, device=x.device)
    return out.index_add_(0, pid.reshape(-1), contrib.reshape(-1))


def island_sum_by_reduction(x, isl: IslandIndex):
    """``island_sum`` as one masked reduction per island: its order is
    fixed by the shape alone, on any device."""
    ids = torch.arange(max(isl.nisle, 1), device=x.device)
    own = isl.perim_id[None] == ids[:, None, None]
    return torch.where(own, x[None], torch.zeros_like(x)).sum((-2, -1))


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


def bicgstab_safe(matvec, b, x0, M, tol, maxiter, check_every=None):
    """Breakdown-guarded BiCGSTAB (van der Vorst 1992) for the EMBM
    transport solves (``uvic_tpu.ops.solvers.bicgstab_safe``).

    Every division is guarded, and once the residual is below
    ``tol * |b|`` (or a division broke down) every iterate is frozen:
    each further trip selects the old values.  So a loop that runs more
    trips returns the same x bitwise, and the loop takes one of two
    forms:

    - ``check_every=n`` (eager): the host reads ``done`` after every n
      trips and stops, one sync per n trips;
    - ``check_every=None`` (capturable): ``maxiter`` trips, no host
      read, so a CUDA graph can hold the whole solve.

    Returns (x, trips) with trips a 0-d int32 tensor: the trips before
    the iterate froze, as the reference's loop counts them.
    """
    tiny = 1e-30

    def sdot(a, c):
        return torch.sum(a * c)

    def safe_div(n, d):
        ok = torch.abs(d) > tiny
        return torch.where(ok, n / torch.where(ok, d, 1.0), 0.0), ok

    r0 = b - matvec(x0)
    bnorm = torch.sqrt(sdot(b, b))
    thresh = tol * torch.clamp(bnorm, min=tiny)
    x, r, rhat, p = x0, r0, r0, r0
    rho = sdot(r0, r0)
    done = torch.sqrt(rho) <= thresh
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    for trip in range(maxiter):
        if check_every is not None and trip % check_every == 0 \
                and bool(done):
            break
        p_hat = M(p)
        v = matvec(p_hat)
        alpha, ok_a = safe_div(rho, sdot(rhat, v))
        s = r - alpha * v
        s_hat = M(s)
        t = matvec(s_hat)
        omega, ok_o = safe_div(sdot(t, s), sdot(t, t))
        x_n = x + alpha * p_hat + omega * s_hat
        r_n = s - omega * t
        rho_new = sdot(rhat, r_n)
        beta_f, ok_b = safe_div(rho_new * alpha, rho * omega)
        p_n = r_n + beta_f * (p - omega * v)
        now = (torch.sqrt(sdot(r_n, r_n)) <= thresh) \
            | ~(ok_a & ok_o & ok_b)
        if check_every == 1:
            # ``done`` was read false before this trip: nothing to freeze
            x, r, p, rho, done = x_n, r_n, p_n, rho_new, now
            k = k + 1
            continue
        keep = done
        x = torch.where(keep, x, x_n)
        r = torch.where(keep, r, r_n)
        p = torch.where(keep, p, p_n)
        rho = torch.where(keep, rho, rho_new)
        k = k + (~keep).to(torch.int32)
        done = done | now
    return x, k
