"""Island-constrained barotropic CG: CUDA kernel wrapper and plain version.

Counterpart of ``uvic_tpu/ops/pallas_cg.py:make_pallas_congrad``: the
whole preconditioned CG of ``ops/solvers.congrad`` (congrad.F) in one
launch of one thread-block cluster (``csrc/congrad.cu``).  CTA r of the
cluster owns a band of rows and keeps its band of the operator in shared
memory; ``cg_layout`` builds the tables that cut the grid into bands
(row bounds, border sources, per-band island perimeter lists) and
``cg_smem_bytes`` the shared memory each CTA takes.  ``CGSolver`` binds
the static geometry; calling it solves A dpsi = forc for one timestep:
CPU tensors take ``congrad_ref``, CUDA tensors launch the kernel
(``congrad_launch``, which also returns the cluster size the launch
ran with).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..cuda import LIBRARY, check_cuda, launch, ptr
from .solvers import IslandIndex, congrad, make_inv

MAX_ISLANDS = 16            # csrc/congrad.cu MAXISLE
MAX_CLUSTER = 16            # csrc/congrad.cu MAXC
CLUSTER = 16                # non-portable (8 is the portable size)
SMEM_LIMIT = 232448         # bytes of shared memory a block may use


def congrad_ref(cf_unit, isl, guess, forc, c2dtsf, tol, max_iter, cyclic):
    """Plain version: ``solvers.congrad`` on the operator cf_unit/c2dtsf,
    the host looping to the same max_iter and stop rule.  Returns
    (dpsi, iters) with iters a 0-d int32 tensor."""
    dpsi, iters, _, _ = congrad(cf_unit / c2dtsf, guess, forc, isl, tol,
                                max_iter, cyclic)
    return dpsi, torch.tensor(iters, dtype=torch.int32, device=dpsi.device)


def border_source(jmt, imt, cyclic):
    """(jmt, imt) int32: the flat index of the cell whose value the
    border operation (poisson.F border) copies into each cell, -1 where
    it writes zero (boundary rows, closed zonal walls).  A cell is
    interior exactly where it is its own source."""
    j, i = np.meshgrid(np.arange(jmt), np.arange(imt), indexing="ij")
    col = i.copy()
    if cyclic:
        col[:, 0], col[:, -1] = imt - 2, 1
    else:
        col[:, 0] = col[:, -1] = -1
    src = np.where(col >= 0, j * imt + col, -1)
    src[0, :] = src[-1, :] = -1
    return src.astype(np.int32)


def cg_smem_bytes(rmax, imt, npmax):
    """Dynamic shared memory of one CTA (csrc/congrad.cu smem_words):
    16 planes of the band (9 operator, preconditioner, w, res, As, dpsi,
    zres, the packed source ids), two s planes with a halo row above and
    below, and the band's perimeter list."""
    n = rmax * imt
    return 4 * (16 * n + 2 * (n + 2 * imt) + npmax)


@dataclass(frozen=True)
class CGLayout:
    """How the cluster cuts the grid.

    bands  : (C+1,) row bounds; CTA r owns rows [bands[r], bands[r+1])
    src    : (jmt, imt) border sources (``border_source``)
    plist  : perimeter cells (flat index), band by band, island by
             island within a band, ascending within an island
    poff   : (C*nisle+1,) offsets: band r's cells of island q are
             plist[poff[r*nisle+q] : poff[r*nisle+q+1]]
    """
    cluster: int
    bands: np.ndarray
    src: np.ndarray
    plist: np.ndarray
    poff: np.ndarray
    rmax: int
    npmax: int
    smem_bytes: int


def cg_layout(perim_id, nisle, cyclic, cluster=CLUSTER):
    """The band tables of a (jmt, imt) grid with island ids ``perim_id``
    for a cluster of ``cluster`` CTAs (at most one per row)."""
    perim_id = np.asarray(perim_id)
    jmt, imt = perim_id.shape
    c = int(cluster)
    if not 1 <= c <= min(MAX_CLUSTER, jmt):
        raise ValueError(f"cg_layout: cluster {c} for {jmt} rows")
    bands = np.array([r * jmt // c for r in range(c + 1)], dtype=np.int32)
    flat = perim_id.reshape(-1)
    cells, poff = [], [0]
    for r in range(c):
        lo, hi = bands[r] * imt, bands[r + 1] * imt
        for q in range(nisle):
            seg = lo + np.flatnonzero(flat[lo:hi] == q)
            cells.append(seg)
            poff.append(poff[-1] + seg.size)
    plist = (np.concatenate(cells) if cells else np.zeros(0)).astype(np.int32)
    poff = np.asarray(poff, dtype=np.int32)
    rmax = int(np.diff(bands).max())
    npmax = int(max((poff[(r + 1) * nisle] - poff[r * nisle]
                     for r in range(c)), default=0))
    return CGLayout(c, bands, border_source(jmt, imt, cyclic), plist, poff,
                    rmax, npmax, cg_smem_bytes(rmax, imt, npmax))


class CGSolver:
    """Barotropic solver bound to static geometry.

    cf_unit : (3, 3, jmt, imt) operator coefficients at unit timestep
    isl     : IslandIndex of the island perimeters
    cluster : CTAs of the kernel's cluster (at most one per row)
    Call ``solver(guess, forc, c2dtsf, tol) -> (dpsi, iters)``.
    """

    def __init__(self, cf_unit, isl: IslandIndex, max_iter: int,
                 cyclic: bool = True, cluster: int = CLUSTER):
        self.cf_unit = cf_unit
        self.isl = isl
        self.max_iter = int(max_iter)
        self.cyclic = bool(cyclic)
        jmt, imt = cf_unit.shape[-2:]
        dev = cf_unit.device
        self.z_unit = make_inv(cf_unit, isl).contiguous()
        self.cf9 = cf_unit.reshape(9, jmt, imt).contiguous()
        self.pid = isl.perim_id.to(torch.int32).contiguous()
        self.rcount = (1.0 / torch.clamp(isl.counts, min=1.0)).contiguous()
        self.layout = cg_layout(isl.perim_id.cpu().numpy(), isl.nisle,
                                self.cyclic, min(cluster, jmt))

        def ti(x):
            return torch.as_tensor(x, dtype=torch.int32, device=dev)

        lay = self.layout
        self.tables = dict(bands=ti(lay.bands), src=ti(lay.src),
                           plist=ti(lay.plist if lay.plist.size else [0]),
                           poff=ti(lay.poff))

    def __call__(self, guess, forc, c2dtsf, tol):
        if guess.device.type == "cpu":
            return congrad_ref(self.cf_unit, self.isl, guess, forc, c2dtsf,
                               tol, self.max_iter, self.cyclic)
        return congrad_cuda(self, guess, forc, c2dtsf, tol)


def max_active_clusters(solver: CGSolver):
    """How many of the solver's clusters the card holds at once (0: the
    launch cannot run)."""
    lay = solver.layout
    n = LIBRARY.get().uvic_congrad_max_clusters(lay.cluster, lay.smem_bytes)
    if n < 0:
        raise RuntimeError(f"uvic_congrad_max_clusters: CUDA error {-n}")
    return n


def congrad_cuda(solver: CGSolver, guess, forc, c2dtsf, tol):
    """The cluster CG kernel's solve (float32): (dpsi, iters)."""
    dpsi, info = congrad_launch(solver, guess, forc, c2dtsf, tol)
    return dpsi, info[0]


def congrad_launch(solver: CGSolver, guess, forc, c2dtsf, tol):
    """Launch the cluster CG kernel: (dpsi, info), info an int32 tensor
    of the iterations and the CTAs the launch's cluster ran with."""
    jmt, imt = solver.pid.shape
    lay = solver.layout
    if solver.isl.nisle > MAX_ISLANDS:
        raise ValueError(f"congrad_cuda: {solver.isl.nisle} islands, "
                         f"kernel takes {MAX_ISLANDS}")
    if lay.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"congrad_cuda: {lay.smem_bytes} bytes of shared "
                         f"memory per CTA, a CTA may use {SMEM_LIMIT}")
    check_cuda("congrad_cuda", dict(
        cf=(solver.cf9, (9, jmt, imt)), z=(solver.z_unit, (jmt, imt)),
        rcount=(solver.rcount, None), guess=(guess, (jmt, imt)),
        forc=(forc, (jmt, imt))))
    t = solver.tables
    check_cuda("congrad_cuda", dict(
        pid=(solver.pid, (jmt, imt)), src=(t["src"], (jmt, imt)),
        bands=(t["bands"], (lay.cluster + 1,)), plist=(t["plist"], None),
        poff=(t["poff"], None)), dtype=torch.int32)
    dpsi = torch.empty_like(guess)
    info = torch.empty(2, dtype=torch.int32, device=guess.device)
    launch("uvic_congrad", ptr(solver.cf9), ptr(solver.z_unit),
           ptr(t["src"]), ptr(solver.pid), ptr(solver.rcount),
           ptr(t["bands"]), ptr(t["plist"]), ptr(t["poff"]), ptr(guess),
           ptr(forc), ptr(dpsi), ptr(info), jmt, imt, solver.isl.nisle,
           solver.max_iter, lay.cluster, lay.rmax, lay.npmax,
           lay.smem_bytes, float(c2dtsf), float(tol))
    congrad_launch.launches += 1
    return dpsi, info


congrad_launch.launches = 0
