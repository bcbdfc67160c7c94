"""Transport-matrix (TMM) extraction, torch.

Port of ``uvic_tpu.diag.tmm`` (updates/10/source/mom/matrix.F +
matrix.h): the reference seeds the tracer field with "tiles" (sparse
lattices of unit impulses), steps the model, and accumulates

  Aexp = (tracer_out - tile) / twodt      (MATRIX_STORE_EXPLICIT :47)
  Aimp = invtri(tile)                     (MATRIX_STORE_IMPLICIT :79)

per tile, which together give the explicit-tendency and implicit
vertical-diffusion operators in Khatiwala's transport-matrix form.
Here every tile is one tracer of a single call of the centered tracer
step, and every level's probe sheet one column block of a single
``invtri`` call, on the model's device; the dense per-tile responses
convert to a scipy CSR matrix on the host.

The lattice spacing must cover the advection stencil footprint
(centered: 3 points per horizontal dim).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ocean.kernels import adv_vel, tracer_step
from ..ops.tridiag import invtri_columns


def make_tiles(km, jmt, imt, spacing=(3, 5, 5), dtype=np.float64,
               cyclic=True):
    """Unit-impulse lattices covering the grid: tile (sk,sj,si) has a
    one at every point with (k,j,i) ≡ offsets mod spacing.  Returns
    (ntile, km, jmt, imt); the tiles sum to the all-ones field over the
    physical domain.

    With a cyclic seam the zonal lattice runs over the PHYSICAL columns
    1..imt-2 ((i-1) mod si) and the duplicated boundary columns mirror
    it (setbcx), so impulse patterns are seam-consistent; si should
    divide imt-2 or seam-adjacent impulses of one tile fall closer than
    the lattice period."""
    sk, sj, si = spacing
    if cyclic and (imt - 2) % si != 0:
        raise ValueError(
            f"zonal spacing {si} must divide the {imt - 2} physical "
            "columns for a seam-consistent lattice")
    kk, jj, ii = np.meshgrid(np.arange(km), np.arange(jmt),
                             np.arange(imt), indexing="ij")
    iphys = (ii - 1) % si if cyclic else ii % si
    tiles = []
    for ok in range(sk):
        for oj in range(sj):
            for oi in range(si):
                t = ((kk % sk == ok) & (jj % sj == oj)
                     & (iphys == oi)).astype(dtype)
                if cyclic:
                    t[..., 0] = t[..., imt - 2]
                    t[..., imt - 1] = t[..., 1]
                tiles.append(t)
    return np.stack(tiles)


def extract_matrices(model, state, forcing, spacing=(3, 5, 5),
                     nsamples=1):
    """Extract (Aexp_tiles, Aimp_sheets, tiles) around the circulation of
    ``state`` (matrix.F MATRIX_STORE_*), as NumPy arrays.

    Aexp_tiles[n] = (tracer_step(tile_n) - tile_n) / c2dtts  with the
                    explicit (aidif=0) centered operator at the tau
                    circulation
    Aimp_sheets[k] = invtri(sheet_k): the implicit vertical solve probed
                    with one horizontal sheet per level (the tridiagonal
                    inverse couples the whole column, so lattice tiles
                    would alias in k; sheets are exact because invtri is
                    column-local horizontally)

    nsamples > 1 averages over that many model steps (time-averaged
    annual matrices are the normal TMM product); the circulation is
    advanced with model.step between samples.
    """
    g = model.g
    cfg = model.cfg.ocean
    grid = model.params.grid
    km, jmt, imt = grid.km, grid.jmt, grid.imt
    dtype = model.tmask.dtype
    tiles = torch.as_tensor(
        make_tiles(km, jmt, imt, spacing, cyclic=model.cyclic),
        dtype=dtype, device=model.device) * model.tmask[None]
    ntile = tiles.shape[0]
    c2dtts = 2.0 * cfg.dtts
    zsurf = torch.zeros((ntile, jmt, imt), dtype=dtype, device=model.device)
    sheets = torch.eye(km, dtype=dtype, device=model.device)[
        :, :, None, None] * model.tmask[None]
    zsheet = torch.zeros((km, jmt, imt), dtype=dtype, device=model.device)

    def sweep(state):
        u_tau = model.full_velocity(state.u, state.psi0)
        vet, vnt, vbt, *_ = adv_vel(u_tau[0], u_tau[1], g, model.cyclic)
        out = tracer_step(tiles, tiles, vet, vnt, vbt, zsurf, zsurf, None,
                          model.diff_cbt, model.kmt, model.tmask, g,
                          c2dtts, "centered", 0.0, model.cyclic)
        aexp = (out - tiles) / c2dtts
        aimp = invtri_columns(sheets, zsheet, zsheet, model.diff_cbt,
                              c2dtts * g.dtxcel, model.kmt, model.tmask,
                              g.dztr, g.dztur, g.dztlr, 1.0)
        return aexp, aimp

    aexp_acc = aimp_acc = None
    for _ in range(nsamples):
        aexp, aimp = sweep(state)
        aexp_acc = aexp if aexp_acc is None else aexp_acc + aexp
        aimp_acc = aimp if aimp_acc is None else aimp_acc + aimp
        if nsamples > 1:
            state = model.step(state, forcing)
    return ((aexp_acc / nsamples).cpu().numpy(),
            (aimp_acc / nsamples).cpu().numpy(), tiles.cpu().numpy())


def tiles_to_sparse(a_tiles, tiles, tmask, spacing=(3, 5, 5),
                    cyclic=True):
    """Convert per-tile dense responses to a scipy CSR matrix over the
    PHYSICAL ocean points (matrix.F MATRIX_WRITE's offline product;
    duplicated cyclic boundary columns are excluded, zonal windows wrap
    across the seam).  NumPy arrays in, host-side.

    For each impulse point p in tile n, its matrix COLUMN is the
    response a_tiles[n] restricted to the stencil footprint around p
    (responses from distinct impulses in one tile cannot overlap by
    construction of the spacing).
    """
    from scipy.sparse import lil_matrix

    km, jmt, imt = tmask.shape
    sk, sj, si = spacing
    nphys = imt - 2 if cyclic else imt
    wet = tmask > 0
    phys = np.ones((km, jmt, imt), dtype=bool)
    if cyclic:
        phys[..., 0] = False
        phys[..., imt - 1] = False
    wetp = wet & phys
    idx = -np.ones((km, jmt, imt), dtype=np.int64)
    idx[wetp] = np.arange(int(wetp.sum()))
    nwet = int(wetp.sum())
    A = lil_matrix((nwet, nwet))

    hk, hj, hi = sk // 2, sj // 2, si // 2
    for n in range(a_tiles.shape[0]):
        resp = a_tiles[n]
        pts = np.argwhere((tiles[n] > 0) & wetp)
        for (k, j, i) in pts:
            col = idx[k, j, i]
            k0, k1 = max(0, k - hk), min(km, k + hk + 1)
            j0, j1 = max(0, j - hj), min(jmt, j + hj + 1)
            if cyclic:
                iw = 1 + (np.arange(i - hi, i + hi + 1) - 1) % nphys
            else:
                iw = np.arange(max(0, i - hi), min(imt, i + hi + 1))
            sub = resp[k0:k1, j0:j1][..., iw]
            subw = wetp[k0:k1, j0:j1][..., iw]
            rows = idx[k0:k1, j0:j1][..., iw][subw]
            vals = sub[subw]
            nz = vals != 0.0
            A[rows[nz], col] = vals[nz]
    return A.tocsr()


def sheets_to_sparse_vertical(a_sheets, tmask, cyclic=True):
    """Implicit-operator CSR from per-level sheet responses: invtri is
    column-local, so the column for point (kc, j, i) is the k-profile
    a_sheets[kc, :, j, i].  Same physical-point indexing as
    tiles_to_sparse."""
    from scipy.sparse import coo_matrix

    km, jmt, imt = tmask.shape
    wet = tmask > 0
    if cyclic:
        wet = wet.copy()
        wet[..., 0] = False
        wet[..., imt - 1] = False
    idx = -np.ones((km, jmt, imt), dtype=np.int64)
    idx[wet] = np.arange(int(wet.sum()))
    nwet = int(wet.sum())

    rows, cols, vals = [], [], []
    for kc in range(km):
        for kr in range(km):
            both = wet[kc] & wet[kr]
            v = a_sheets[kc, kr][both]
            nz = v != 0.0
            rows.append(idx[kr][both][nz])
            cols.append(idx[kc][both][nz])
            vals.append(v[nz])
    return coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(nwet, nwet)).tocsr()
