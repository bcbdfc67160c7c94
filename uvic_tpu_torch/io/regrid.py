"""Data-grid utilities: regridding and extrapolation fill.

The source/common/util.F data-preparation trio the readers rely on:

- ``ctf`` (coarse-to-fine, util.F:81-180): bilinear interpolation of a
  data-grid field onto model points, periodic in longitude.
- ``ftc`` (fine-to-coarse, util.F:425-520): area-box averaging of a
  finer field onto a coarser grid.
- ``extrap`` (util.F:642-720): iterative Poisson fill of masked cells
  from their unmasked neighbors, so land values of an ocean dataset
  (or vice versa) are physically extended before masking/regridding.

All host-side NumPy (one-time data preparation); the port's own copy
of ``uvic_tpu.io.regrid``, unchanged.
"""

from __future__ import annotations

import numpy as np


def extrap_fill(field, valid, max_iter: int = 200, tol: float = 1e-4,
                cyclic: bool = True):
    """Fill cells where ``valid`` is False by Jacobi relaxation of the
    Laplace equation with the valid cells as Dirichlet data
    (util.F:642-720 `extrap`).  Returns a filled copy."""
    f = np.array(field, dtype=np.float64)
    valid = np.asarray(valid, dtype=bool)
    if valid.all():
        return f
    # initialize the fill with the mean of valid data
    f[~valid] = f[valid].mean() if valid.any() else 0.0
    scale = max(np.abs(f[valid]).max(), 1e-30) if valid.any() else 1.0
    for _ in range(max_iter):
        if cyclic:
            e = np.roll(f, -1, axis=-1)
            w = np.roll(f, 1, axis=-1)
        else:
            e = np.concatenate([f[..., 1:], f[..., -1:]], axis=-1)
            w = np.concatenate([f[..., :1], f[..., :-1]], axis=-1)
        n = np.concatenate([f[..., 1:, :], f[..., -1:, :]], axis=-2)
        s = np.concatenate([f[..., :1, :], f[..., :-1, :]], axis=-2)
        avg = 0.25 * (e + w + n + s)
        new = np.where(valid, f, avg)
        change = np.abs(new - f)[~valid].max() if (~valid).any() else 0.0
        f = new
        if change < tol * scale:
            break
    return f


def ctf(src, src_lon, src_lat, dst_lon, dst_lat, cyclic: bool = True):
    """Coarse-to-fine bilinear interpolation (util.F:81-180 `ctf`):
    sample ``src`` (..., ny, nx) defined at (src_lat, src_lon) cell
    centers at the destination points, periodic in longitude."""
    src = np.asarray(src, dtype=np.float64)
    slon = np.asarray(src_lon, dtype=np.float64) % 360.0
    slat = np.asarray(src_lat, dtype=np.float64)
    dlon = np.asarray(dst_lon, dtype=np.float64) % 360.0
    dlat = np.asarray(dst_lat, dtype=np.float64)

    order = np.argsort(slon)
    slon = slon[order]
    src = src[..., :, order]

    nx = slon.size
    # longitude: periodic bracketing
    i1 = np.searchsorted(slon, dlon, side="right") - 1
    i1w = np.mod(i1, nx)
    i2 = np.mod(i1w + 1, nx)
    gap = np.mod(slon[i2] - slon[i1w], 360.0)
    gap = np.where(gap == 0.0, 360.0, gap)
    wx = np.mod(dlon - slon[i1w], 360.0) / gap
    if not cyclic:
        wx = np.clip(wx, 0.0, 1.0)

    # latitude: clamped bracketing
    j1 = np.clip(np.searchsorted(slat, dlat, side="right") - 1,
                 0, slat.size - 2)
    j2 = j1 + 1
    denom = slat[j2] - slat[j1]
    wy = np.clip((dlat - slat[j1]) / np.where(denom == 0, 1, denom),
                 0.0, 1.0)

    WX = wx[None, :]
    WY = wy[:, None]
    J1 = j1[:, None]
    J2 = j2[:, None]
    I1 = i1w[None, :]
    I2 = i2[None, :]
    return ((1 - WY) * ((1 - WX) * src[..., J1, I1]
                        + WX * src[..., J1, I2])
            + WY * ((1 - WX) * src[..., J2, I1]
                    + WX * src[..., J2, I2]))


def ftc(src, src_lon, src_lat, dst_lon_edges, dst_lat_edges):
    """Fine-to-coarse box averaging (util.F:425-520 `ftc`): mean of all
    source cells whose centers fall in each destination cell."""
    src = np.asarray(src, dtype=np.float64)
    slon = np.asarray(src_lon, dtype=np.float64) % 360.0
    slat = np.asarray(src_lat, dtype=np.float64)
    lon_e = np.asarray(dst_lon_edges, dtype=np.float64) % 360.0
    lat_e = np.asarray(dst_lat_edges, dtype=np.float64)
    # monotonic unwrapped longitude edges
    lon_u = np.asarray(dst_lon_edges, dtype=np.float64)
    ii = np.searchsorted(lon_u, np.where(slon < lon_u[0],
                                         slon + 360.0, slon)) - 1
    jj = np.searchsorted(lat_e, slat) - 1
    ny, nx = lat_e.size - 1, lon_u.size - 1
    ok = (ii >= 0)[None, :] & (ii < nx)[None, :] \
        & (jj >= 0)[:, None] & (jj < ny)[:, None]
    flat = np.clip(jj, 0, ny - 1)[:, None] * nx \
        + np.clip(ii, 0, nx - 1)[None, :]
    sums = np.bincount(flat[ok].ravel(),
                       weights=src[ok].ravel(), minlength=ny * nx)
    cnts = np.bincount(flat[ok].ravel(), minlength=ny * nx)
    out = np.divide(sums, np.maximum(cnts, 1))
    out[cnts == 0] = np.nan
    return out.reshape(ny, nx)
