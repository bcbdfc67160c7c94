"""High-latitude zonal filtering (O_firfil, O_fourfil), torch.

Port of ``uvic_tpu.ops.filters``.  The reference stabilizes the
converging meridians by filtering tracers, velocities and the barotropic
forcing poleward of ~69 deg (tracer.F:980-993, clinic.F:480-493,
tropic.F:136-141), either with ``numflt(j)`` passes of a masked 3-point
[.25,.5,.25] smoother applied twice per pass (FIR, filfir.F) or by
truncating a cosine, sine or full cyclic series within each ocean
segment of a row (Fourier, filt.F/filuv.F/filtr.F).  Both are linear
with static coefficients per (level, row), so one ``imt x imt`` matrix
per filtered (level, row) is built on the host and the whole filter is
one batched matmul in full float32 (see ``uvic_tpu_torch/__init__.py``).

Filter parameters follow setcom.F:37-132: filtering starts poleward of
+-69.3 deg, the pass count / wavenumber scale is cos(lat)/cos(67.5 deg),
FIR passes capped at imt/4.
"""

from __future__ import annotations

import numpy as np
import torch

RJFRST = -87.3
RJFT0 = 67.5
RJFT1 = 69.3


def filter_passes(lat_deg: np.ndarray, imt: int,
                  rjft0=RJFT0, rjft1=RJFT1, rjfrst=RJFRST) -> np.ndarray:
    """Per-row FIR pass counts (0 = unfiltered), setcom.F:101-132."""
    refcos = np.cos(np.deg2rad(rjft0))
    npass = np.maximum(1, (refcos / np.maximum(
        np.cos(np.deg2rad(lat_deg)), 1e-10)).astype(np.int64))
    numfmx = imt // 4
    npass = np.minimum(npass, numfmx)
    active = (np.abs(lat_deg) >= rjft1) & (lat_deg >= rjfrst)
    return np.where(active, npass, 0)


class ZonalFilter:
    """Precomputed zonal filter: ``out[..., rows, :] = M @ in[..., rows, :]``.

    rows : (R,) static row indices that get filtered
    mats : (lead..., R, imt, imt) one matrix per (lead-index, row);
           lead dims broadcast against the field's leading dims.
    """

    def __init__(self, rows: np.ndarray, mats: np.ndarray, dtype, device):
        self.rows = torch.as_tensor(np.asarray(rows, np.int64),
                                    device=device)
        self.mats = torch.as_tensor(np.asarray(mats), dtype=dtype,
                                    device=device)

    def __call__(self, field):
        if self.rows.numel() == 0:
            return field
        sub = field[..., self.rows, :]
        out = field.clone()
        out[..., self.rows, :] = torch.matmul(self.mats,
                                              sub[..., None])[..., 0]
        return out


def _setbcx_matrix(imt: int, cyclic: bool) -> np.ndarray:
    B = np.eye(imt)
    B[0, :] = 0.0
    B[-1, :] = 0.0
    if cyclic:
        B[0, imt - 2] = 1.0
        B[-1, 1] = 1.0
    return B


def _fir_row_matrix(m: np.ndarray, n: int, kind: str,
                    cyclic: bool) -> np.ndarray:
    """Matrix of ``n`` FIR passes (2 smooths each, filfir.F:50-97) on a
    row with {0,1} mask ``m``, incl. the masked-source conservation term
    of the symmetric variant and the setbcx wrap after each smooth."""
    imt = m.size
    i = np.arange(imt)
    ip, iw = (i + 1) % imt, (i - 1) % imt
    S = np.zeros((imt, imt))
    if kind == "symmetric":
        S[i, i] = m * (1.0 - 0.25 * (m[iw] + m[ip]))
        np.add.at(S, (i, iw), 0.25 * m)
        np.add.at(S, (i, ip), 0.25 * m)
    else:
        S[i, i] = 0.5 * m
        np.add.at(S, (i, iw), 0.25 * m)
        np.add.at(S, (i, ip), 0.25 * m)
    M = _setbcx_matrix(imt, cyclic) @ S
    P = np.linalg.matrix_power(M, 2 * int(n))
    D = np.diag(m)
    return D @ P @ D + np.eye(imt) - D


def build_fir_filter(mask, npass_j, kind: str = "symmetric",
                     cyclic: bool = True, dtype=torch.float64,
                     device="cpu") -> ZonalFilter:
    """ZonalFilter implementing filfir.F for mask (..., jmt, imt)."""
    mask = np.asarray(mask, np.float64)
    npass_j = np.asarray(npass_j)
    rows = np.nonzero(npass_j > 0)[0]
    imt = mask.shape[-1]
    lead = mask.shape[:-2]
    mats = np.empty(lead + (rows.size, imt, imt))
    for idx in np.ndindex(lead):
        for r, j in enumerate(rows):
            mats[idx + (r,)] = _fir_row_matrix(
                mask[idx + (int(j),)], int(npass_j[j]), kind, cyclic)
    return ZonalFilter(rows, mats, dtype, device)


def fir_filter(field, mask, npass_j, kind: str = "symmetric",
               cyclic: bool = True):
    """The FIR smoother of filfir.F applied as unrolled passes: the
    reference form that ``build_fir_filter``'s matrices are held
    against.  ``mask`` broadcasts against ``field`` (..., jmt, imt);
    row j takes ``npass_j[j]`` double passes."""
    from .stencil import E, W, setbcx
    npass_j = np.asarray(npass_j)
    max_pass = int(npass_j.max()) if npass_j.size else 0
    if max_pass == 0:
        return field

    def smooth(t):
        if kind == "symmetric":
            s = mask * (0.25 * (W(t) + E(t))
                        + t * (1.0 - 0.25 * (W(mask) + E(mask))))
        else:
            s = mask * (0.25 * W(t) + 0.5 * t + 0.25 * E(t))
        return setbcx(s, cyclic)

    out = field * mask
    for p in range(max_pass):
        row_on = torch.as_tensor(npass_j > p, dtype=out.dtype,
                                 device=out.device).reshape(-1, 1)
        sm = smooth(smooth(out))
        out = row_on * sm + (1.0 - row_on) * out
    return torch.where(mask > 0, out, field)


def _circular_segments(oc: np.ndarray, cyclic: bool):
    """Maximal ocean runs over interior columns 1..imt-2 of a {0,1} row,
    joined across the zonal seam when cyclic.  Returns (full_row, [ids])
    where ids are column-index arrays in circular order."""
    imt = oc.size
    inter = np.arange(1, imt - 1)
    vals = oc[inter].astype(bool)
    if not vals.any():
        return False, []
    if vals.all():
        return True, [inter]
    n = vals.size
    start = None
    segs = []
    order = np.arange(n)
    if cyclic and vals[0] and vals[-1]:
        # rotate so position 0 is a land point -> no wrap to handle
        k = int(np.nonzero(~vals)[0][0])
        order = np.roll(order, -k)
    v = vals[order]
    for p in range(n):
        if v[p] and start is None:
            start = p
        if start is not None and (not v[p] or p == n - 1):
            end = p if v[p] else p - 1
            segs.append(inter[order[start:end + 1]])
            start = None
    return False, segs


def _trunc_projection(im: int, n: int, mode: str) -> np.ndarray:
    """Projection matrix keeping ``n`` waves of a cosine (deriv-0 ends),
    sine (zero ends) or full cyclic series on ``im`` points (filtr.F
    header semantics)."""
    if im == 1:
        return np.eye(1)
    i = np.arange(im)
    if mode == "cosine":
        if n >= im - 1:
            return np.eye(im)
        V = np.cos(np.pi * np.outer(i, np.arange(im)) / (im - 1))
        Vi = np.linalg.inv(V)
        return V[:, :n + 1] @ Vi[:n + 1, :]
    if mode == "sine":
        if n >= im:
            return np.eye(im)
        V = np.sin(np.pi * np.outer(i + 1, np.arange(1, im + 1)) / (im + 1))
        Vi = np.linalg.inv(V)
        return V[:, :n] @ Vi[:n, :]
    # full cyclic: spectral truncation |k| <= n
    if n >= im // 2:
        return np.eye(im)
    F = np.fft.fft(np.eye(im))
    freqs = np.fft.fftfreq(im, d=1.0 / im)
    keep = (np.abs(freqs) <= n).astype(np.float64)
    return np.real(np.fft.ifft(keep[:, None] * F, axis=0)).T


def _fourier_row_matrix(m: np.ndarray, cosfac: float, mode: str,
                        cyclic: bool) -> np.ndarray:
    imt = m.size
    F = np.eye(imt)
    full, segs = _circular_segments(m > 0, cyclic)
    for ids in segs:
        im = ids.size
        if full and cyclic:
            n = int(round(im * cosfac * 0.5))
            P = _trunc_projection(im, n, "cyclic")
        else:
            n = int(round(im * cosfac))
            P = _trunc_projection(im, n, mode)
        F[np.ix_(ids, ids)] = P
    return F


def build_fourier_filter(mask, lat_deg, kind: str = "symmetric",
                         cyclic: bool = True, dtype=torch.float64,
                         device="cpu", rjft0=RJFT0, rjft1=RJFT1,
                         rjfrst=RJFRST) -> ZonalFilter:
    """ZonalFilter implementing filt.F/filuv.F Fourier truncation.

    kind 'symmetric' -> cosine series (tracers, psi forcing, filt.F m=1);
    kind 'asymmetric' -> sine series (velocities, filuv.F m=2); land-free
    cyclic rows use the full series (m=3) at half the wave count.
    """
    mask = np.asarray(mask, np.float64)
    lat_deg = np.asarray(lat_deg)
    active = (np.abs(lat_deg) >= rjft1) & (lat_deg >= rjfrst)
    rows = np.nonzero(active)[0]
    imt = mask.shape[-1]
    lead = mask.shape[:-2]
    refcos = np.cos(np.deg2rad(rjft0))
    mode = "cosine" if kind == "symmetric" else "sine"
    mats = np.empty(lead + (rows.size, imt, imt))
    for idx in np.ndindex(lead):
        for r, j in enumerate(rows):
            cosfac = max(np.cos(np.deg2rad(lat_deg[j])), 1e-10) / refcos
            mats[idx + (r,)] = _fourier_row_matrix(
                mask[idx + (int(j),)], cosfac, mode, cyclic)
    return ZonalFilter(rows, mats, dtype, device)


def build_hlat_filter(method: str, mask, lat_deg, imt: int,
                      kind: str = "symmetric", cyclic: bool = True,
                      dtype=torch.float64, device="cpu") -> ZonalFilter:
    """Filter factory: method 'fir' (O_firfil) or 'fourier' (O_fourfil)
    for mask (..., jmt, imt)."""
    if method == "fourier":
        return build_fourier_filter(mask, lat_deg, kind, cyclic, dtype,
                                    device)
    npass = filter_passes(np.asarray(lat_deg), imt)
    return build_fir_filter(mask, npass, kind, cyclic, dtype, device)
