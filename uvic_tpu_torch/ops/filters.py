"""High-latitude zonal filtering, FIR variant (O_firfil), torch.

Port of the FIR path of ``uvic_tpu.ops.filters``.  The reference
stabilizes the converging meridians by filtering tracers, velocities and
the barotropic forcing poleward of ~69 deg (tracer.F:980-993,
clinic.F:480-493, tropic.F:136-141) with ``numflt(j)`` passes of a
masked 3-point [.25,.5,.25] smoother applied twice per pass (filfir.F).
The filter is linear with static coefficients per (level, row), so one
``imt x imt`` matrix per filtered (level, row) is built on the host and
the whole filter is one batched matmul in full float32 (see
``uvic_tpu_torch/__init__.py``).

Filter parameters follow setcom.F:37-132: filtering starts poleward of
+-69.3 deg, the pass count scale is cos(lat)/cos(67.5 deg), passes
capped at imt/4.
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


def build_hlat_filter(method: str, mask, lat_deg, imt: int,
                      kind: str = "symmetric", cyclic: bool = True,
                      dtype=torch.float64, device="cpu") -> ZonalFilter:
    """FIR high-latitude filter (filfir.F) for mask (..., jmt, imt)."""
    if method != "fir":
        raise NotImplementedError(f"hlat_filter {method!r} is not ported")
    npass_j = filter_passes(np.asarray(lat_deg), imt)
    mask = np.asarray(mask, np.float64)
    rows = np.nonzero(npass_j > 0)[0]
    lead = mask.shape[:-2]
    mats = np.empty(lead + (rows.size, imt, imt))
    for idx in np.ndindex(lead):
        for r, j in enumerate(rows):
            mats[idx + (r,)] = _fir_row_matrix(
                mask[idx + (int(j),)], int(npass_j[j]), kind, cyclic)
    return ZonalFilter(rows, mats, dtype, device)
