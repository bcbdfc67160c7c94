"""Barotropic streamfunction mode (torch).

Port of the 5-point path of ``uvic_tpu.models.ocean.tropic``
(source/mom/tropic.F, the 1994 Goldberg finite-difference stream
function formulation).  The forcing curl (``sfforc``, tropic.F:298-395)
runs per step on the device; the 5-point operator coefficients
(``sfc5pt``, tropic.F:397-557) depend only on the grid, hr and
1/c2dtsf, so with explicit Coriolis (acor=0) they are built once on the
host at unit timestep.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.solvers import IslandIndex
from ...ops.stencil import E, N

# partial-difference coefficient tables (tropic.F:350-369)
_CDDXU = {(0, 0): -0.5, (0, 1): -0.5, (1, 0): 0.5, (1, 1): 0.5}
_CDDYU = {(0, 0): -0.5, (0, 1): 0.5, (1, 0): -0.5, (1, 1): 0.5}
_CDDXT = {(-1, -1): -0.5, (-1, 0): -0.5, (0, -1): 0.5, (0, 0): 0.5}
_CDDYT = {(-1, -1): -0.5, (-1, 0): 0.5, (0, -1): -0.5, (0, 0): 0.5}


def sfforc(zu, dxu, dyu, csu):
    """Streamfunction forcing: discrete curl of the depth-averaged
    momentum forcing (tropic.F:298-395). zu is (2, jmt, imt)."""
    ustuff = zu[0] * (dxu[None, :] * csu[:, None])
    vstuff = zu[1] * dyu[:, None]
    forc = torch.zeros_like(ustuff)
    for (i1, j1), cy in _CDDYT.items():
        cx = _CDDXT[(i1, j1)]
        forc = forc - cy * torch.roll(ustuff, (-j1, -i1), dims=(0, 1)) \
            + cx * torch.roll(vstuff, (-j1, -i1), dims=(0, 1))
    forc[0, :] = 0.0
    forc[-1, :] = 0.0
    forc[:, 0] = 0.0
    forc[:, -1] = 0.0
    return forc


def sfc5pt_unit(dxu, dyu, csu, hr):
    """5-point operator coefficients at c2dtsf=1 with explicit Coriolis
    (tropic.F:397-557).  Returns a (3, 3, jmt, imt) NumPy array indexed
    [dj+1, di+1]; the operator is cf/c2dtsf."""
    jmt, imt = hr.shape
    ustuff = (dxu[None, :] * csu[:, None]) * hr / dyu[:, None]
    vstuff = dyu[:, None] * hr / (dxu[None, :] * csu[:, None])

    def shifted(a, i2, j2):
        out = np.zeros_like(a)
        # value at (i+i2, j+j2) for interior (j,i)
        out[1:jmt - 1, 1:imt - 1] = a[1 + j2:jmt - 1 + j2,
                                      1 + i2:imt - 1 + i2]
        return out

    cf = np.zeros((3, 3, jmt, imt))
    for (i1, j1), cyu in _CDDYU.items():
        for (i2, j2), cyt in _CDDYT.items():
            cf[j1 + j2 + 1, 1] += cyu * cyt * shifted(ustuff, i2, j2)
    for (i1, j1), cxu in _CDDXU.items():
        for (i2, j2), cxt in _CDDXT.items():
            cf[1, i1 + i2 + 1] += cxu * cxt * shifted(vstuff, i2, j2)
    return cf


def tropic_step(zu, psi0, psi1, ptd_hist, ptdb_hist, isl: IslandIndex,
                dxu, dyu, csu, c2dtsf, tolrsf, mxscan, leapfrog: bool,
                solver, cyclic=True, filt=None):
    """Solve for the change in streamfunction and update the two psi time
    levels (tropic.F:127-293).

    solver : callable (guess, forc, c2dtsf, tol) -> (dpsi, iters), the
             island-constrained CG of ``ops/cg_kernel.py``
    filt   : optional ZonalFilter for high-latitude filtering of the
             forcing (filz, tropic.F:136-141).
    Returns (psi0_new, psi1_new, ptd_new, ptdb_new, iterations,
    converged).
    """
    forc = sfforc(zu, dxu, dyu, csu)
    if filt is not None:
        forc = filt(forc)

    # initial guess extrapolated from the last two solutions
    guess = (1.0 if leapfrog else 0.5) * (2.0 * ptd_hist - ptdb_hist)
    if cyclic:
        guess[:, 0] = guess[:, -2]
        guess[:, -1] = guess[:, 1]

    ptd, iters = solver(guess, forc, c2dtsf, tolrsf)

    # normalize psi to zero on the main land mass (tropic.F:233-237)
    if isl.nisle > 0 and isl.imain >= 0:
        main_sum = torch.where(isl.perim_id == isl.imain, ptd,
                               torch.zeros_like(ptd))
        dpsi1 = torch.sum(main_sum) / isl.counts[isl.imain]
        ptd = torch.where(isl.ocean_mask > 0, ptd - dpsi1, ptd)

    # psi level update (tropic.F:256-270) and the solution history for
    # the next step's guess (tropic.F:275-293)
    ptd_save = ptd if leapfrog else 2.0 * ptd
    return (psi1 + ptd, psi0, ptd_save, ptd_hist, iters,
            iters < mxscan)


def ext_mode_velocity(psi, hr, dxu2r, dyu2r, csur):
    """External-mode velocity from the streamfunction (loadmw.F:624-640
    add_ext_mode): uext = -(d psi / dy)/H, vext = (d psi / dx)/(H cos)
    on the B-grid via the two diagonal differences."""
    diag1 = N(E(psi)) - psi
    diag0 = N(psi) - E(psi)
    uext = -(diag1 + diag0) * dyu2r[:, None] * hr
    vext = (diag1 - diag0) * dxu2r[None, :] * csur[:, None] * hr
    return uext, vext
