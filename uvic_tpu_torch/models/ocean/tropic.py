"""Barotropic streamfunction mode (torch).

Port of ``uvic_tpu.models.ocean.tropic`` (source/mom/tropic.F, the 1994
Goldberg finite-difference stream function formulation).  The forcing
curl (``sfforc``, tropic.F:298-395) runs per step on the device; the 5-
and 9-point operator coefficients (``sfc5pt``, tropic.F:397-557;
``sfc9pt``, :560-717) depend only on the grid, hr and 1/c2dtsf, so they
are built once on the host at unit timestep, with the implicit Coriolis
part (acor != 0), which does not depend on the timestep, beside them.
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


def _shifted(a, i2, j2):
    """value at (i+i2, j+j2) for interior (j,i), zero on the border."""
    jmt, imt = a.shape
    out = np.zeros_like(a)
    out[1:jmt - 1, 1:imt - 1] = a[1 + j2:jmt - 1 + j2, 1 + i2:imt - 1 + i2]
    return out


def _acor_part(hr, f, acor, cf):
    """The implicit Coriolis coefficients (tropic.F sfc5pt/sfc9pt acor
    branches), added into ``cf`` (3, 3, jmt, imt)."""
    ustuff_a = acor * hr * (-f)
    vstuff_a = acor * hr * (+f)
    for (i1, j1), cxu in _CDDXU.items():
        cyu = _CDDYU[(i1, j1)]
        for (i2, j2), cyt in _CDDYT.items():
            cxt = _CDDXT[(i2, j2)]
            cf[j1 + j2 + 1, i1 + i2 + 1] -= (
                cxu * cyt * _shifted(ustuff_a, i2, j2)
                + cyu * cxt * _shifted(vstuff_a, i2, j2))
    return cf


def sfc9pt_unit(dxu, dyu, csu, hr, f=None, acor=0.0):
    """9-point operator coefficients at c2dtsf=1 (sfc9pt,
    tropic.F:560-717): the exact discrete curl-of-response operator (no
    corner lumping).  Returns (cf, cf_acor) as ``sfc5pt_unit``."""
    ustuff = (dxu[None, :] * csu[:, None]) * hr / dyu[:, None]
    vstuff = dyu[:, None] * hr / (dxu[None, :] * csu[:, None])
    cf = np.zeros((3, 3) + hr.shape)
    for (i1, j1), cyu in _CDDYU.items():
        cxu = _CDDXU[(i1, j1)]
        for (i2, j2), cyt in _CDDYT.items():
            cxt = _CDDXT[(i2, j2)]
            cf[j1 + j2 + 1, i1 + i2 + 1] += (
                cyu * cyt * _shifted(ustuff, i2, j2)
                + cxu * cxt * _shifted(vstuff, i2, j2))
    cf_acor = np.zeros_like(cf)
    if acor != 0.0:
        _acor_part(hr, f, acor, cf_acor)
    return cf, cf_acor


def sfc5pt_unit(dxu, dyu, csu, hr, f=None, acor=0.0):
    """5-point operator coefficients at c2dtsf=1 (tropic.F:397-557).

    Returns (cf, cf_acor), (3, 3, jmt, imt) NumPy arrays indexed
    [dj+1, di+1]: the operator is cf/c2dtsf + cf_acor, where cf_acor,
    the implicit Coriolis part, is zero unless acor != 0.
    """
    ustuff = (dxu[None, :] * csu[:, None]) * hr / dyu[:, None]
    vstuff = dyu[:, None] * hr / (dxu[None, :] * csu[:, None])
    cf = np.zeros((3, 3) + hr.shape)
    for (i1, j1), cyu in _CDDYU.items():
        for (i2, j2), cyt in _CDDYT.items():
            cf[j1 + j2 + 1, 1] += cyu * cyt * _shifted(ustuff, i2, j2)
    for (i1, j1), cxu in _CDDXU.items():
        for (i2, j2), cxt in _CDDXT.items():
            cf[1, i1 + i2 + 1] += cxu * cxt * _shifted(vstuff, i2, j2)
    cf_acor = np.zeros_like(cf)
    if acor != 0.0:
        # the reference's sfc5pt loops: the x terms of every (i1, j1),
        # then the y terms
        ustuff_a = acor * hr * (-f)
        vstuff_a = acor * hr * (+f)
        for (i1, j1), cxu in _CDDXU.items():
            for (i2, j2), cyt in _CDDYT.items():
                cf_acor[j1 + j2 + 1, i1 + i2 + 1] -= (
                    cxu * cyt * _shifted(ustuff_a, i2, j2))
        for (i1, j1), cyu in _CDDYU.items():
            for (i2, j2), cxt in _CDDXT.items():
                cf_acor[j1 + j2 + 1, i1 + i2 + 1] -= (
                    cyu * cxt * _shifted(vstuff_a, i2, j2))
    return cf, cf_acor


def checkerboard_weights(jmt, imt, dtype, device):
    """The checkerboard (-1)^(j+i) on the interior, zero on the border:
    the second null vector of the 9-point operator."""
    jj = torch.arange(jmt, device=device)[:, None]
    ii = torch.arange(imt, device=device)[None, :]
    w = (1 - 2 * ((jj + ii) % 2)).to(dtype)
    w[0, :] = 0.0
    w[-1, :] = 0.0
    w[:, 0] = 0.0
    w[:, -1] = 0.0
    return w


def tropic_step(zu, psi0, psi1, ptd_hist, ptdb_hist, isl: IslandIndex,
                dxu, dyu, csu, c2dtsf, tolrsf, mxscan, leapfrog: bool,
                solver, cyclic=True, filt=None, euler2=False,
                save_ptd=True, npt=5, solve_c2dtsf=None):
    """Solve for the change in streamfunction and update the two psi time
    levels (tropic.F:127-293).

    solver : callable (guess, forc, c2dtsf, tol) -> (dpsi, iters), the
             island-constrained CG of ``ops/cg_kernel.py``; it is
             called with ``solve_c2dtsf`` when given (1 for a solver
             built on the step's whole operator cf/c2dtsf + cf_acor),
             else with c2dtsf
    filt   : optional ZonalFilter for high-latitude filtering of the
             forcing (filz, tropic.F:136-141)
    euler2 : the second Euler-backward pass (psi(1) overwritten, psi(2)
             kept); ``save_ptd`` False on the first pass skips the
             solution history
    npt    : 5 or 9; the 9-point operator annihilates the checkerboard
             too, which is deflated from the forcing, guess and solution
    Returns (psi0_new, psi1_new, ptd_new, ptdb_new, iterations,
    converged).
    """
    forc = sfforc(zu, dxu, dyu, csu)
    if filt is not None:
        forc = filt(forc)
    if npt == 9:
        w = checkerboard_weights(*forc.shape, forc.dtype, forc.device)
        ww = torch.sum(w * w)

        def deflate(x):
            return x - (torch.sum(x * w) / ww) * w

        forc = deflate(forc)
    else:
        def deflate(x):
            return x

    # initial guess extrapolated from the last two solutions
    guess = deflate((1.0 if leapfrog else 0.5) * (2.0 * ptd_hist - ptdb_hist))
    if cyclic:
        guess[:, 0] = guess[:, -2]
        guess[:, -1] = guess[:, 1]

    ptd, iters = solver(guess, forc,
                        c2dtsf if solve_c2dtsf is None else solve_c2dtsf,
                        tolrsf)
    ptd = deflate(ptd)

    # normalize psi to zero on the main land mass (tropic.F:233-237)
    if isl.nisle > 0 and isl.imain >= 0:
        main_sum = torch.where(isl.perim_id == isl.imain, ptd,
                               torch.zeros_like(ptd))
        dpsi1 = torch.sum(main_sum) / isl.counts[isl.imain]
        ptd = torch.where(isl.ocean_mask > 0, ptd - dpsi1, ptd)

    # psi level update (tropic.F:256-270): the second Euler-backward
    # pass overwrites psi(1) and keeps psi(2)
    psi0_new = psi1 + ptd
    psi1_new = psi1 if euler2 else psi0
    converged = iters < mxscan
    if not save_ptd:
        return psi0_new, psi1_new, ptd_hist, ptdb_hist, iters, converged
    # the solution history for the next step's guess (tropic.F:275-293)
    ptd_save = ptd if leapfrog else 2.0 * ptd
    return psi0_new, psi1_new, ptd_save, ptd_hist, iters, converged


def ext_mode_velocity(psi, hr, dxu2r, dyu2r, csur):
    """External-mode velocity from the streamfunction (loadmw.F:624-640
    add_ext_mode): uext = -(d psi / dy)/H, vext = (d psi / dx)/(H cos)
    on the B-grid via the two diagonal differences."""
    diag1 = N(E(psi)) - psi
    diag0 = N(psi) - E(psi)
    uext = -(diag1 + diag0) * dyu2r[:, None] * hr
    vext = (diag1 - diag0) * dxu2r[None, :] * csur[:, None] * hr
    return uext, vext
