"""Barotropic surface-pressure modes: rigid-lid and implicit free
surface, torch.

Port of ``uvic_tpu.models.ocean.surfpress``: the reference's alternative
external-mode formulation (O_rigid_lid_surface_pressure /
O_implicit_free_surface), source/mom/bardiv.F (uncorrected barotropic
velocities + divergence rhs, Smith/Dukowicz/Malone 1992 and
Dukowicz/Smith 1993), source/mom/tropic.F:718-816 (spforc) and :816-936
(spc9pt), and the null-space utilities poisson.F:141-238 (checkerboard)
and :384-416 (zero_level).

Prognostic external-mode state here is (ps at two time levels, pguess,
ubar, ubarm1) instead of the streamfunction; the elliptic problem is a
9-point T-cell Laplacian with NO island constraints (bardiv.F nislsp=0)
solved by the same preconditioned CG as the streamfunction path
(``ops/cg_kernel.CGSolver`` on the whole operator, built by the model).
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import GRAV
from ...ops.solvers import border
from .tropic import _CDDXT, _CDDXU, _CDDYT, _CDDYU


def _sh(a, i1, j1):
    """value at (i+i1, j+j1) for every (j, i) (cyclic roll; borders are
    zeroed by the callers)."""
    return torch.roll(a, (-j1, -i1), dims=(0, 1))


def spforc(uhat, dxu, dyu, csu, h):
    """Divergence of depth-weighted barotropic velocities at T cells
    (tropic.F:718-816 spforc)."""
    ustuff = h * uhat[0] * dyu[:, None]
    vstuff = h * uhat[1] * (dxu[None, :] * csu[:, None])
    forc = torch.zeros_like(ustuff)
    for (i1, j1), cx in _CDDXT.items():
        cy = _CDDYT[(i1, j1)]
        forc = forc + cx * _sh(ustuff, i1, j1) + cy * _sh(vstuff, i1, j1)
    forc[0, :] = 0.0
    forc[-1, :] = 0.0
    forc[:, 0] = 0.0
    forc[:, -1] = 0.0
    return forc


def spc9pt_unit(dxu, dyu, csu, h):
    """9-point surface-pressure operator coefficients (tropic.F:816-936
    spc9pt); depends only on grid + depth, so precomputed once.  Returns
    (3, 3, jmt, imt) NumPy array indexed [dj+1, di+1]."""
    jmt, imt = h.shape
    ustuff = np.zeros_like(h)
    vstuff = np.zeros_like(h)
    ustuff[:jmt - 1, :imt - 1] = (
        h[:jmt - 1, :imt - 1] * dyu[:jmt - 1, None]
        / (dxu[None, :imt - 1] * csu[:jmt - 1, None]))
    vstuff[:jmt - 1, :imt - 1] = (
        h[:jmt - 1, :imt - 1] * dxu[None, :imt - 1]
        * csu[:jmt - 1, None] / dyu[:jmt - 1, None])

    def shifted(a, i2, j2):
        out = np.zeros_like(a)
        out[1:jmt - 1, 1:imt - 1] = a[1 + j2:jmt - 1 + j2,
                                      1 + i2:imt - 1 + i2]
        return out

    cf = np.zeros((3, 3, jmt, imt))
    for (i1, j1), cxu in _CDDXU.items():
        cyu = _CDDYU[(i1, j1)]
        for (i2, j2), cxt in _CDDXT.items():
            cyt = _CDDYT[(i2, j2)]
            cf[j1 + j2 + 1, i1 + i2 + 1] += (
                cxu * cxt * shifted(ustuff, i2, j2)
                + cyu * cyt * shifted(vstuff, i2, j2))
    return cf


def checkerboard_remove(x, ocean_mask):
    """Remove the red/black checkerboard null space of the rigid-lid
    operator (poisson.F:141-238): interior sums per parity class, ocean
    point counts, +-c correction at ocean points."""
    jmt, imt = x.shape
    jj = torch.arange(jmt, device=x.device)[:, None]
    ii = torch.arange(imt, device=x.device)[None, :]
    inter = torch.zeros_like(x)
    inter[1:-1, 1:-1] = 1.0
    red = ((jj + ii) % 2 == 0).to(x.dtype) * inter
    black = inter - red
    nred = torch.sum(red * ocean_mask)
    nblack = torch.sum(black * ocean_mask)
    c = 0.5 * (torch.sum(x * red) / nred - torch.sum(x * black) / nblack)
    corr = torch.where(red > 0, -c, c) * inter
    return torch.where(ocean_mask > 0, x + corr, x)


def zero_level(x, ocean_mask, dxt, dyt, cst):
    """Remove the area-weighted ocean mean (poisson.F:384-416)."""
    area = (dxt[None, :] * (cst * dyt)[:, None]) * ocean_mask
    area[0, :] = 0.0
    area[-1, :] = 0.0
    area[:, 0] = 0.0
    area[:, -1] = 0.0
    mean = torch.sum(x * area) / torch.sum(area)
    return torch.where(ocean_mask > 0, x - mean, x)


def surface_pressure_step(
        zu, ps0, ps1, ps1_eff, pguess, ubar, ubarm1_eff, solver, g, umask1,
        ocean_mask, c2dtsf, dtsf, tolr, leapfrog: bool, *,
        free_surface: bool, alph, gam, theta, acor=0.0, cori=None,
        eb_pass: int = 0, cyclic=True):
    """One external-mode step of the surface-pressure formulation
    (bardiv.F:1-380).

    ps0/ps1     : true tau / tau-1 surface pressure levels
    ps1_eff     : caller-selected effective tau-1 level (= ps1 on
                  leapfrog steps, ps0 on forward/mixing steps — the
                  functional analog of mom.F's pointer shuffles)
    ubarm1_eff  : effective tau-1 barotropic velocity (mom.F:163-167
                  copies ubar into ubarm1 at the start of mixing steps)
    solver      : callable (guess, forc, c2dtsf, tol) -> (ptd, iters)
                  on this step's whole 9-point operator (the unit
                  operator, plus the free-surface centre term of the
                  step's c2dtsf and apgr, bardiv.F:90-101), called with
                  c2dtsf = 1
    Returns (ps0_new, ps1_new, pguess_new, ubar_new, iters); the caller
    manages the ubarm1 state slot.
    """
    euler2 = eb_pass == 2

    # apgr = alph on leapfrog steps, theta on mixing steps (mom.F:160-162)
    apgr = alph if leapfrog else theta
    lf_t = 1.0 if leapfrog else 0.0

    # --- uncorrected barotropic velocities (bardiv.F:49-138) ----------
    factu = 0.5 * c2dtsf * g.csur[:, None]
    factv = 0.5 * c2dtsf * g.dyur[:, None]
    if acor != 0.0 and cori is not None:
        fx = acor * c2dtsf * cori
        fy = 1.0 / (1.0 + fx ** 2)
    else:
        fx = torch.zeros_like(ps0)
        fy = 1.0

    if euler2:
        # theta blend of the pressure guess and the tau level
        p = theta * pguess + (1.0 - theta) * ps0
    else:
        # gam blend of tau and (effective) tau-1; on forward steps
        # ps1_eff == ps0 so this reduces to the pure-tau gradient
        p = gam * ps0 + (1.0 - gam) * ps1_eff
    d1 = _sh(p, 1, 1) - p
    d2 = _sh(p, 1, 0) - _sh(p, 0, 1)

    utwid = zu[0] * c2dtsf - factu * (d1 + d2) * g.dxur[None, :]
    vtwid = zu[1] * c2dtsf - factv * (d1 - d2)
    uhat_u = fy * (utwid + fx * vtwid) + ubarm1_eff[0]
    uhat_v = fy * (vtwid - fx * utwid) + ubarm1_eff[1]
    if free_surface:
        uhat_u = uhat_u + ubar[0]
        uhat_v = uhat_v + ubar[1]
    uhat = torch.stack([border(uhat_u * umask1, cyclic),
                        border(uhat_v * umask1, cyclic)])

    # --- divergence rhs (bardiv.F:146-178) ----------------------------
    forc = spforc(uhat, g.dxu, g.dyu, g.csu, g.h) / (apgr * c2dtsf)
    if free_surface and euler2:
        fyc = (g.dyt * g.cst)[:, None] * g.dxt[None, :] / (
            GRAV * dtsf * c2dtsf * apgr)
        corr = fyc * (pguess - ps0)
        corr[0, :] = 0.0
        corr[-1, :] = 0.0
        forc = forc + corr
    forc = border(forc, cyclic)

    # --- initial guess for the pressure change (bardiv.F:181-202) -----
    ptd0 = torch.zeros_like(ps0) if euler2 else pguess - ps1_eff

    # --- 9-pt CG solve, no island constraints (bardiv.F:204-243) ------
    ptd, iters = solver(ptd0, forc, 1.0, tolr)

    if not free_surface:
        # rigid lid: remove checkerboard + mean null spaces
        ptd = border(checkerboard_remove(ptd, ocean_mask), cyclic)
        ptd = border(zero_level(ptd, ocean_mask, g.dxt, g.dyt, g.cst),
                     cyclic)

    # --- correct barotropic velocities (bardiv.F:258-305) -------------
    d1 = _sh(ptd, 1, 1) - ptd
    d2 = _sh(ptd, 1, 0) - _sh(ptd, 0, 1)
    tempu = uhat[0] - apgr * factu * (d1 + d2) * g.dxur[None, :]
    tempv = uhat[1] - apgr * factv * (d1 - d2)
    if free_surface:
        tempu = tempu - lf_t * ubar[0]
        tempv = tempv - lf_t * ubar[1]
    ubar_new = torch.stack([border(tempu * umask1, cyclic),
                            border(tempv * umask1, cyclic)])

    # --- surface pressure update (bardiv.F:307-369) --------------------
    if euler2:
        pnew = ptd + pguess
        pguess_new = 3.0 * (pnew - ps0) + ps1
        ps1_new, ps0_new = ps0, pnew
    elif eb_pass == 1:
        # euler 1st pass: pguess only (free surface also commits ps)
        pnew = ptd + ps0
        pguess_new = pnew
        ps0_new = pnew if free_surface else ps0
        ps1_new = ps1
    else:
        pnew = ptd + ps1_eff
        pguess_new = 3.0 * (pnew - ps0) + ps1
        ps1_new, ps0_new = ps0, pnew

    return ps0_new, ps1_new, pguess_new, ubar_new, iters
