"""Variable horizontal mixing: Smagorinsky nonlinear viscosity and
biharmonic mixing, torch.

Port of ``uvic_tpu.models.ocean.hmix`` (source/mom/smagnl.F, Rosati &
Miyakoda 1988: smagnlc strain/coefficients, smagnlm momentum stress
divergence, tracer coefficients; and the O_biharmonic branches of
delsq.F + fdifm.h / fdift.h: del2 is formed with coefficient sqrt(|A|)
and the diffusion operator is applied to -del2 with sqrt(|A|) again,
yielding -A grad^4).

All fields use the [k, j, i] layout; index j of a "north face" array is
the face between rows j and j+1.
"""

from __future__ import annotations

import math

import torch

from ...constants import RADIUS
from ...ops.stencil import E, N, S, W, setbcx

SQRT2R = 0.7071067811865476
C14 = 0.14


# ----------------------------------------------------------------------
# Smagorinsky (smagnl.F)
# ----------------------------------------------------------------------

def smagnl_coefficients(u_tm1, g, cyclic=True):
    """Strain rates and nonlinear mixing coefficients on the north face
    of U cells (smagnl.F:95-204 smagnlc).

    u_tm1 : (2, km, jmt, imt) velocity at taum1
    returns (strain, am_lambda, am_phi):
      strain    : (2, km, jmt, imt) tension (0) and shear (1)
      am_lambda : (km, jmt, imt)  (c14 csu dxu)^2/sqrt(2) |D|
      am_phi    : (km, jmt, imt)  (c14 dyu)^2/sqrt(2) |D|
    """
    u, v = u_tm1[0], u_tm1[1]
    cstr_n = torch.roll(g.cstr, -1)[None, :, None]
    dytr_cst_n = torch.roll(g.dytr * g.cst, -1)[None, :, None]
    csur = g.csur[None, :, None]
    csur_n = torch.roll(g.csur, -1)[None, :, None]
    dxu2r = g.dxu2r[None, None, :]

    def ddx(a):
        return (E(a) + E(N(a)) - W(a) - W(N(a))) * 0.5 * cstr_n * dxu2r

    tension = ddx(u) - (csur_n * N(v) - csur * v) * dytr_cst_n
    shear = ddx(v) + (csur_n * N(u) - csur * u) * dytr_cst_n
    strain = torch.stack([setbcx(tension, cyclic), setbcx(shear, cyclic)])

    deform = torch.sqrt(2.0 * (strain[0] ** 2 + strain[1] ** 2))
    clam = ((C14 * g.csu[:, None] * g.dxu[None, :]) ** 2 * SQRT2R)[None]
    cphi = ((C14 * g.dyu) ** 2 * SQRT2R)[None, :, None]
    return strain, clam * deform, cphi * deform


def smag_momentum_terms(strain, am_lambda, am_phi, g, sine, n: int):
    """Horizontal stress divergence for velocity component n
    (smagnl.F:293-420 smagnlm + fdifm.h O_smagnlmix branch).

    Returns (diff_ux, diff_uy, metric) tendencies at U points.
    """
    sn = strain[n]
    lam_s = am_lambda * sn
    # east-face flux: 4-point average of the north-face lambda*strain
    # (smagnl.F:353-358)
    diff_fe = 0.25 * (lam_s + S(lam_s) + E(lam_s) + E(S(lam_s)))
    diff_ux = (diff_fe - W(diff_fe)) * g.csudxur[None]

    cst_n = torch.roll(g.cst, -1)
    if n == 0:
        # northward flux of zonal momentum is zero; all of the cross
        # term enters through the metric (smagnl.F:373-396)
        diff_uy = torch.zeros_like(diff_ux)
        q = am_phi * strain[1]
        metric = (g.csur ** 2 * g.dyur)[None, :, None] * (
            q * (cst_n ** 2)[None, :, None]
            - S(q) * (g.cst ** 2)[None, :, None])
    else:
        diff_fn = -cst_n[None, :, None] * am_phi * strain[0]
        diff_uy = (diff_fn - S(diff_fn)) \
            * (g.csur * g.dyur)[None, :, None]
        f1 = (g.csur * sine * 0.5 / RADIUS)[None, :, None]
        p = am_lambda * strain[0]
        metric = f1 * (p + S(p))
    return diff_ux, diff_uy, metric


def smag_tracer_coefficients(am_lambda, am_phi, diff_back=0.0):
    """Tracer diffusivities on T-cell faces (smagnl.F:252-284):
    east face east of T(i,j) sits on the U north face at (i, j-1);
    north face averages am_phi from the four surrounding U faces."""
    diff_cet = S(am_lambda) + diff_back
    diff_cnt = 0.25 * (am_phi + W(am_phi) + S(am_phi)
                       + W(S(am_phi))) + diff_back
    return diff_cet, diff_cnt


def tracer_hdiff_var(t_tm1, tmask, g, diff_cet, diff_cnt):
    """Flux-form horizontal diffusion with 3-D coefficients
    (tracer.F O_smagnlmix branch: diff_fe = diff_cet*cstdxur*dT,
    diff_fn = diff_cnt*csu_dyur*dT).  Returns diff_tx + diff_ty."""
    diff_fe = diff_cet[None] * g.cstdxur[None, None] * (E(t_tm1) - t_tm1)
    diff_tx = (diff_fe * E(tmask)[None]
               - W(diff_fe) * W(tmask)[None]) * g.cstdxtr[None, None]
    diff_fn = diff_cnt[None] * (g.csu * g.dyur)[None, None, :, None] \
        * (N(t_tm1) - t_tm1)
    diff_ty = (diff_fn * N(tmask)[None]
               - S(diff_fn) * S(tmask)[None]) \
        * (1.0 / (g.cst * g.dyt))[None, None, :, None]
    return diff_tx + diff_ty


# ----------------------------------------------------------------------
# biharmonic (delsq.F + O_biharmonic branches)
# ----------------------------------------------------------------------

def _tracer_laplacian(t, tmask, g, coef):
    """Constant-coefficient horizontal diffusion operator used twice by
    the biharmonic scheme; `coef` replaces ah."""
    fe = coef * g.cstdxur[None, None] * (E(t) - t)
    tx = (fe * E(tmask)[None] - W(fe) * W(tmask)[None]) \
        * g.cstdxtr[None, None]
    scale = coef / g.ah
    ahc_n = (g.ahc_north * scale)[None, None, :, None]
    ahc_s = (g.ahc_south * scale)[None, None, :, None]
    ty = (ahc_n * N(tmask)[None] * (N(t) - t)
          - ahc_s * S(tmask)[None] * (t - S(t)))
    return tx + ty


def tracer_hdiff_bihar(t_tm1, tmask, g, ahbi, cyclic=True):
    """Biharmonic tracer mixing -|ahbi| grad^4 T: two passes of the
    Laplacian at sqrt(|ahbi|) with a sign flip between them
    (delsq.F:60-110; tracer.F O_biharmonic flux branch)."""
    b = math.sqrt(abs(ahbi))
    del2 = setbcx(-_tracer_laplacian(t_tm1, tmask, g, b) * tmask[None],
                  cyclic)
    return _tracer_laplacian(del2, tmask, g, b)


def momentum_laplacian(u_tm1, g, coef, n: int):
    """Constant-coefficient horizontal friction for component n without
    the metric terms (fdifm.h DIFF_Ux + DIFF_Uy); `coef` replaces am."""
    un = u_tm1[n]
    fe = coef * (g.csur[:, None] * E(g.dxtr)[None, :])[None] \
        * (E(un) - un)
    ux = (fe - W(fe)) * g.csudxur[None]
    scale = coef / g.am
    amc_n = (g.amc_north * scale)[None, :, None]
    amc_s = (g.amc_south * scale)[None, :, None]
    uy = amc_n * (N(un) - un) - amc_s * (un - S(un))
    return ux + uy


def momentum_bihar_terms(u_tm1, umask, g, ambi, n: int, cyclic=True):
    """Biharmonic friction for component n: del2 of both components at
    sqrt(|ambi|), then DIFF_Ux/Uy on -del2 plus the metric
    am3*del2(n) + am4*(del2(3-n) E-W difference) (fdifm.h:58-61)."""
    b = math.sqrt(abs(ambi))
    del2 = torch.stack([
        setbcx(-momentum_laplacian(u_tm1, g, b, 0) * umask, cyclic),
        setbcx(-momentum_laplacian(u_tm1, g, b, 1) * umask, cyclic)])
    diff = momentum_laplacian(del2, g, b, n)
    scale = b / g.am
    metric = ((g.am3 * scale)[None, :, None] * del2[n]
              + (g.am4[n] * scale)[None, :, None]
              * g.dxmetr[None, None, :]
              * (E(del2[1 - n]) - W(del2[1 - n])))
    return diff + metric
