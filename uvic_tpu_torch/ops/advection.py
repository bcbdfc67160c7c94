"""Tracer advective fluxes: centered, upstream, QUICKER and FCT
(Zalesak), torch.

Port of ``uvic_tpu.ops.advection`` (source/mom/tracer_adv_flx.F): the
centered and upstream schemes, the 3rd-order QUICKER scheme
(:54-249) and FCT (:376-1005) with the dlm1 or dlm2 one-dimensional
delimiters and the optional 3-D delimiter (O_fct_3d).  Flux conventions
follow the reference:

- all fluxes are *2x* the physical flux (the 1/2 lives in the metric
  factors cstdxt2r/cstdyt2r/dzt2r, fdift.h:25-39),
- ``fe[.., j, i]`` is the flux across the east face of T cell (i,j),
  ``fn`` the north face, ``fb[k]`` the bottom face of level k; the
  surface face flux is zero (rigid lid),
- the advecting velocities may include the GM eddy-induced components.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EPSLN
from .stencil import DN, E, N, S, UP, W, setbcx


def centered_flux(t_tau, vet, vnt, vbt):
    """2nd-order centered fluxes at tau (tracer_adv_flx.F:1007-1070 and the
    ADV_Ty statement function, fdift.h:34-36)."""
    fe = vet * (t_tau + E(t_tau))
    fn = vnt * (t_tau + N(t_tau))
    fb = vbt * (t_tau + DN(t_tau))   # bottom face of cell k
    fb[..., -1, :, :] = 0.0
    return fe, fn, fb


def upstream_flux(t, vet, vnt, vbt):
    """First-order upstream fluxes (the FCT low-order scheme,
    tracer_adv_flx.F:489-543): v*(a+b) + |v|*(a-b) picks the upwind donor."""
    fe = vet * (t + E(t)) + torch.abs(vet) * (t - E(t))
    fn = vnt * (t + N(t)) + torch.abs(vnt) * (t - N(t))
    fb = vbt * (DN(t) + t) + torch.abs(vbt) * (DN(t) - t)
    fb[..., -1, :, :] = 0.0
    return fe, fn, fb


def quicker_coefficients(grid):
    """Interpolation/curvature weights for the 3rd-order QUICKER scheme
    (grids.F:568-643).  Host-side NumPy; returns a dict of arrays per
    axis ``x``, ``y``, ``z``."""
    def axis_coeffs(d, cyclic_axis):
        n = len(d)
        ip2 = np.minimum(np.arange(n) + 2, n - 1)
        if cyclic_axis:
            ip2 = np.where(np.arange(n) >= n - 2, 2, np.arange(n) + 2)
            ip2 = np.minimum(ip2, n - 1)
        ip1 = np.minimum(np.arange(n) + 1, n - 1)
        im1 = np.maximum(np.arange(n) - 1, 0)
        dp1, dp2, dm1 = d[ip1], d[ip2], d[im1]
        return dict(
            q1=2.0 * dp1 / (dp1 + d), q2=2.0 * d / (dp1 + d),
            p1=2.0 * d * dp1 / ((dm1 + 2 * d + dp1) * (d + dp1)),
            p2=-2.0 * d * dp1 / ((d + dp1) * (dm1 + d)),
            p3=2.0 * d * dp1 / ((dm1 + 2 * d + dp1) * (dm1 + d)),
            n1=2.0 * d * dp1 / ((d + 2 * dp1 + dp2) * (dp1 + dp2)),
            n2=-2.0 * d * dp1 / ((dp1 + dp2) * (d + dp1)),
            n3=2.0 * d * dp1 / ((d + 2 * dp1 + dp2) * (d + dp1)))

    return dict(x=axis_coeffs(np.asarray(grid.dxt), grid.cyclic),
                y=axis_coeffs(np.asarray(grid.dyt), False),
                z=axis_coeffs(np.asarray(grid.dzt), False))


def quicker_flux(t_tau, t_lag, vet, vnt, vbt, tmask, qc):
    """QUICKER 3rd-order advective fluxes (tracer_adv_flx.F:54-249).

    qc: ``quicker_coefficients`` as tensors, x coefficients (imt,),
    y (jmt,), z (km,)."""
    def cx(name):
        return qc["x"][name][None, None, None, :]

    def cy(name):
        return qc["y"][name][None, None, :, None]

    def cz(name):
        return qc["z"][name][None, :, None, None]

    # east face
    upos = 0.5 * (vet + torch.abs(vet)) * W(tmask) * tmask * E(tmask)
    uneg = 0.5 * (vet - torch.abs(vet)) * E(E(tmask)) * E(tmask) * tmask
    fe = (vet * (cx("q1") * t_tau + cx("q2") * E(t_tau))
          - upos * (cx("p1") * E(t_lag) + cx("p2") * t_lag
                    + cx("p3") * W(t_lag))
          - uneg * (cx("n1") * E(E(t_lag)) + cx("n2") * E(t_lag)
                    + cx("n3") * t_lag))
    # north face
    vpos = 0.5 * (vnt + torch.abs(vnt)) * S(tmask) * tmask * N(tmask)
    vneg = 0.5 * (vnt - torch.abs(vnt)) * N(N(tmask)) * N(tmask) * tmask
    fn = (vnt * (cy("q1") * t_tau + cy("q2") * N(t_tau))
          - vpos * (cy("p1") * N(t_lag) + cy("p2") * t_lag
                    + cy("p3") * S(t_lag))
          - vneg * (cy("n1") * N(N(t_lag)) + cy("n2") * N(t_lag)
                    + cy("n3") * t_lag))
    # bottom face: note the reversed pos/neg-curvature pairing
    # (tracer_adv_flx.F:200-214; k increases downward)
    wpos = 0.5 * (vbt + torch.abs(vbt)) * DN(DN(tmask)) * DN(tmask) * tmask
    wneg = 0.5 * (vbt - torch.abs(vbt)) * UP(tmask) * tmask * DN(tmask)
    fb = (vbt * (cz("q1") * t_tau + cz("q2") * DN(t_tau))
          - wneg * (cz("p1") * DN(t_lag) + cz("p2") * t_lag
                    + cz("p3") * UP(t_lag))
          - wpos * (cz("n1") * DN(DN(t_lag)) + cz("n2") * DN(t_lag)
                    + cz("n3") * t_lag))
    fb[..., -1, :, :] = 0.0
    return fe, fn, fb


def _limit(anti, cpos, cneg):
    """Apply directional limiter: cpos where flux > 0, cneg where < 0
    (tracer_adv_flx.F:700-705 branch-free form)."""
    return 0.5 * ((cpos + cneg) * anti + (cpos - cneg) * torch.abs(anti))


def fct_flux(t_tau, t_tm1, vet, vnt, vbt, tmask, c2dtts_k,
             cstdxt2r, cstdyt2r, dzt2r, cyclic=True,
             variant="dlm1", fct3d=False):
    """Zalesak FCT fluxes (tracer_adv_flx.F:376-1005).

    t_tau, t_tm1 : (..., km, jmt, imt) tracer at tau and tau-1
    vet/vnt/vbt  : total advective velocities (incl. GM if enabled)
    c2dtts_k     : (km,1,1) leapfrog interval x dtxcel acceleration
    cstdxt2r     : (jmt, imt); cstdyt2r: (jmt,1); dzt2r: (km,1,1)
    variant      : "dlm1" — extrema from halfway tau means (O_fct_dlm1)
                   "dlm2" — extrema from the low-order neighbour
                   solution (O_fct_dlm2, tracer_adv_flx.F:659-666)
    fct3d        : the additional 3-D delimiter coupling all
                   directions after the 1-D passes (O_fct_3d,
                   tracer_adv_flx.F:880-977)
    returns (fe, fn, fb) corrected 2x-fluxes.
    """
    tmaski = 1.0 - tmask

    # low-order upstream fluxes at tau-1
    fe_lo, fn_lo, fb_lo = upstream_flux(t_tm1, vet, vnt, vbt)

    # low-order solution
    adv_tx = (fe_lo - W(fe_lo)) * cstdxt2r
    adv_ty = (fn_lo - S(fn_lo)) * cstdyt2r
    adv_tz = (UP(fb_lo) - fb_lo) * dzt2r
    t_lo = t_tm1 - c2dtts_k * (adv_tx + adv_ty + adv_tz) * tmask
    t_lo = setbcx(t_lo, cyclic)

    # raw antidiffusive fluxes: high-order leapfrog (tau) minus low-order
    anti_fe = vet * (t_tau + E(t_tau)) - fe_lo
    anti_fn = vnt * (t_tau + N(t_tau)) - fn_lo
    anti_fb = vbt * (t_tau + DN(t_tau)) - fb_lo * tmask
    anti_fb[..., -1, :, :] = 0.0

    def ratios(trmax, trmin, p_plus, p_minus):
        q_plus = trmax - t_lo
        q_minus = t_lo - trmin
        rpl = torch.clamp(tmask * q_plus / (p_plus + EPSLN), max=1.0)
        rmn = torch.clamp(tmask * q_minus / (p_minus + EPSLN), max=1.0)
        return rpl, rmn

    def pos(x):
        return torch.clamp(x, min=0.0)

    def neg(x):
        return torch.clamp(x, max=0.0)

    def extrema(fxa, fxb):
        return (torch.maximum(torch.maximum(fxa, fxb), t_lo),
                torch.minimum(torch.minimum(fxa, fxb), t_lo))

    dlm2 = variant == "dlm2"

    # ---- x-direction delimiter ---------------------------------------
    if dlm2:
        fxa = W(tmask) * W(t_lo) + W(tmaski) * t_lo
        fxb = E(tmask) * E(t_lo) + E(tmaski) * t_lo
    else:
        halfway = 0.5 * (W(t_tau) + t_tau)      # value at west face
        fxa = W(tmask) * halfway + W(tmaski) * t_lo
        fxb = E(tmask) * E(halfway) + E(tmaski) * t_lo
    trmax_x, trmin_x = extrema(fxa, fxb)
    dcf = c2dtts_k * cstdxt2r
    p_plus = dcf * (pos(W(anti_fe)) - neg(anti_fe))
    p_minus = dcf * (pos(anti_fe) - neg(W(anti_fe)))
    rpl, rmn = ratios(trmax_x, trmin_x, p_plus, p_minus)
    rpl, rmn = setbcx(rpl, cyclic), setbcx(rmn, cyclic)
    anti_fe = _limit(anti_fe, torch.minimum(E(rpl), rmn),
                     torch.minimum(rpl, E(rmn)))

    # ---- y-direction delimiter ---------------------------------------
    if dlm2:
        fxa = S(tmask) * S(t_lo) + S(tmaski) * t_lo
        fxb = N(tmask) * N(t_lo) + N(tmaski) * t_lo
    else:
        fxa = S(tmask) * (0.5 * (S(t_tau) + t_tau)) + S(tmaski) * t_lo
        fxb = N(tmask) * (0.5 * (t_tau + N(t_tau))) + N(tmaski) * t_lo
    trmax_y, trmin_y = extrema(fxa, fxb)
    dcf = c2dtts_k * cstdyt2r
    p_plus = dcf * (pos(S(anti_fn)) - neg(anti_fn))
    p_minus = dcf * (pos(anti_fn) - neg(S(anti_fn)))
    rpl, rmn = ratios(trmax_y, trmin_y, p_plus, p_minus)
    anti_fn = _limit(anti_fn, torch.minimum(N(rpl), rmn),
                     torch.minimum(rpl, N(rmn)))

    # ---- z-direction delimiter ---------------------------------------
    if dlm2:
        fxa = UP(tmask) * UP(t_lo) + UP(tmaski) * t_lo
        fxb = DN(tmask) * DN(t_lo) + DN(tmaski) * t_lo
    else:
        fxa = UP(tmask) * (0.5 * (UP(t_tau) + t_tau)) + UP(tmaski) * t_lo
        fxb = DN(tmask) * (0.5 * (t_tau + DN(t_tau))) + DN(tmaski) * t_lo
    fxa[..., 0, :, :] = t_lo[..., 0, :, :]
    fxb[..., -1, :, :] = t_lo[..., -1, :, :]
    trmax_z, trmin_z = extrema(fxa, fxb)
    dcf = c2dtts_k * dzt2r
    # for cell k: left flux = bottom face (k), right flux = top face (k-1)
    p_plus = dcf * (pos(anti_fb) - neg(UP(anti_fb)))
    p_minus = dcf * (pos(UP(anti_fb)) - neg(anti_fb))
    rpl, rmn = ratios(trmax_z, trmin_z, p_plus, p_minus)
    # face k lies between cells k (above) and k+1 (below)
    anti_fb = _limit(anti_fb, torch.minimum(rpl, DN(rmn)),
                     torch.minimum(DN(rpl), rmn))
    anti_fb[..., -1, :, :] = 0.0

    # ---- 3-D delimiter on the pre-corrected fluxes (O_fct_3d,
    # tracer_adv_flx.F:880-977): extrema over all directions, P sums
    # all incoming/outgoing antidiffusive fluxes ----------------------
    if fct3d:
        q_plus = torch.maximum(torch.maximum(trmax_x, trmax_y),
                               trmax_z) - t_lo
        q_minus = t_lo - torch.minimum(torch.minimum(trmin_x, trmin_y),
                                       trmin_z)
        den_p = EPSLN + c2dtts_k * (
            cstdxt2r * (pos(W(anti_fe)) - neg(anti_fe))
            + cstdyt2r * (pos(S(anti_fn)) - neg(anti_fn))
            + dzt2r * (pos(anti_fb) - neg(UP(anti_fb))))
        den_m = EPSLN + c2dtts_k * (
            cstdxt2r * (pos(anti_fe) - neg(W(anti_fe)))
            + cstdyt2r * (pos(anti_fn) - neg(S(anti_fn)))
            + dzt2r * (pos(UP(anti_fb)) - neg(anti_fb)))
        r3p = setbcx(torch.clamp(tmask * q_plus / den_p, max=1.0), cyclic)
        r3m = setbcx(torch.clamp(tmask * q_minus / den_m, max=1.0), cyclic)
        anti_fe = _limit(anti_fe, torch.minimum(E(r3p), r3m),
                         torch.minimum(r3p, E(r3m)))
        anti_fn = _limit(anti_fn, torch.minimum(N(r3p), r3m),
                         torch.minimum(r3p, N(r3m)))
        anti_fb = _limit(anti_fb, torch.minimum(r3p, DN(r3m)),
                         torch.minimum(DN(r3p), r3m))
        anti_fb[..., -1, :, :] = 0.0

    # ---- corrected totals --------------------------------------------
    fe = anti_fe + fe_lo
    fn = (anti_fn + fn_lo) * tmask
    fb = (anti_fb + fb_lo) * tmask
    return fe, fn, fb
