"""Tracer advective fluxes: centered, upstream and FCT (Zalesak, dlm1),
torch.

Port of the centered scheme and the FCT path of
``uvic_tpu.ops.advection`` (source/mom/tracer_adv_flx.F:376-1070, O_fct
with the dlm1 one-dimensional delimiters).  Flux conventions follow the
reference:

- all fluxes are *2x* the physical flux (the 1/2 lives in the metric
  factors cstdxt2r/cstdyt2r/dzt2r, fdift.h:25-39),
- ``fe[.., j, i]`` is the flux across the east face of T cell (i,j),
  ``fn`` the north face, ``fb[k]`` the bottom face of level k; the
  surface face flux is zero (rigid lid),
- the advecting velocities may include the GM eddy-induced components.
"""

from __future__ import annotations

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


def _limit(anti, cpos, cneg):
    """Apply directional limiter: cpos where flux > 0, cneg where < 0
    (tracer_adv_flx.F:700-705 branch-free form)."""
    return 0.5 * ((cpos + cneg) * anti + (cpos - cneg) * torch.abs(anti))


def fct_flux(t_tau, t_tm1, vet, vnt, vbt, tmask, c2dtts_k,
             cstdxt2r, cstdyt2r, dzt2r, cyclic=True):
    """Zalesak FCT fluxes with the dlm1 delimiters
    (tracer_adv_flx.F:376-1005).

    t_tau, t_tm1 : (..., km, jmt, imt) tracer at tau and tau-1
    vet/vnt/vbt  : total advective velocities (incl. GM if enabled)
    c2dtts_k     : (km,1,1) leapfrog interval x dtxcel acceleration
    cstdxt2r     : (jmt, imt); cstdyt2r: (jmt,1); dzt2r: (km,1,1)
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

    # ---- x-direction delimiter ---------------------------------------
    halfway = 0.5 * (W(t_tau) + t_tau)      # value at west face
    fxa = W(tmask) * halfway + W(tmaski) * t_lo
    fxb = E(tmask) * E(halfway) + E(tmaski) * t_lo
    trmax = torch.maximum(torch.maximum(fxa, fxb), t_lo)
    trmin = torch.minimum(torch.minimum(fxa, fxb), t_lo)
    dcf = c2dtts_k * cstdxt2r
    p_plus = dcf * (pos(W(anti_fe)) - neg(anti_fe))
    p_minus = dcf * (pos(anti_fe) - neg(W(anti_fe)))
    rpl, rmn = ratios(trmax, trmin, p_plus, p_minus)
    rpl, rmn = setbcx(rpl, cyclic), setbcx(rmn, cyclic)
    anti_fe = _limit(anti_fe, torch.minimum(E(rpl), rmn),
                     torch.minimum(rpl, E(rmn)))

    # ---- y-direction delimiter ---------------------------------------
    fxa = S(tmask) * (0.5 * (S(t_tau) + t_tau)) + S(tmaski) * t_lo
    fxb = N(tmask) * (0.5 * (t_tau + N(t_tau))) + N(tmaski) * t_lo
    trmax = torch.maximum(torch.maximum(fxa, fxb), t_lo)
    trmin = torch.minimum(torch.minimum(fxa, fxb), t_lo)
    dcf = c2dtts_k * cstdyt2r
    p_plus = dcf * (pos(S(anti_fn)) - neg(anti_fn))
    p_minus = dcf * (pos(anti_fn) - neg(S(anti_fn)))
    rpl, rmn = ratios(trmax, trmin, p_plus, p_minus)
    anti_fn = _limit(anti_fn, torch.minimum(N(rpl), rmn),
                     torch.minimum(rpl, N(rmn)))

    # ---- z-direction delimiter ---------------------------------------
    fxa = UP(tmask) * (0.5 * (UP(t_tau) + t_tau)) + UP(tmaski) * t_lo
    fxb = DN(tmask) * (0.5 * (t_tau + DN(t_tau))) + DN(tmaski) * t_lo
    fxa[..., 0, :, :] = t_lo[..., 0, :, :]
    fxb[..., -1, :, :] = t_lo[..., -1, :, :]
    trmax = torch.maximum(torch.maximum(fxa, fxb), t_lo)
    trmin = torch.minimum(torch.minimum(fxa, fxb), t_lo)
    dcf = c2dtts_k * dzt2r
    # for cell k: left flux = bottom face (k), right flux = top face (k-1)
    p_plus = dcf * (pos(anti_fb) - neg(UP(anti_fb)))
    p_minus = dcf * (pos(UP(anti_fb)) - neg(anti_fb))
    rpl, rmn = ratios(trmax, trmin, p_plus, p_minus)
    # face k lies between cells k (above) and k+1 (below)
    anti_fb = _limit(anti_fb, torch.minimum(rpl, DN(rmn)),
                     torch.minimum(DN(rpl), rmn))
    anti_fb[..., -1, :, :] = 0.0

    # ---- corrected totals --------------------------------------------
    fe = anti_fe + fe_lo
    fn = (anti_fn + fn_lo) * tmask
    fb = (anti_fb + fb_lo) * tmask
    return fe, fn, fb
