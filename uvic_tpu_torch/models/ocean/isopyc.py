"""Isopycnal (Redi) mixing tensor + Gent-McWilliams eddy advection, torch.

Port of ``uvic_tpu.models.ocean.isopyc`` (source/mom/isopyc.F): the
small-angle approximation (the reference default) and the full tensor
(O_full_tensor, with the Gerdes re-scaling of the coefficient in the
unstable slope band).  The ip/kr/jq neighbor-quadruple loops unroll
into fixed 4-term shift stencils; the per-face mixing coefficients Ai_*
carry the slope limiting (the (sc/s)^2 clip or the
Danabasoglu-McWilliams tanh taper, O_dm_taper).

Outputs:
- K11/K22: along-isopycnal contributions to the east/north diffusive
  fluxes, K33: the vertical diffusivity addition (vmixc.F:146-156),
- GM velocities (isopyc_adv, isopyc.F:1100-1300),
- ``isoflux``: the Redi flux additions for all tracers (isopyc.F:889-1065),
- the 18-slot weight stack (small-angle only) through which the tracer kernel applies the
  Redi/GM flux divergence (``iso_weight_pack``/``iso_weight_stack``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ...constants import EPSLN
from ...ops.eos import drods, drodt
from ...ops.stencil import DN, E, N, S, UP, W, setbcx


@dataclass
class IsopycFields:
    K11: Any
    K22: Any
    K33: Any
    ai_ez: Any        # [ip][kr] of (km, jmt, imt)
    ai_nz: Any        # [jq][kr]
    ai_bx: Any        # [ip][kr]
    ai_by: Any        # [jq][kr]
    alphai: Any
    betai: Any
    ddxt: Any         # (2, km, jmt, imt) [T, S] east-face gradients
    ddyt: Any
    ddzt: Any         # (2, km, jmt, imt) bottom-face gradients
    vetiso: Any
    vntiso: Any
    vbtiso: Any
    # O_full_tensor extras (None under the small-angle approximation):
    full_tensor: bool = False
    drodye: Any = None    # [ip][jq] cross-gradients at east faces
    drodxn: Any = None    # [ip][jq] cross-gradients at north faces
    ai0_e: Any = None     # untapered east-face Ai0 (incl. addisop)
    ai0_n: Any = None


def _taper(s_abs, sc, cfg):
    """Slope limiting: (sc/s)^2 clip (default) or DM tanh taper."""
    if cfg.dm_taper:
        return 0.5 * (1.0 - torch.tanh((s_abs - cfg.del_dm) / cfg.s_dm))
    return torch.where(s_abs > sc, (sc / (s_abs + EPSLN)) ** 2,
                       torch.ones_like(s_abs))


def full_tensor_delta(g, cfg):
    """Gerdes re-scaling band for O_full_tensor (isopyc.F:150-175):
    delta_iso = min over cells of dx*dz/(4*ahisop*dtts) (and dy*dz);
    within slopes (s_minus, s_plus) the coefficient is re-scaled by
    delta_iso*(s + 1/s).  Host-side floats."""
    ft = 1.0 / (4.0 * cfg.ahisop * cfg.dtts)

    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    dxt = host(g.dxt)[None, None, 1:-1]
    cst = host(g.cst)[None, 1:-1, None]
    dyt = host(g.dyt)[None, 1:-1, None]
    dzt = host(g.dzt)[:, None, None]
    delta1 = (dxt * cst * dzt * ft).min()
    delta2 = (dyt * dzt * ft).min()
    delta_iso = float(min(delta1, delta2))
    if delta_iso < 0.5:
        s_minus = (1.0 - np.sqrt(1.0 - 4.0 * delta_iso ** 2)) \
            / (2.0 * delta_iso)
        s_plus = 1.0 / s_minus
    else:
        s_minus = s_plus = 0.0
    return delta_iso, float(s_minus), float(s_plus)


def _full_taper(s_abs, delta_iso, s_minus, s_plus):
    """Gerdes re-scaling: Ai -> Ai*delta*(s + 1/s) inside the unstable
    band, Ai unchanged outside (the full tensor needs no small-slope
    clip; isopyc.F:585-592)."""
    if not (delta_iso < 0.5):
        return torch.ones_like(s_abs)
    resc = delta_iso * (s_abs + 1.0 / torch.clamp(s_abs, min=EPSLN))
    use = (s_abs > s_minus) & (s_abs < s_plus)
    return torch.where(use, resc, torch.ones_like(s_abs))


def compute_isopyc(t_tm1, tmask, kmt, eos_c, eos_to, eos_so, g, cfg,
                   cyclic=True, addisop=None) -> IsopycFields:
    """All isopycnal/GM fields from the tau-1 tracers (isopyc.F isopyc).

    addisop : optional (jmt,) ZONAL diffusivity addition
    (O_anisotropic_zonal_mixing, updates/08 isopyc.F:243-260) applied
    to the east-face coefficient only."""
    km = t_tm1.shape[1]
    T, Ssal = t_tm1[0], t_tm1[1]
    to = eos_to[:, None, None]
    so = eos_so[:, None, None]
    cc = eos_c[:, None, None, :]

    # alpha/beta at T points (elements, isopyc.F:370-385)
    alphai = setbcx(drodt(cc, T - to, Ssal - so), cyclic)
    betai = setbcx(drods(cc, T - to, Ssal - so), cyclic)

    dzwr_k = g.dzwr[1:].reshape(km, 1, 1)          # 1/dzw(k), bottom of cell k
    dxur = g.dxur[None, None, :]
    dyur = g.dyur[None, :, None]
    cstr = g.cstr[None, :, None]

    # face gradients of T and S (elements, isopyc.F:389-440)
    def grads(f):
        ddz = DN(tmask) * dzwr_k * (f - DN(f))
        ddz[-1] = 0.0                               # kp1 clamp -> zero
        ddx = tmask * E(tmask) * cstr * dxur * (E(f) - f)
        ddy = tmask * N(tmask) * dyur * (N(f) - f)
        return setbcx(ddx, cyclic), setbcx(ddy, cyclic), setbcx(ddz, cyclic)

    ddxt_T, ddyt_T, ddzt_T = grads(T)
    ddxt_S, ddyt_S, ddzt_S = grads(Ssal)
    ddxt = torch.stack([ddxt_T, ddxt_S])
    ddyt = torch.stack([ddyt_T, ddyt_S])
    ddzt = torch.stack([ddzt_T, ddzt_S])

    def ddz_face(n, kr, shift=None):
        """ddzt at face k-1+kr (kr=0: above cell, surface = 0)."""
        a = ddzt[n] if shift is None else shift(ddzt[n])
        return a if kr == 1 else UP(a)

    # critical slope per level (sc = 1/(slmxr*sqrt(dtxcel)))
    sc_k = (cfg.slmx / torch.sqrt(g.dtxcel)).reshape(km, 1, 1)

    ai0_e = cfg.ahisop          # fisop structure function = 1 (no data file)
    ai0_n = cfg.ahisop
    ai0_b = cfg.ahisop
    if addisop is not None:
        # equatorial zonal enhancement enters the east-face (K11)
        # coefficient only (isopyc.F:981 Ai0 = ahisop + addisop)
        ai0_e = ai0_e + addisop[None, :, None]

    full = cfg.full_tensor
    if full:
        # host-side constants; the model keeps them in its bag (no copy
        # to the host inside a step, which a graph capture refuses)
        band = getattr(g, "full_tensor_band", None)
        delta_iso, s_minus, s_plus = band or full_tensor_delta(g, cfg)

        def taper(s_abs):
            return _full_taper(s_abs, delta_iso, s_minus, s_plus)
    else:
        def taper(s_abs):
            return _taper(s_abs, sc_k, cfg)

    csu_dyu_f = [S(g.csu[None, :, None]) * S(g.dyu[None, :, None]),
                 g.csu[None, :, None] * g.dyu[None, :, None]]  # [jq]
    dxu_f = [W(g.dxu[None, None, :]), g.dxu[None, None, :]]    # [ip]

    # ---- east face: Ai_ez, K11 (ai_east, isopyc.F:544-640) -----------
    mask_e = tmask * E(tmask)
    ai_ez = []
    drodye_all = [[None, None], [None, None]] if full else None
    sumz_e = torch.zeros_like(T)
    sumy_e = torch.zeros_like(T)
    for ip in (0, 1):
        shift = None if ip == 0 else E
        a_i = alphai if ip == 0 else E(alphai)
        b_i = betai if ip == 0 else E(betai)
        drodxe = a_i * ddxt[0] + b_i * ddxt[1]
        if full:
            # drodye(ip, jq) = rho gradients across the north faces
            # adjacent to the east face (isopyc.h O_full_tensor)
            ddyt_ip = ddyt if ip == 0 else E(ddyt)
            dro_ye = []
            for jq in (0, 1):
                dd = S(ddyt_ip) if jq == 0 else ddyt_ip
                dro_ye.append(a_i * dd[0] + b_i * dd[1])
                drodye_all[ip][jq] = dro_ye[jq]
            drodze_kr = [a_i * ddz_face(0, kr, shift)
                         + b_i * ddz_face(1, kr, shift) for kr in (0, 1)]
            ze2 = 0.5 * (drodze_kr[0] ** 2 + drodze_kr[1] ** 2)
            ye2 = 0.5 * (dro_ye[0] ** 2 + dro_ye[1] ** 2)
        row = []
        for kr in (0, 1):
            drodze = (a_i * ddz_face(0, kr, shift)
                      + b_i * ddz_face(1, kr, shift))
            ai = ai0_e * mask_e * taper(torch.abs(drodxe / (drodze + EPSLN)))
            dzw_f = g.dzw[kr:km + kr].reshape(km, 1, 1)
            if full:
                sumz_e = sumz_e + dzw_f * ai * drodze ** 2 / (
                    drodxe ** 2 + ye2 + drodze ** 2 + EPSLN)
            else:
                sumz_e = sumz_e + dzw_f * ai
            row.append(ai)
        ai_ez.append(row)
        if full:
            for jq in (0, 1):
                sumy_e = sumy_e + csu_dyu_f[jq] * ai0_e * mask_e \
                    * dro_ye[jq] ** 2 / (drodxe ** 2 + dro_ye[jq] ** 2
                                         + EPSLN + ze2)
    dzt4r = (0.25 * g.dztr).reshape(km, 1, 1)
    K11 = dzt4r * sumz_e
    if full:
        K11 = K11 + 0.25 * (g.cstr * g.dytr)[None, :, None] * sumy_e
    K11 = setbcx(K11, cyclic)

    # ---- north face: Ai_nz, K22 (ai_north, isopyc.F:644-740) ---------
    mask_n = tmask * N(tmask)
    ai_nz = []
    drodxn_all = [[None, None], [None, None]] if full else None
    sumz_n = torch.zeros_like(T)
    sumx_n = torch.zeros_like(T)
    for jq in (0, 1):
        shift = None if jq == 0 else N
        a_j = alphai if jq == 0 else N(alphai)
        b_j = betai if jq == 0 else N(betai)
        drodyn = a_j * ddyt[0] + b_j * ddyt[1]
        if full:
            ddxt_jq = ddxt if jq == 0 else N(ddxt)
            dro_xn = []
            for ip in (0, 1):
                dd = W(ddxt_jq) if ip == 0 else ddxt_jq
                dro_xn.append(a_j * dd[0] + b_j * dd[1])
                drodxn_all[ip][jq] = dro_xn[ip]
            drodzn_kr = [a_j * ddz_face(0, kr, shift)
                         + b_j * ddz_face(1, kr, shift) for kr in (0, 1)]
            zn2 = 0.5 * (drodzn_kr[0] ** 2 + drodzn_kr[1] ** 2)
            xn2 = 0.5 * (dro_xn[0] ** 2 + dro_xn[1] ** 2)
        row = []
        for kr in (0, 1):
            drodzn = (a_j * ddz_face(0, kr, shift)
                      + b_j * ddz_face(1, kr, shift))
            ai = ai0_n * mask_n * taper(torch.abs(drodyn / (drodzn + EPSLN)))
            dzw_f = g.dzw[kr:km + kr].reshape(km, 1, 1)
            if full:
                sumz_n = sumz_n + dzw_f * ai * drodzn ** 2 / (
                    xn2 + drodyn ** 2 + drodzn ** 2 + EPSLN)
            else:
                sumz_n = sumz_n + dzw_f * ai
            row.append(ai)
        ai_nz.append(row)
        if full:
            for ip in (0, 1):
                sumx_n = sumx_n + dxu_f[ip] * ai0_n * mask_n \
                    * dro_xn[ip] ** 2 / (dro_xn[ip] ** 2 + drodyn ** 2
                                         + EPSLN + zn2)
    K22 = dzt4r * sumz_n
    if full:
        K22 = K22 + (0.25 * g.dxtr)[None, None, :] * sumx_n
    K22 = setbcx(K22, cyclic)

    # ---- bottom face: Ai_bx, Ai_by, K33 (ai_bottom, isopyc.F:743-880)
    # drodzb(kr) = alphai(k+kr)*ddzt(k) + betai(k+kr)*ddzt(k) at face k
    mask_b = DN(tmask)
    ai_bx = [[None, None], [None, None]]
    ai_by = [[None, None], [None, None]]
    sumx_b = torch.zeros_like(T)
    sumy_b = torch.zeros_like(T)
    dxu_w = g.dxu[None, None, :]
    csu_j = g.csu[None, :, None]
    dyu_j = g.dyu[None, :, None]
    for kr in (0, 1):
        a_k = alphai if kr == 0 else DN(alphai, fill=1.0)
        b_k = betai if kr == 0 else DN(betai, fill=1.0)
        drodzb = a_k * ddzt[0] + b_k * ddzt[1]
        ddxt_k = ddxt if kr == 0 else DN(ddxt)
        ddyt_k = ddyt if kr == 0 else DN(ddyt)
        if full:
            # face-mean squares for the projection denominators
            gxb = [a_k * (W(ddxt_k) if ip == 0 else ddxt_k)[0]
                   + b_k * (W(ddxt_k) if ip == 0 else ddxt_k)[1]
                   for ip in (0, 1)]
            gyb = [a_k * (S(ddyt_k) if jq == 0 else ddyt_k)[0]
                   + b_k * (S(ddyt_k) if jq == 0 else ddyt_k)[1]
                   for jq in (0, 1)]
            xb2 = 0.5 * (gxb[0] ** 2 + gxb[1] ** 2)
            yb2 = 0.5 * (gyb[0] ** 2 + gyb[1] ** 2)
        for ip in (0, 1):
            # drodxb uses ddxt at (i-1+ip, k+kr)
            gx = ddxt_k if ip == 1 else W(ddxt_k)
            drodxb = a_k * gx[0] + b_k * gx[1]
            sxb = torch.abs(drodxb / (drodzb + EPSLN))
            ai = ai0_b * mask_b * taper(sxb)
            ai_bx[ip][kr] = ai
            w = W(dxu_w) if ip == 0 else dxu_w
            if full:
                sumx_b = sumx_b + w * ai * drodxb ** 2 / (
                    drodxb ** 2 + yb2 + drodzb ** 2 + EPSLN)
            else:
                sumx_b = sumx_b + w * ai * sxb ** 2
        for jq in (0, 1):
            gy = ddyt_k if jq == 1 else S(ddyt_k)
            drodyb = a_k * gy[0] + b_k * gy[1]
            syb = torch.abs(drodyb / (drodzb + EPSLN))
            ai = ai0_b * mask_b * taper(syb)
            ai_by[jq][kr] = ai
            facty = (S(csu_j) * S(dyu_j)) if jq == 0 else csu_j * dyu_j
            if full:
                sumy_b = sumy_b + facty * ai * drodyb ** 2 / (
                    xb2 + drodyb ** 2 + drodzb ** 2 + EPSLN)
            else:
                sumy_b = sumy_b + facty * ai * syb ** 2
    K33 = (0.25 / g.dxt)[None, None, :] * sumx_b \
        + (0.25 / g.dyt)[None, :, None] * cstr * sumy_b
    K33[-1] = 0.0
    K33 = setbcx(K33, cyclic)

    vetiso, vntiso, vbtiso = _gm_velocities(
        alphai, betai, ddxt, ddyt, ddzt, tmask, kmt, g, cfg, sc_k, cyclic)

    return IsopycFields(
        K11=K11, K22=K22, K33=K33,
        ai_ez=ai_ez, ai_nz=ai_nz, ai_bx=ai_bx, ai_by=ai_by,
        alphai=alphai, betai=betai, ddxt=ddxt, ddyt=ddyt, ddzt=ddzt,
        vetiso=vetiso, vntiso=vntiso, vbtiso=vbtiso,
        full_tensor=full, drodye=drodye_all, drodxn=drodxn_all,
        ai0_e=(ai0_e * mask_e if full else None),
        ai0_n=(ai0_n * mask_n if full else None))


def _gm_velocities(alphai, betai, ddxt, ddyt, ddzt, tmask, kmt, g, cfg,
                   sc_k, cyclic):
    """GM bolus velocities (isopyc_adv, isopyc.F:1100-1300)."""
    km = alphai.shape[0]
    dztr = g.dztr.reshape(km, 1, 1)
    ath0 = cfg.athkdf

    def up1(a):   # value at level k-1 (clamped at surface)
        return torch.cat([a[:1], a[:-1]], dim=0)

    def dn1(a):   # value at level k+1 (clamped at bottom)
        return torch.cat([a[1:], a[-1:]], dim=0)

    top_bc = torch.ones((km, 1, 1), dtype=alphai.dtype, device=alphai.device)
    top_bc[0] = 0.0
    bot_bc = torch.ones_like(top_bc)
    bot_bc[-1] = 0.0

    def component(grad_h, a_shift, ddz_pair_shift, mask_pair):
        """slope & tapered coefficient at top/bottom faces for one
        horizontal direction; a_shift shifts alpha/beta to the partner
        cell (N for meridional, E for zonal)."""
        a_n, b_n = a_shift(alphai), a_shift(betai)
        # top face (kr=0): averages with level k-1
        at = alphai + a_n + up1(alphai) + up1(a_n)
        bt = betai + b_n + up1(betai) + up1(b_n)
        num_t = at * (grad_h[0] + up1(grad_h[0])) \
            + bt * (grad_h[1] + up1(grad_h[1]))
        den_t = at * (UP(ddzt[0]) + UP(ddz_pair_shift[0])) \
            + bt * (UP(ddzt[1]) + UP(ddz_pair_shift[1]))
        s_t = -num_t / (den_t + EPSLN)
        # bottom face (kr=1): averages with level k+1
        ab = alphai + a_n + dn1(alphai) + dn1(a_n)
        bb = betai + b_n + dn1(betai) + dn1(b_n)
        num_b = ab * (grad_h[0] + dn1(grad_h[0])) \
            + bb * (grad_h[1] + dn1(grad_h[1]))
        den_b = ab * (ddzt[0] + ddz_pair_shift[0]) \
            + bb * (ddzt[1] + ddz_pair_shift[1])
        s_b = -num_b / (den_b + EPSLN)
        ath_t = ath0 * mask_pair * _taper(torch.abs(s_t), sc_k, cfg)
        ath_b = ath0 * dn1(mask_pair) * _taper(torch.abs(s_b), sc_k, cfg)
        return ath_t, s_t, ath_b, s_b

    # meridional component at north faces
    ath_t, stn, ath_b, sbn = component(
        ddyt, N, [N(ddzt[0]), N(ddzt[1])], tmask * N(tmask))
    vntiso = -(ath_t * stn * top_bc - ath_b * sbn * bot_bc) * dztr \
        * g.csu[None, :, None]

    # zonal component at east faces
    ath_t, ste, ath_b, sbe = component(
        ddxt, E, [E(ddzt[0]), E(ddzt[1])], tmask * E(tmask))
    vetiso = -(ath_t * ste * top_bc - ath_b * sbe * bot_bc) * dztr
    vetiso = setbcx(vetiso, cyclic)

    # vertical from continuity (isopyc.F:1268-1290)
    div = g.dzt.reshape(km, 1, 1) * g.cstr[None, :, None] * (
        (vetiso - W(vetiso)) * g.dxtr[None, None, :]
        + (vntiso - S(vntiso)) * g.dytr[None, :, None])
    vbtiso = torch.cumsum(div, dim=0)
    levels = torch.arange(km, device=kmt.device).reshape(km, 1, 1)
    vbtiso = torch.where(levels == (kmt - 1)[None],
                         torch.zeros_like(vbtiso), vbtiso)
    vbtiso[-1] = 0.0
    return vetiso, vntiso, setbcx(vbtiso, cyclic)


def isoflux(iso: IsopycFields, t, tmask, g, cyclic=True):
    """Isopycnal diffusive flux additions for all tracers
    (isoflux, isopyc.F:889-1065).

    t : (nt, km, jmt, imt) tracers at tau-1
    returns (fe_iso, fn_iso, fb_iso): additions to the diffusive fluxes
    on east/north faces and the explicit K31/K32 bottom-face flux.
    """
    km = t.shape[1]
    dzt4r = (0.25 * g.dztr).reshape(1, km, 1, 1)
    alphai, betai = iso.alphai, iso.betai

    def ddz_face(n, kr, shift=None):
        a = iso.ddzt[n] if shift is None else shift(iso.ddzt[n])
        return a if kr == 1 else UP(a)

    def vdiff(f, kr):
        """t(km1kr) - t(kpkr): difference across face k-1+kr with index
        clamping (isoflux km1kr/kpkr)."""
        if kr == 0:
            d = UP(f, fill=0.0) - f
            d[:, 0] = 0.0                  # km1kr=kpkr=1 at surface
            return d
        d = f - DN(f, fill=0.0)
        d[:, -1] = 0.0                     # both clamp to km at bottom
        return d

    full = iso.full_tensor
    csu_1 = g.csu[None, :, None]

    # east face
    sumz = torch.zeros_like(t)
    sumy_x = torch.zeros_like(t)
    for ip in (0, 1):
        shift = None if ip == 0 else E
        a_i = alphai if ip == 0 else E(alphai)
        b_i = betai if ip == 0 else E(betai)
        drodxe = a_i * iso.ddxt[0] + b_i * iso.ddxt[1]
        t_ip = t if ip == 0 else E(t)
        if full:
            drodze_kr = [a_i * ddz_face(0, kr, shift)
                         + b_i * ddz_face(1, kr, shift) for kr in (0, 1)]
            ze2 = 0.5 * (drodze_kr[0] ** 2 + drodze_kr[1] ** 2)
            ye2 = 0.5 * (iso.drodye[ip][0] ** 2 + iso.drodye[ip][1] ** 2)
        for kr in (0, 1):
            drodze = a_i * ddz_face(0, kr, shift) + b_i * ddz_face(1, kr,
                                                                   shift)
            if full:
                # K13 with the full-gradient projection (isopyc.F:933)
                sumz = sumz - iso.ai_ez[ip][kr][None] * vdiff(t_ip, kr) \
                    * (drodxe * drodze)[None] \
                    / (drodxe ** 2 + ye2 + drodze ** 2 + EPSLN)[None]
            else:
                sumz = sumz - iso.ai_ez[ip][kr][None] * vdiff(t_ip, kr) \
                    * drodxe[None] / (drodze[None] + EPSLN)
        if full:
            # K12 cross-term (isopyc.F:944-953); the dyu in the
            # meridional t-difference cancels against the face weight
            for jq in (0, 1):
                facty = S(csu_1) if jq == 0 else csu_1
                tdy = (t_ip - S(t_ip)) if jq == 0 else (N(t_ip) - t_ip)
                sumy_x = sumy_x - facty[None] * iso.ai0_e[None] * tdy \
                    * (iso.drodye[ip][jq] * drodxe)[None] \
                    / (drodxe ** 2 + iso.drodye[ip][jq] ** 2
                       + EPSLN + ze2)[None]
    fe_iso = dzt4r * sumz \
        + iso.K11[None] * g.cstdxur[None, None] * (E(t) - t)
    if full:
        cstdytr = (g.cstr * g.dytr)[None, None, :, None]
        fe_iso = fe_iso + 0.25 * cstdytr * sumy_x

    # north face
    sumz = torch.zeros_like(t)
    sumx_y = torch.zeros_like(t)
    for jq in (0, 1):
        shift = None if jq == 0 else N
        a_j = alphai if jq == 0 else N(alphai)
        b_j = betai if jq == 0 else N(betai)
        drodyn = a_j * iso.ddyt[0] + b_j * iso.ddyt[1]
        t_jq = t if jq == 0 else N(t)
        if full:
            drodzn_kr = [a_j * ddz_face(0, kr, shift)
                         + b_j * ddz_face(1, kr, shift) for kr in (0, 1)]
            zn2 = 0.5 * (drodzn_kr[0] ** 2 + drodzn_kr[1] ** 2)
            xn2 = 0.5 * (iso.drodxn[0][jq] ** 2 + iso.drodxn[1][jq] ** 2)
        for kr in (0, 1):
            drodzn = a_j * ddz_face(0, kr, shift) + b_j * ddz_face(1, kr,
                                                                   shift)
            if full:
                sumz = sumz - iso.ai_nz[jq][kr][None] * vdiff(t_jq, kr) \
                    * (drodyn * drodzn)[None] \
                    / (xn2 + drodyn ** 2 + drodzn ** 2 + EPSLN)[None]
            else:
                sumz = sumz - iso.ai_nz[jq][kr][None] * vdiff(t_jq, kr) \
                    * drodyn[None] / (drodzn[None] + EPSLN)
        if full:
            # K21 cross-term (isopyc.F:995-1005)
            cstr_jq = (g.cstr if jq == 0 else torch.cat(
                [g.cstr[1:], g.cstr[-1:]]))[None, :, None]
            for ip in (0, 1):
                tdx = (t_jq - W(t_jq)) if ip == 0 else (E(t_jq) - t_jq)
                sumx_y = sumx_y - iso.ai0_n[None] * tdx * cstr_jq[None] \
                    * (iso.drodxn[ip][jq] * drodyn)[None] \
                    / (iso.drodxn[ip][jq] ** 2 + drodyn ** 2
                       + EPSLN + zn2)[None]
    csu_j = g.csu[None, None, :, None]
    fn_iso = csu_j * dzt4r * sumz \
        + iso.K22[None] * (g.csu * g.dyur)[None, None, :, None] * (N(t) - t)
    if full:
        fn_iso = fn_iso + 0.25 * csu_j * g.dxtr[None, None, None, :] \
            * sumx_y

    # bottom face: explicit K31/K32 flux (diff_fbiso)
    cstr = g.cstr[None, None, :, None]
    dxt4r = (0.25 / g.dxt)[None, None, None, :]
    dyt4r = (0.25 / g.dyt)[None, None, :, None]
    sumx = torch.zeros_like(t)
    sumy = torch.zeros_like(t)
    for kr in (0, 1):
        a_k = alphai if kr == 0 else DN(alphai, fill=1.0)
        b_k = betai if kr == 0 else DN(betai, fill=1.0)
        drodzb = (a_k * iso.ddzt[0] + b_k * iso.ddzt[1])[None]
        ddxt_k = iso.ddxt if kr == 0 else DN(iso.ddxt)
        ddyt_k = iso.ddyt if kr == 0 else DN(iso.ddyt)
        t_k = t if kr == 0 else DN(t)
        gx_ip = [a_k * (W(ddxt_k[0]) if ip == 0 else ddxt_k[0])
                 + b_k * (W(ddxt_k[1]) if ip == 0 else ddxt_k[1])
                 for ip in (0, 1)]
        gy_jq = [a_k * (S(ddyt_k[0]) if jq == 0 else ddyt_k[0])
                 + b_k * (S(ddyt_k[1]) if jq == 0 else ddyt_k[1])
                 for jq in (0, 1)]
        if full:
            xb2 = (0.5 * (gx_ip[0] ** 2 + gx_ip[1] ** 2))[None]
            yb2 = (0.5 * (gy_jq[0] ** 2 + gy_jq[1] ** 2))[None]
        for ip in (0, 1):
            gx = gx_ip[ip][None]
            tdiff = (t_k - W(t_k)) if ip == 0 else (E(t_k) - t_k)
            if full:
                # K31 with full projection (isopyc.F:1034-1038)
                sumx = sumx - iso.ai_bx[ip][kr][None] * cstr * tdiff \
                    * (gx * drodzb) / (gx ** 2 + yb2 + drodzb ** 2 + EPSLN)
            else:
                sumx = sumx - iso.ai_bx[ip][kr][None] * cstr * tdiff \
                    * gx / (drodzb + EPSLN)
        for jq in (0, 1):
            gy = gy_jq[jq][None]
            tdiff = (t_k - S(t_k)) if jq == 0 else (N(t_k) - t_k)
            fy = S(g.csu[None, None, :, None]) if jq == 0 \
                else g.csu[None, None, :, None]
            if full:
                # K32 (isopyc.F:1050-1055: the mean of both ip members,
                # as the reference package implements it)
                sumy = sumy - iso.ai_by[jq][kr][None] * fy * tdiff \
                    * (gy * drodzb) / (xb2 + gy ** 2 + drodzb ** 2 + EPSLN)
            else:
                sumy = sumy - iso.ai_by[jq][kr][None] * fy * tdiff \
                    * gy / (drodzb + EPSLN)
    fb_iso = dxt4r * sumx + dyt4r * cstr * sumy
    fb_iso[:, -1] = 0.0
    return fe_iso, fn_iso, fb_iso


def iso_weight_pack(iso: IsopycFields, g):
    """Fold every tracer-independent factor of the small-angle isoflux
    into per-face weight fields.

    Returns a dict of (km, jmt, imt) tensors
      we[ip][kr], wn[jq][kr], wbx[ip][kr], wby[jq][kr], k11c, k22c
    such that
      fe_iso = -sum we*vdiff(t_ip,kr) + k11c*(E(t)-t)
      fn_iso = -sum wn*vdiff(t_jq,kr) + k22c*(N(t)-t)
      fb_iso = -sum wbx*tdx(ip,kr) - sum wby*tdy(jq,kr)
    with the boundary zeroings folded into the weights."""
    alphai, betai = iso.alphai, iso.betai
    km = alphai.shape[0]
    dzt4r = (0.25 * g.dztr).reshape(km, 1, 1)
    csu_1 = g.csu[None, :, None]
    cstr = g.cstr[None, :, None]
    dxt4r = (0.25 / g.dxt)[None, None, :]
    dyt4r = (0.25 / g.dyt)[None, :, None]

    def ddz_face(n, kr, shift=None):
        a = iso.ddzt[n] if shift is None else shift(iso.ddzt[n])
        return a if kr == 1 else UP(a)

    def zero_bounds(w, kr):
        # vdiff is zeroed at the surface (kr=0) / bottom (kr=1) level
        w[0 if kr == 0 else -1] = 0.0
        return w

    we = [[None, None], [None, None]]
    for ip in (0, 1):
        shift = None if ip == 0 else E
        a_i = alphai if ip == 0 else E(alphai)
        b_i = betai if ip == 0 else E(betai)
        drodxe = a_i * iso.ddxt[0] + b_i * iso.ddxt[1]
        for kr in (0, 1):
            drodze = a_i * ddz_face(0, kr, shift) \
                + b_i * ddz_face(1, kr, shift)
            we[ip][kr] = zero_bounds(
                dzt4r * iso.ai_ez[ip][kr] * drodxe / (drodze + EPSLN), kr)

    wn = [[None, None], [None, None]]
    for jq in (0, 1):
        shift = None if jq == 0 else N
        a_j = alphai if jq == 0 else N(alphai)
        b_j = betai if jq == 0 else N(betai)
        drodyn = a_j * iso.ddyt[0] + b_j * iso.ddyt[1]
        for kr in (0, 1):
            drodzn = a_j * ddz_face(0, kr, shift) \
                + b_j * ddz_face(1, kr, shift)
            wn[jq][kr] = zero_bounds(
                csu_1 * dzt4r * iso.ai_nz[jq][kr] * drodyn
                / (drodzn + EPSLN), kr)

    wbx = [[None, None], [None, None]]
    wby = [[None, None], [None, None]]
    for kr in (0, 1):
        a_k = alphai if kr == 0 else DN(alphai, fill=1.0)
        b_k = betai if kr == 0 else DN(betai, fill=1.0)
        drodzb = a_k * iso.ddzt[0] + b_k * iso.ddzt[1]
        ddxt_k = iso.ddxt if kr == 0 else DN(iso.ddxt)
        ddyt_k = iso.ddyt if kr == 0 else DN(iso.ddyt)
        for ip in (0, 1):
            gxt = ddxt_k if ip == 1 else W(ddxt_k)
            gx = a_k * gxt[0] + b_k * gxt[1]
            w = dxt4r * iso.ai_bx[ip][kr] * cstr * gx / (drodzb + EPSLN)
            w[-1] = 0.0                              # fb zero at bottom
            wbx[ip][kr] = w
        for jq in (0, 1):
            gyt = ddyt_k if jq == 1 else S(ddyt_k)
            gy = a_k * gyt[0] + b_k * gyt[1]
            fy = S(csu_1) if jq == 0 else csu_1
            w = dyt4r * cstr * iso.ai_by[jq][kr] * fy * gy \
                / (drodzb + EPSLN)
            w[-1] = 0.0
            wby[jq][kr] = w
    return dict(we=we, wn=wn, wbx=wbx, wby=wby,
                k11c=iso.K11 * g.cstdxur[None],
                k22c=iso.K22 * (g.csu * g.dyur)[None, :, None])


def iso_weight_stack(wp):
    """(18, km, jmt, imt) stack of the weight pack in the slot order the
    tracer kernel reads: 0..3 we[ip][kr], 4..7 wn[jq][kr], 8..11 wbx
    ordered ([0][0],[1][0],[0][1],[1][1]), 12..15 wby (same order),
    16 k11c, 17 k22c."""
    we, wn, wbx, wby = wp["we"], wp["wn"], wp["wbx"], wp["wby"]
    return torch.stack([we[0][0], we[0][1], we[1][0], we[1][1],
                        wn[0][0], wn[0][1], wn[1][0], wn[1][1],
                        wbx[0][0], wbx[1][0], wbx[0][1], wbx[1][1],
                        wby[0][0], wby[1][0], wby[0][1], wby[1][1],
                        wp["k11c"], wp["k22c"]])


def iso_tendency(t, wp, tmask, g, cyclic=True):
    """The Redi/GM flux-divergence tendency of every tracer from the
    weight pack (``iso_weight_pack``): algebraically the small-angle
    ``isoflux`` and its divergence.  t: (nt, km, jmt, imt)."""
    tE, tN = E(t), N(t)
    tUP, tDN = UP(t), DN(t)

    def vd0(f):           # vdiff kr=0: UP(f) - f (weights zero k=0)
        return UP(f) - f

    def vd1(f):           # vdiff kr=1: f - DN(f) (weights zero km-1)
        return f - DN(f)

    we, wn = wp["we"], wp["wn"]
    fe = (wp["k11c"][None] * (tE - t)
          - we[0][0][None] * vd0(t) - we[0][1][None] * vd1(t)
          - we[1][0][None] * vd0(tE) - we[1][1][None] * vd1(tE))
    fn = (wp["k22c"][None] * (tN - t)
          - wn[0][0][None] * vd0(t) - wn[0][1][None] * vd1(t)
          - wn[1][0][None] * vd0(tN) - wn[1][1][None] * vd1(tN))
    wbx, wby = wp["wbx"], wp["wby"]
    fb = -(wbx[0][0][None] * (t - W(t)) + wbx[1][0][None] * (tE - t)
           + wbx[0][1][None] * (tDN - W(tDN))
           + wbx[1][1][None] * (E(tDN) - tDN)
           + wby[0][0][None] * (t - S(t)) + wby[1][0][None] * (tN - t)
           + wby[0][1][None] * (tDN - S(tDN))
           + wby[1][1][None] * (N(tDN) - tDN))
    return ((fe * E(tmask)[None] - W(fe) * W(tmask)[None])
            * g.cstdxtr[None, None]
            + (fn * N(tmask)[None] - S(fn) * S(tmask)[None])
            * (1.0 / (g.cst * g.dyt))[None, None, :, None]
            + (UP(fb) - fb) * g.dztr[None, :, None, None])
