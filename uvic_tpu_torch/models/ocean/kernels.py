"""Ocean dynamical-core stencils: advection velocities, the generic
tracer update and the baroclinic momentum update (torch).

Port of ``uvic_tpu.models.ocean.kernels`` (source/mom/adv_vel.F,
tracer.F, clinic.F with the finite-difference numerics of
fdift.h/fdifm.h).  Array layout is ``(..., km, jmt, imt)``.  The model's
own step takes the fused FCT tracer update of ``ops/tracer_kernel.py``
(the kernel and its plain version) where the reference takes its fused
kernel (FCT dlm1, no 3-D delimiter, constant hmix); ``tracer_step`` here
is the reference's generic form, for every other scheme and mixing
option and for the transport-matrix extraction (``diag/tmm.py``).

All velocities passed in are *full* velocities (internal + external
mode); the caller reconstructs them from the streamfunction.
"""

from __future__ import annotations

import torch

from ...ops.advection import (centered_flux, fct_flux, quicker_flux,
                              upstream_flux)
from ...ops.stencil import DN, E, N, S, UP, W, setbcx, zero_east
from ...ops.tridiag import invtri_columns


def adv_vel(u, v, g, cyclic=True):
    """Face advection velocities from the full B-grid velocity
    (adv_vel.F:1-253).

    u, v : (km, jmt, imt) full velocities at tau
    g    : parameter bag with grid factor tensors (see model.py)
    returns (vet, vnt, vbt, veu, vnu, vbu); vbt/vbu are at cell bottoms
    with the rigid-lid surface face = 0.
    """
    dxu = g.dxu[None, None, :]
    dyu = g.dyu[None, :, None]
    csu_j = g.csu[None, :, None]

    # north face of T cells: adv_vnt = x-average of (v dxu) * csu / dxt
    vnt = (v * dxu + W(v) * W(dxu)) * csu_j * g.dxt2r[None, None, :]
    vnt = setbcx(vnt, cyclic)

    # east face of T cells: y-average of (u dyu) / dyt
    vet = (u * dyu + S(u) * S(dyu)) * g.dyt2r[None, :, None]

    # bottom face of T cells: integrate the divergence downward
    div = ((vet - W(vet)) * g.dxtr[None, None, :]
           + (vnt - S(vnt)) * g.dytr[None, :, None]) \
        * g.cstr[None, :, None] * g.dzt[:, None, None]
    vbt = setbcx(torch.cumsum(div, dim=0), cyclic)

    # north face of U cells: x/y interpolation of vnt (adv_vel.F:166-185)
    duw = g.duw[None, None, :]
    due = g.due[None, None, :]
    dus_jp1 = N(g.dus[None, :, None])
    dun_j = g.dun[None, :, None]
    vnu = ((vnt * duw + E(vnt) * due) * dus_jp1
           + (N(vnt) * duw + N(E(vnt)) * due) * dun_j) \
        * N(g.dytr[None, :, None]) * g.dxur[None, None, :]
    vnu = setbcx(vnu, cyclic)

    # east face of U cells (adv_vel.F:194-219)
    dus_j = g.dus[None, :, None]
    vue = ((vet * dus_j + N(vet) * dun_j) * E(duw)
           + (E(vet) * dus_j + N(E(vet)) * dun_j) * due) \
        * g.dyur[None, :, None] * E(g.dxtr[None, None, :])
    veu = setbcx(vue, cyclic) if cyclic else zero_east(vue, cyclic)

    # bottom face of U cells: area-weighted average of vbt (adv_vel.F:226-249)
    dyn = dun_j * N(g.cst[None, :, None])
    dys = dus_j * g.cst[None, :, None]
    dyr = g.dyur[None, :, None] * g.csur[None, :, None]
    vbu = dyr * g.dxur[None, None, :] * (
        vbt * (duw * dys) + E(vbt) * (due * dys)
        + N(vbt) * (duw * dyn) + N(E(vbt)) * (due * dyn))
    vbu = setbcx(vbu, cyclic)

    return vet, vnt, vbt, veu, vnu, vbu


def tracer_step(t_tau, t_tm1, vet, vnt, vbt, stf, btf, source,
                diff_cbt, kmt, tmask, g, c2dtts, scheme: str,
                aidif: float, cyclic=True, iso=None, hmix=None,
                fct_variant="dlm1", fct3d=False):
    """One tracer timestep for all tracers (tracer.F:678-916).

    t_tau/t_tm1 : (nt, km, jmt, imt)
    vet/vnt/vbt : total advective velocities (incl. GM where enabled)
    stf/btf     : (nt, jmt, imt) surface/bottom tracer fluxes
    source      : (nt, km, jmt, imt) or None
    diff_cbt    : (km, jmt, imt) vertical diffusivity at cell bottoms
                  (with the K33 isopycnal addition folded in by the caller)
    iso         : IsopycFields for the Redi flux additions (``isoflux``),
                  or None
    hmix        : None (const ah) | ("smagnl", diff_cet, diff_cnt)
                  | ("biharmonic", ahbi) — variable horizontal mixing;
                  not taken when ``iso`` is given (the reference's
                  precedence, tracer.F consthmix/isopycmix branches)
    scheme      : "fct" (``fct_variant`` "dlm1"/"dlm2", ``fct3d``),
                  "centered", "upstream" or "quicker" (``g.quicker``)
    returns t at tau+1 (before convection/filtering).
    """
    km = t_tau.shape[1]
    twodt = (c2dtts * g.dtxcel).reshape(km, 1, 1)
    cstdxt2r = g.cstdxt2r[None]      # (1, jmt, imt) broadcast over k
    cstdxtr = g.cstdxtr[None]
    cstdyt2r = g.cstdyt2r[None, :, None]
    dzt2r = g.dzt2r[:, None, None]
    dztr = g.dztr[:, None, None]

    # advective fluxes per scheme (2x flux convention)
    if scheme == "fct":
        fe, fn, fb = fct_flux(t_tau, t_tm1, vet[None], vnt[None], vbt[None],
                              tmask[None], twodt[None], g.cstdxt2r,
                              g.cstdyt2r[:, None], dzt2r, cyclic,
                              variant=fct_variant, fct3d=fct3d)
    elif scheme == "centered":
        fe, fn, fb = centered_flux(t_tau, vet[None], vnt[None], vbt[None])
    elif scheme == "upstream":
        fe, fn, fb = upstream_flux(t_tm1, vet[None], vnt[None], vbt[None])
    elif scheme == "quicker":
        fe, fn, fb = quicker_flux(t_tau, t_tm1, vet[None], vnt[None],
                                  vbt[None], tmask[None], g.quicker)
    else:
        raise ValueError(scheme)
    adv_tx = (fe - W(fe)) * cstdxt2r[None]
    adv_ty = (fn - S(fn)) * cstdyt2r[None]
    adv_tz = (UP(fb) - fb) * dzt2r[None]

    # horizontal diffusive fluxes (consthmix path, tracer.F:691-798)
    fb_iso = None
    if hmix is not None and iso is None:
        from .hmix import tracer_hdiff_bihar, tracer_hdiff_var
        if hmix[0] == "smagnl":
            diff_tx = tracer_hdiff_var(t_tm1, tmask, g, hmix[1], hmix[2])
        else:
            diff_tx = tracer_hdiff_bihar(t_tm1, tmask, g, hmix[1], cyclic)
        diff_ty = torch.zeros_like(diff_tx)
    elif iso is not None:
        # isopycnal path: flux-form meridional diffusion plus the Redi
        # additions to the east/north fluxes (tracer.F:711-727, isoflux)
        from .isopyc import isoflux
        fe_iso, fn_iso, fb_iso = isoflux(iso, t_tm1, tmask, g, cyclic)
        diff_fe = g.ah * g.cstdxur[None, None] * (E(t_tm1) - t_tm1) + fe_iso
        diff_fn = (g.ah * (g.csu * g.dyur)[None, None, :, None]
                   * (N(t_tm1) - t_tm1)) + fn_iso
        diff_ty = (diff_fn * N(tmask)[None]
                   - S(diff_fn) * S(tmask)[None]) \
            * (1.0 / (g.cst * g.dyt))[None, None, :, None]
        diff_tx = (diff_fe * E(tmask)[None]
                   - W(diff_fe) * W(tmask)[None]) * cstdxtr[None]
    else:
        diff_fe = g.ah * g.cstdxur[None, None] * (E(t_tm1) - t_tm1)
        ahc_n = g.ahc_north[None, None, :, None]
        ahc_s = g.ahc_south[None, None, :, None]
        diff_ty = (ahc_n * N(tmask)[None] * (N(t_tm1) - t_tm1)
                   - ahc_s * S(tmask)[None] * (t_tm1 - S(t_tm1)))
        diff_tx = (diff_fe * E(tmask)[None]
                   - W(diff_fe) * W(tmask)[None]) * cstdxtr[None]

    # vertical diffusive flux through cell bottoms (tracer.F:787-798);
    # broadcasting t (nt,km,j,i) against diff_cbt (km,j,i)
    dzwr = g.dzwr[1:].reshape(km, 1, 1)   # 1/dzw(k) at bottom of cell k
    diff_fb = diff_cbt[None] * dzwr[None] * (t_tm1 - DN(t_tm1))
    diff_fb[..., -1, :, :] = 0.0
    # bottom b.c.: replace the flux at the bottom of the deepest ocean cell
    levels = torch.arange(km, device=t_tau.device).reshape(km, 1, 1)
    is_bot = (levels == (kmt - 1)[None])[None]
    diff_fb = torch.where(is_bot, btf[:, None], diff_fb)
    # surface b.c. enters level 0 as stf
    fb_above = UP(diff_fb)
    fb_above[:, 0] = stf
    diff_tz = (fb_above - diff_fb) * dztr[None] * (1.0 - aidif)
    if fb_iso is not None:
        # explicit K31/K32 isopycnal vertical flux (fdift.h:87-89)
        diff_tz = diff_tz + (UP(fb_iso) - fb_iso) * dztr[None]

    tend = diff_tx + diff_ty + diff_tz - adv_tx - adv_ty - adv_tz
    if source is not None:
        tend = tend + source
    t_new = t_tm1 + twodt[None] * tend * tmask[None]

    # implicit part of the vertical diffusion (tracer.F:899, ivdift:1691)
    if aidif > 0.0:
        t_new = invtri_columns(t_new, stf, btf, diff_cbt, c2dtts * g.dtxcel,
                               kmt, tmask, g.dztr, g.dztur, g.dztlr, aidif)
    return setbcx(t_new, cyclic)


def iso_flux_tendency(iso, t_tm1, tmask, g, cyclic=True):
    """The Redi/GM part of the isopycnal tracer tendency: the divergence
    of ``isoflux``'s additions to the east, north and bottom fluxes, as
    ``tracer_step`` adds them (tracer.F:711-727, fdift.h:87-89).  The
    fused tracer step takes it as a source where the weight stack does
    not apply (O_full_tensor)."""
    from .isopyc import isoflux
    fe, fn, fb = isoflux(iso, t_tm1, tmask, g, cyclic)
    return ((fe * E(tmask)[None] - W(fe) * W(tmask)[None])
            * g.cstdxtr[None, None]
            + (fn * N(tmask)[None] - S(fn) * S(tmask)[None])
            * (1.0 / (g.cst * g.dyt))[None, None, :, None]
            + (UP(fb) - fb) * g.dztr[None, :, None, None])


def hydrostatic_grad_p(rho, g, cyclic=True):
    """Hydrostatic pressure gradients at U points (clinic.F:84-169).

    rho : (km, jmt, imt) density anomaly at tau
    returns grad_p (2, km, jmt, imt).
    """
    grav_rho0r = g.grav_rho0r
    csur = g.csur[None, :, None]
    dzw = g.dzw  # (km+1,)

    # level-1 gradient from the surface density
    t1 = N(E(rho)) - rho
    t2 = N(rho) - E(rho)
    gp1_sfc = (t1[0] - t2[0]) * (grav_rho0r * dzw[0]) * csur[0] \
        * g.dxu2r[None, :]
    gp2_sfc = (t1[0] + t2[0]) * (grav_rho0r * dzw[0]) * g.dyu2r[:, None]

    # incremental gradients between levels
    tempik = UP(rho) + rho                      # rho(k-1)+rho(k), k>=1
    t1k = N(E(tempik)) - tempik
    t2k = N(tempik) - E(tempik)
    dzw_above = dzw[:-1].reshape(-1, 1, 1)      # dzw(k-1) for level k
    gp1 = (grav_rho0r * 0.5) * csur * (t1k - t2k) * dzw_above \
        * g.dxu2r[None, None, :]
    gp2 = grav_rho0r * g.dyu4r[None, :, None] * (t1k + t2k) * dzw_above
    gp1[0] = gp1_sfc
    gp2[0] = gp2_sfc

    grad_p = torch.stack([torch.cumsum(gp1, dim=0),
                          torch.cumsum(gp2, dim=0)])
    return setbcx(grad_p, cyclic)


def clinic_step(u_tau, u_tm1, rho, veu, vnu, vbu, smf, bmf,
                visc_cbu, kmu, umask, g, c2dtuv, cyclic=True,
                hmix=None, unep=None):
    """Baroclinic momentum step (clinic.F:1-500).

    u_tau/u_tm1 : (2, km, jmt, imt) full velocities
    rho         : (km, jmt, imt) density anomaly at tau
    smf/bmf     : (2, jmt, imt) surface/bottom momentum fluxes
    hmix        : None (const am Laplacian)
                  | ("aniso", visc_ceu, visc_cnu): the Large et al.
                    (2001) anisotropic viscosity
                  | ("smagnl", strain, am_lambda, am_phi, sine)
                  | ("biharmonic", ambi)
    unep        : optional (2, jmt, imt) Neptune equilibrium velocity
                  (O_neptune): the const-hmix lateral friction acts on
                  u - unep instead of u (fdifm.h neptune branches,
                  clinic.F:210-220)
    returns (u_int_new, zu): internal-mode velocity at tau+1 with the
    vertical mean removed, and the barotropic forcing zu (2, jmt, imt).
    """
    km = u_tau.shape[1]
    grad_p = hydrostatic_grad_p(rho, g, cyclic)

    csudxu2r = g.csudxu2r[None]
    csudxur = g.csudxur[None]
    csudyu2r = g.csudyu2r[None, :, None]
    dzt2r = g.dzt2r[:, None, None]
    dztr = g.dztr[:, None, None]
    am_csudxtr = (g.am * g.csur[:, None] * E(g.dxtr)[None, :])[None]
    amc_n = g.amc_north[None, :, None]
    amc_s = g.amc_south[None, :, None]
    am3 = g.am3[None, :, None]
    dxmetr = g.dxmetr[None, None, :]
    dzwr = g.dzwr[1:].reshape(km, 1, 1)
    levels = torch.arange(km, device=u_tau.device).reshape(km, 1, 1)
    is_bot = levels == (kmu - 1)[None]

    u_new = []
    zu = []
    for n in range(2):
        un_tau = u_tau[n]
        un_tm1 = u_tm1[n]
        other_tau = u_tau[1 - n]
        other_tm1 = u_tm1[1 - n]
        if unep is not None:
            # Neptune: lateral friction relaxes toward the topographic
            # equilibrium flow (u - unep in every const-hmix
            # diffusive/metric term, fdifm.h O_neptune)
            un_d = un_tm1 - unep[n][None] * umask
            other_d = other_tm1 - unep[1 - n][None] * umask
        else:
            un_d, other_d = un_tm1, other_tm1

        # advective fluxes (2x) across faces of U cells; DN zero-fill
        # at the bottom reproduces adv_fb(i,km,j) = adv_vbu*u (clinic.F:279)
        adv_fe = veu * (un_tau + E(un_tau))
        adv_fb = vbu * (un_tau + DN(un_tau))
        adv_ux = (adv_fe - W(adv_fe)) * csudxu2r
        adv_uy = (vnu * (un_tau + N(un_tau))
                  - S(vnu) * (S(un_tau) + un_tau)) * csudyu2r
        adv_uz = (UP(adv_fb) - adv_fb) * dzt2r
        adv_metric = g.advmet[n][None, :, None] * u_tau[0] * other_tau

        # lateral friction
        diff_metric = None
        if hmix is not None and hmix[0] == "smagnl":
            from .hmix import smag_momentum_terms
            diff_ux, diff_uy, diff_metric = smag_momentum_terms(
                hmix[1], hmix[2], hmix[3], g, hmix[4], n)
        elif hmix is not None and hmix[0] == "aniso":
            # updates/08 clinic.F:75-82, 223-236: 3-D visc_ceu on zonal
            # faces, visc_cnu in the meridional flux coefficients; the
            # metric terms keep the constant-am form
            visc_ceu, visc_cnu = hmix[1], hmix[2]
            diff_fe = visc_ceu * (am_csudxtr / g.am) * (E(un_d) - un_d)
            diff_ux = (diff_fe - W(diff_fe)) * csudxur
            diff_uy = (visc_cnu * (amc_n / g.am) * (N(un_d) - un_d)
                       - visc_cnu * (amc_s / g.am) * (un_d - S(un_d)))
        elif hmix is not None:
            from .hmix import momentum_bihar_terms
            diff_ux = momentum_bihar_terms(u_tm1, umask, g, hmix[1], n,
                                           cyclic)
            diff_uy = torch.zeros_like(diff_ux)
            diff_metric = torch.zeros_like(diff_ux)
        else:
            diff_fe = am_csudxtr * (E(un_d) - un_d)
            diff_ux = (diff_fe - W(diff_fe)) * csudxur
            diff_uy = (amc_n * (N(un_d) - un_d)
                       - amc_s * (un_d - S(un_d)))
        diff_fb = visc_cbu * dzwr * (un_tm1 - DN(un_tm1))
        diff_fb[-1] = 0.0
        diff_fb = torch.where(is_bot, bmf[n][None], diff_fb)
        fb_above = UP(diff_fb)
        fb_above[0] = smf[n]
        diff_uz = (fb_above - diff_fb) * dztr
        if diff_metric is None:
            diff_metric = (am3 * un_d
                           + g.am4[n][None, :, None] * dxmetr
                           * (E(other_d) - W(other_d)))

        coriolis = g.cori[n][None] * other_tau

        tend = (diff_ux + diff_uy + diff_uz + diff_metric
                - adv_ux - adv_uy - adv_uz + adv_metric
                - grad_p[n] + coriolis) * umask

        # barotropic forcing: depth average of du/dt (clinic.F:364-404)
        zu.append(torch.einsum("kji,k->ji", tend, g.dzt) * g.hr)
        u_new.append(un_tm1 + c2dtuv * tend)

    u_new = torch.stack(u_new)
    zu = torch.stack(zu)

    # remove the (incorrect) vertical mean to leave pure internal modes
    baru = torch.einsum("nkji,k->nji", u_new, g.dzt) * g.hr[None]
    u_int = (u_new - umask[None] * baru[:, None]) * umask[None]
    return setbcx(u_int, cyclic), setbcx(zu, cyclic)
