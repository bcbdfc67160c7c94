"""Ocean circulation diagnostics: energetics, meridional overturning,
and northward tracer-transport (gyre) components, in PyTorch.

Port of ``uvic_tpu.diag.energy`` (source/mom/energy.F, gyre.F,
diagi.F/diago.F overturning output): each diagnostic is a function of
the full 3-D fields, the zonal and vertical integrals single reductions.

``g`` is the ocean model's parameter bag (``OceanModel.g``), read under
the reference's names (dxu, csu, dzt, dxt, zt, cst, dyt, hr, dxu2r,
dyu2r, csur).  All quantities are CGS (transports in cm^3/s = 1e-12 Sv;
energies in erg).  Heat transport in cal/s follows the reference's
heat-flux unit convention (multiply by rho0*cp externally for W).
"""

from __future__ import annotations

import torch

from ..models.ocean.kernels import adv_vel
from ..models.ocean.tropic import ext_mode_velocity

SV_CGS = 1.0e12  # 1 Sverdrup in cm^3/s


def _no_cyclic_columns(a):
    """Ones shaped like ``a`` (jmt, imt) but for the duplicated cyclic
    boundary columns 0 and imt-1."""
    xmask = torch.ones_like(a)
    xmask[:, 0] = 0.0
    xmask[:, -1] = 0.0
    return xmask


# ----------------------------------------------------------------------
# meridional overturning streamfunction
# ----------------------------------------------------------------------

def meridional_overturning(v, g, umask):
    """Meridional overturning streamfunction psi_moc(k, j) in cm^3/s:
    psi(k, j) = -int_{-H}^{z_k} int_x v dx dz through the U-point row
    (diagi.F "meridional overturning of mass").

    v     : (km, jmt, imt) full northward velocity at tau
    umask : (km, jmt, imt)

    Divide by 1e12 for Sv.
    """
    xmask = _no_cyclic_columns(v[0])
    trans = torch.sum(v * umask * xmask
                      * (g.dxu * g.csu[:, None])[None], dim=2) \
        * g.dzt[:, None]                                  # (km, jmt)
    return -torch.cumsum(trans, dim=0)


def gm_overturning(vntiso, g, xmask2d=None):
    """Overturning streamfunction of the GM eddy-induced (bolus)
    velocity, psi_gm(k, j) in cm^3/s (diago.F O_gm_diag).

    vntiso : (km, jmt, imt) bolus meridional velocity at T-cell north
             faces (the csu metric factor folded in: the zonal integral
             takes dxt only).
    xmask2d: optional (jmt, imt) column mask (an Atlantic basin mask,
             say) on top of the cyclic-duplicate exclusion.
    """
    xmask = _no_cyclic_columns(vntiso[0])
    if xmask2d is not None:
        xmask = xmask * xmask2d
    trans = torch.sum(vntiso * xmask * g.dxt[None, None, :], dim=2) \
        * g.dzt[:, None]                                   # (km, jmt)
    return -torch.cumsum(trans, dim=0)


def overturning_extrema(psi_moc, g):
    """Max/min overturning (Sv) and the NADW-style max below 500 m."""
    deep = g.zt >= 500.0e2
    return {
        "moc_max_sv": torch.max(psi_moc) / SV_CGS,
        "moc_min_sv": torch.min(psi_moc) / SV_CGS,
        "moc_deep_max_sv": torch.max(
            torch.where(deep[:, None], psi_moc, -torch.inf)) / SV_CGS,
    }


# ----------------------------------------------------------------------
# northward tracer transport components (gyre.F)
# ----------------------------------------------------------------------

def gyre_components(v, t_n, g, tmask, smf=None, cori=None):
    """Northward transport of tracer n split into components
    (gyre.F:1-140 ttn(1..8)), each a (jmt,) tensor:

      total_adv      ttn(6): int adv_vnt * Tbar_face dx dz
      overturning    ttn(1): sum_k [int v dx] * [zonal-mean T] dz
      gyre           ttn(2) = total_adv - overturning
      depth_mean     ttn(3): sum_x [int v dz] * [depth-mean T]
      ekman          ttn(5) (0 without smf and cori)
      residual       ttn(4) = total_adv - depth_mean - ekman

    smf : optional (2, jmt, imt) surface momentum flux; cori : optional
    (jmt, imt) Coriolis parameter at U points.
    """
    small = 1e-10
    u0 = torch.zeros_like(v)
    _, vnt, *_ = adv_vel(u0, v, g, cyclic=True)
    dxt = g.dxt[None, None, :]
    dzt = g.dzt[:, None]
    tmask_n = torch.roll(tmask, -1, dims=1)
    mask_pair = tmask * tmask_n
    t_north = torch.roll(t_n, -1, dims=1)

    # ttn(6): total advective transport through the north face
    tot = torch.sum(0.5 * vnt * (t_n + t_north) * mask_pair * dxt,
                    dim=2) * dzt                           # (km, jmt)
    total_adv = torch.sum(tot, dim=0)

    # ttn(1): overturning = zonal-int(v) x zonal-mean(T) per level
    dxu = g.dxu[None, None, :]
    vbr = torch.sum(v * dxu * g.csu[None, :, None], dim=2)   # (km, jmt)
    totdxs = torch.sum(dxt * tmask, dim=2) + small
    totdxn = torch.sum(dxt * tmask_n, dim=2) + small
    tbrs = torch.sum(t_n * tmask * dxt, dim=2) / totdxs
    tbrn = torch.sum(t_north * tmask_n * dxt, dim=2) / totdxn
    overturning = torch.sum(vbr * 0.5 * (tbrn + tbrs) * dzt, dim=0)

    # ttn(3): depth-mean component per column, then zonal sum
    totz = torch.sum(mask_pair * g.dzt[:, None, None], dim=0)  # (jmt, imt)
    vbrz = torch.sum(vnt * dxt * g.dzt[:, None, None], dim=0)
    tbrz = torch.where(totz > 0,
                       torch.sum(mask_pair * (t_n + t_north)
                                 * g.dzt[:, None, None], dim=0)
                       / torch.clamp(totz, min=small), 0.0)
    depth_mean = torch.sum(torch.where(totz > 0, vbrz * tbrz * 0.5, 0.0),
                           dim=1)

    # ttn(5): Ekman component from the zonal wind stress
    if smf is not None and cori is not None:
        cori_eff = torch.where(torch.abs(cori) > 0, cori,
                               torch.roll(cori, 1, dims=0))
        factor = 4.0 * cori_eff
        taux_dx = smf[0] * g.dxu[None, :]
        taux_pair = taux_dx + torch.roll(taux_dx, 1, dims=1)
        surf = t_n[0] + t_north[0] - tbrz
        big = torch.abs(factor) > 1e-12
        ek = torch.where((totz > 0) & big,
                         -taux_pair * surf * g.csu[:, None]
                         / torch.where(big, factor, 1.0), 0.0)
        ekman = torch.sum(ek, dim=1)
    else:
        ekman = torch.zeros_like(total_adv)

    return {
        "total_adv": total_adv,
        "overturning": overturning,
        "gyre": total_adv - overturning,
        "depth_mean": depth_mean,
        "ekman": ekman,
        "residual": total_adv - depth_mean - ekman,
    }


# ----------------------------------------------------------------------
# energetics (energy.F)
# ----------------------------------------------------------------------

def energy_integrals(state, model, forcing=None):
    """Global energetics of the B-grid solution (energy.F ge1/ge2):
    kinetic energy split into external and internal modes, the wind work
    on the surface (with ``forcing``) and the largest |psi|.  Returns a
    dict of 0-d tensors (CGS: erg/g, erg/cm^2/s, Sv)."""
    umask = model.umask
    g = model.g

    uext, vext = ext_mode_velocity(state.psi0, g.hr, g.dxu2r, g.dyu2r,
                                   g.csur)
    u_full = state.u[0] + uext[None]
    v_full = state.u[1] + vext[None]

    boxvol = (g.csu[None, :, None] * g.dyu[None, :, None]
              * g.dxu[None, None, :] * g.dzt[:, None, None]) * umask
    vol = torch.sum(boxvol)

    ke_tot = 0.5 * torch.sum((u_full ** 2 + v_full ** 2) * boxvol)
    ke_ext = 0.5 * torch.sum(
        (uext ** 2 + vext ** 2) * torch.sum(boxvol, dim=0))
    ke_int = 0.5 * torch.sum((state.u[0] ** 2 + state.u[1] ** 2) * boxvol)

    out = {
        "ke_total_per_vol": ke_tot / vol,     # cm^2/s^2 (erg/g)
        "ke_external_per_vol": ke_ext / vol,
        "ke_internal_per_vol": ke_int / vol,
        "psi_max_sv": torch.max(torch.abs(state.psi0)) / SV_CGS,
    }
    if forcing is not None:
        area_u = (g.csu[:, None] * g.dyu[:, None] * g.dxu[None, :]) \
            * umask[0]
        out["wind_work_per_area"] = torch.sum(
            (forcing.smf[0] * u_full[0] + forcing.smf[1] * v_full[0])
            * area_u) / torch.clamp(torch.sum(area_u), min=1.0)
    return out


# ----------------------------------------------------------------------
# tracer term balance (termbal.F ttb1, regional volume means)
# ----------------------------------------------------------------------

def tracer_term_balance(t_new, t_old, c2dt, region_masks, g, tmask):
    """Volume-averaged d(tracer)/dt per region (termbal.F ttb1 'dT/dt'
    row), from two time levels.

    region_masks : (nreg, jmt, imt) horizontal region membership
    Returns (nreg, nt) volume-mean tendencies per second.
    """
    grid_vol = (g.cst[None, :, None] * g.dyt[None, :, None]
                * g.dxt[None, None, :] * g.dzt[:, None, None]) * tmask
    dtdt = (t_new - t_old) / c2dt                  # (nt, km, jmt, imt)
    vol_r = torch.einsum("rji,kji->r", region_masks, grid_vol)
    num = torch.einsum("rji,nkji,kji->rn", region_masks, dtdt, grid_vol)
    return num / torch.clamp(vol_r, min=1.0)[:, None]
