"""Vertical mixing coefficients: Bryan-Lewis profile, Pacanowski &
Philander Richardson-number mixing and tidal mixing.

Port of ``uvic_tpu.models.ocean.vmix`` (source/mom/vmixc.F, ppmix.F;
O_tidal_kv from updates/08).  Coefficients are at cell bottoms,
(km, jmt, imt).
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import GRAV
from ...ops.eos import dens
from ...ops.stencil import E, N, S, W, setbcx


def bryan_lewis_profile(zw_cm, afkph=0.8, dfkph=1.05, sfkph=4.5e-5,
                        zfkph=2500.0e2):
    """Bryan-Lewis vertical diffusivity Ahv(k) [cm^2/s]: an arctangent
    profile increasing from ~0.3 at the surface to ~1.3 at depth."""
    return afkph + (dfkph / np.pi) * np.arctan(sfkph * (zw_cm - zfkph))


def ppmix_coefficients(t_tracers, u_full, tmask, umask, eos_c, eos_to,
                       eos_so, g, fricmx=50.0, wndmix=10.0,
                       visc_cbu_back=1.0, diff_cbt_back=0.1,
                       visc_cbu_limit=None, diff_cbt_limit=1.0e6,
                       cyclic=True):
    """Pacanowski-Philander Richardson mixing (ppmix.F:202-420).

    Returns (diff_cbt, visc_cbu) at cell bottoms.
    """
    if visc_cbu_limit is None:
        visc_cbu_limit = fricmx
    km = t_tracers.shape[1]
    T, Ssal = t_tracers[0], t_tracers[1]
    # density difference across cell bottoms, lower-level reference
    # coefficients (statec semantics)
    c_dn = eos_c[1:][:, None, None, :]
    to_dn = eos_to[1:][:, None, None]
    so_dn = eos_so[1:][:, None, None]
    rho_up = dens(c_dn, T[:-1] - to_dn, Ssal[:-1] - so_dn)
    rho_dn = dens(c_dn, T[1:] - to_dn, Ssal[1:] - so_dn)
    rhom1z = (rho_up - rho_dn) * tmask[1:]            # (km-1, j, i)

    du = u_full[0][:-1] - u_full[0][1:]
    dv = u_full[1][:-1] - u_full[1][1:]
    uzsq = du ** 2 + dv ** 2                           # at U cells

    # Richardson number at bottom of T cells: average the 4 surrounding
    # U-cell shears (ppmix.F:336-346)
    shear = uzsq + W(uzsq) + S(uzsq) + S(W(uzsq)) + 1.0e-25
    dzw_k = g.dzw[1:km].reshape(km - 1, 1, 1)
    rit = (-4.0 * GRAV) * dzw_k * rhom1z / shear
    t2 = 1.0 / (1.0 + 5.0 * rit)
    diff_cbt = (fricmx * t2 ** 3 + diff_cbt_back) * tmask[1:]
    visc_cbt = (fricmx * t2 ** 2 + visc_cbu_back) * tmask[1:]

    # gravitational instability -> large coefficients (ppmix.F:354-362)
    unstable = rhom1z > 0.0
    diff_cbt = torch.where(unstable, torch.full_like(diff_cbt,
                                                     diff_cbt_limit),
                           diff_cbt)
    visc_cbt = torch.where(unstable, torch.full_like(visc_cbt,
                                                     visc_cbu_limit),
                           visc_cbt)
    visc_cbt = setbcx(visc_cbt, cyclic)

    # viscosity at U-cell bottoms: 4-point average (ppmix.F:370-378)
    visc_cbu = 0.25 * (visc_cbt + E(visc_cbt) + N(visc_cbt)
                       + N(E(visc_cbt))) * umask[1:]

    # wind-mixing floor at the first interface; zero bottom flux
    diff_cbt[0] = torch.maximum(diff_cbt[0], wndmix * tmask[1])
    visc_cbu[0] = torch.maximum(visc_cbu[0], wndmix * umask[1])

    pad = torch.zeros_like(diff_cbt[:1])
    diff_cbt = torch.cat([diff_cbt, pad], dim=0)
    visc_cbu = torch.cat([visc_cbu, pad], dim=0)
    return setbcx(diff_cbt, cyclic), setbcx(visc_cbu, cyclic)


def tidal_kv_diff(drodzb, kmt, zw_cm, tlat_deg, edr, base_diff,
                  zeta_cm=500.0e2, kappa_cap=100.0):
    """Tidal-mixing vertical diffusivity (O_tidal_kv, updates/08
    vmixc.F:55-120; Simmons et al. 2004 / Schmittner & Egbert 2013).

    kappa(k) = ogamma * edr(k) / N^2 where edr(k) sums the tidal
    energy dissipation of every deeper level with the exponential
    vertical structure exp(-(zw(k1)-zw(k))/zeta) normalized by
    (1 - exp(-zw(k1)/zeta)).  Returns the full diff_cbt field
    max(base, min(cap, kappa + base)) (vmixc.F:112-118) on interior
    faces of wet columns, ``base_diff`` elsewhere.

    drodzb : (km, jmt, imt) d(rho)/dz at T-cell bottoms (isopyc)
    edr    : (km, jmt, imt) combined dissipation [g/s^3]
    """
    km = drodzb.shape[0]
    rho0r = 1.0 / 1.035
    zetar = 1.0 / zeta_cm
    ogamma = 0.2 * rho0r * zetar          # Osborn 1980 / (zeta rho0)

    levels = torch.arange(km, device=drodzb.device).reshape(km, 1, 1)
    zw_k = zw_cm[:km].reshape(km, 1, 1)
    # w(k1) = E(k1) exp(-zw(k1)/zeta) / (1 - exp(-zw(k1)/zeta))
    w = edr * torch.exp(-zw_k * zetar) \
        / (1.0 - torch.exp(-zetar * zw_k)) * (levels < kmt[None])
    # suffix sum over k1 > k, then the exp(zw(k)/zeta) prefactor
    suffix = torch.flip(torch.cumsum(torch.flip(w, [0]), dim=0), [0])
    s_above = torch.cat([suffix[1:], torch.zeros_like(w[:1])], dim=0)
    edr_k = torch.exp(zw_k * zetar) * s_above

    zn2 = torch.clamp(-(GRAV * rho0r) * drodzb, min=1e-8)
    diff = torch.minimum(torch.maximum(ogamma * edr_k / zn2 + base_diff,
                                       base_diff),
                         torch.full_like(base_diff, kappa_cap))
    return torch.where(levels < (kmt - 1)[None], diff, base_diff)


def default_tidal_edr(kmt, dzt_cm, ht_cm=None, area=None, e0_gs3=3.5):
    """Tidal-dissipation field when the reference's O_tidenrg data
    file is unavailable (NumPy, host side).

    With bathymetry (``ht_cm``), the column dissipation follows the
    Jayne & St. Laurent (2001) scaling with the topographic-roughness
    factor h^2 ~ |grad H|^2 on the model's own bathymetry, normalized
    so the area-weighted mean column integral stays at ~e0.  Without
    bathymetry, a uniform bottom deposit."""
    km = dzt_cm.shape[0]
    levels = np.arange(km).reshape(km, 1, 1)
    kmtn = np.asarray(kmt)
    is_bot = (levels == np.maximum(kmtn - 1, 0)[None]) & (kmtn > 0)[None]
    e_col = np.full(kmtn.shape, e0_gs3)
    if ht_cm is not None:
        h = np.asarray(ht_cm, dtype=np.float64)
        dhx = np.roll(h, -1, axis=1) - h
        dhy = np.roll(h, -1, axis=0) - h
        dhy[-1] = 0.0
        rough = dhx ** 2 + dhy ** 2
        ocean = kmtn > 0
        rough = np.where(ocean, rough, 0.0)
        mean_r = max(rough[ocean].mean(), 1e-30) if ocean.any() else 1.0
        w = 0.1 + rough / mean_r          # background + roughness
        if area is not None:
            a = np.asarray(area) * ocean
            norm = (w * a).sum() / max(a.sum(), 1e-30)
        else:
            norm = max(w[ocean].mean(), 1e-30) if ocean.any() else 1.0
        e_col = e0_gs3 * w / norm
    return np.where(is_bot, e_col[None], 0.0)
