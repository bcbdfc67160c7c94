"""Anisotropic lateral mixing schemes (updates/03+ hmixc.F, isopyc.F).

O_anisotropic_viscosity — Large et al. (2001, JPO) as coded by
C. Somes (updates/08 hmixc.F:66-147): in the tropics (|lat| <= 20) and
upper ocean (z <= 550 m) the meridional viscosity is the max of a Munk
western-boundary-layer scale (decaying with distance from the western
boundary) and an eddy scale, while the zonal viscosity is a
grid-dependent velocity scale; elsewhere both revert to the constant
``am``.  The fields are static — evaluated once on the host.

O_anisotropic_zonal_mixing — Getzlaff & Dietze (2013, GRL): enhanced
ZONAL equatorial isopycnal diffusivity, tapered linearly from full
amplitude inside |lat| < 5 to zero at |lat| > 10 (updates/08
isopyc.F:243-260 reads the field from O_ISOP data; here the documented
analytic default reproduces the paper's shape with a configurable
amplitude).
"""

from __future__ import annotations

import numpy as np

V0_CMS = 100.0          # hmixc.F:79 velocity scale [cm/s]
AEDDY = 1.0e7           # hmixc.F:81 eddy viscosity floor [cm^2/s]
N_PROTECT = 3.0         # hmixc.F:82 Munk-layer width in cells
BETA0 = 0.0228e-11      # hmixc.F:86 planetary beta [1/(cm s)] at eq
TROPICS_DEG = 20.0
UPPER_CM = 55000.0      # 550 m


def wbc_distance(umask_surf, cyclic=True, maxd=11):
    """Distance (cells) to the western boundary: smallest d in 1..10
    with land d cells to the west, else 11 (hmixc.F:91-114)."""
    m = np.asarray(umask_surf) > 0
    jmt, imt = m.shape
    d = np.full((jmt, imt), float(maxd))
    for k in range(maxd - 1, 0, -1):
        west = np.roll(m, k, axis=1) if cyclic else np.pad(
            m, ((0, 0), (k, 0)))[:, :imt]
        d = np.where(~west, float(k), d)
    return d


def large_anisotropic_viscosity(yu_deg, dxu_cm, dyu_cm, umask_surf,
                                zw_cm, am, cyclic=True):
    """(visc_ceu, visc_cnu) of shape (km, jmt, imt), hmixc.F:66-147."""
    yu = np.asarray(yu_deg)[:, None]
    coslat = np.abs(np.cos(np.deg2rad(yu)))
    dxu = np.asarray(dxu_cm)[None, :]
    dyu = np.asarray(dyu_cm)[:, None]
    zw = np.asarray(zw_cm)
    km = zw.shape[0]

    beta = BETA0 * coslat
    delx = dxu * coslat
    wbc = wbc_distance(umask_surf, cyclic)
    px = np.maximum(0.0, wbc - N_PROTECT) * delx / 1.0e8
    bmunk = 0.2 * beta * delx ** 3 * np.exp(-px ** 2)
    beddy = AEDDY * (1.0 + 24.5
                     * (1.0 - np.abs(np.cos(2.0 * np.deg2rad(yu)))))
    cnu2d = np.maximum(bmunk, beddy)

    gridlen = np.maximum(delx, dyu + 0.0 * delx)
    ceu2d = 0.5 * V0_CMS * gridlen

    in_trop = (np.abs(yu) <= TROPICS_DEG) + np.zeros_like(delx,
                                                          dtype=bool)
    upper = (zw <= UPPER_CM)[:, None, None]
    gate = upper & in_trop[None]
    visc_cnu = np.where(gate, cnu2d[None], am)
    visc_ceu = np.where(gate, ceu2d[None], am)
    return visc_ceu, visc_cnu


def equatorial_zonal_diffusivity(yt_deg, amp=5.0e8, inner=5.0,
                                 outer=10.0):
    """GD13 zonal isopycnal diffusivity addition [cm^2/s] vs latitude:
    full amplitude inside |lat| < inner, linear taper to zero at
    |lat| = outer (isopyc.F:246-259 'smooth values linearly between
    5-10 deg N/S')."""
    a = np.abs(np.asarray(yt_deg, np.float64))
    w = np.clip((outer - a) / (outer - inner), 0.0, 1.0)
    return amp * w
