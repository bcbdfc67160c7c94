"""Idealized zonal-mean surface boundary-condition estimates
(source/mom/bcest.F:1-155).

The port's own copy of ``uvic_tpu.io.bcest`` (NumPy only, unchanged).

The reference interpolates 4.5-deg-spaced global zonal-mean tables of
observed SST / surface salinity (Levitus 1982) and wind stress
(Hellerman & Rosenstein 1983) to a requested latitude, for standalone
ocean runs restored toward idealized climatology.  Here the same four
profiles are authored as smooth analytic fits of those published
zonal means (the in-repo data policy: core/earth.py authors all
data-file stand-ins analytically), evaluated at any latitude.

Units match bcest.F: wsx/wsy [dyn cm^-2], sst [degC], sss [psu].
"""

from __future__ import annotations

import numpy as np


def bcest(tlat_deg, ulat_deg):
    """(wsx, wsy, sst, sss) at T latitude ``tlat_deg`` (SST/SSS) and
    U latitude ``ulat_deg`` (stress) — bcest.F's per-row contract.
    Accepts scalars or arrays."""
    tl = np.asarray(tlat_deg, dtype=float)
    ul = np.asarray(ulat_deg, dtype=float)

    # SST: Levitus-shaped zonal mean — ~27 C equatorial plateau,
    # asymmetric hemispheres (NH warmer at high lat), freezing floor
    latr = np.deg2rad(tl)
    sst = -1.9 + 28.9 * np.maximum(np.cos(latr), 0.0) ** 1.8
    sst = sst + 1.5 * np.exp(-((tl - 55.0) / 18.0) ** 2)   # N Atl drift
    sst = np.maximum(sst, -1.9)

    # SSS: subtropical maxima ~35.7, equatorial minimum, fresh poles
    sss = (34.7 + 1.0 * np.exp(-((np.abs(tl) - 25.0) / 14.0) ** 2)
           - 0.75 * np.exp(-(tl / 9.0) ** 2)
           - 1.4 * np.clip((np.abs(tl) - 50.0) / 35.0, 0.0, None))

    # zonal wind stress: easterly trades (negative), midlat westerlies
    # (H&R peak ~1.2 dyn/cm^2 SH, ~0.9 NH), weak polar easterlies
    wsx = (-0.55 * np.exp(-((np.abs(ul) - 13.0) / 9.0) ** 2)
           + 0.9 * np.exp(-((ul - 44.0) / 11.0) ** 2)
           + 1.2 * np.exp(-((ul + 49.0) / 11.0) ** 2)
           - 0.25 * np.exp(-((np.abs(ul) - 72.0) / 7.0) ** 2))
    # meridional stress: small convergence toward the ITCZ
    wsy = 0.15 * np.sign(ul) * np.exp(-((np.abs(ul) - 12.0) / 10.0) ** 2)
    return wsx, wsy, sst, sss


def bcest_fields(grid, dtype=np.float64):
    """(jmt, imt) 2-D broadcast of the bcest profiles for the model's
    T/U rows: dict(wsx, wsy, sst, sss) — the restoring-climatology /
    idealized-stress provider for standalone ocean runs."""
    wsx, wsy, sst, sss = bcest(np.asarray(grid.yt),
                               np.asarray(grid.yu))
    jmt, imt = grid.jmt, grid.imt

    def b(v):
        return np.broadcast_to(np.asarray(v, dtype)[:, None],
                               (jmt, imt)).copy()

    return dict(wsx=b(wsx), wsy=b(wsy), sst=b(sst), sss=b(sss))
