"""Neptune topographic stress (O_neptune, source/mom/neptune.F:1-109).

Port of ``uvic_tpu.models.ocean.neptune``.  Holloway's eddy-topography
interaction parameterization: the lateral friction relaxes the flow
toward a topography-determined equilibrium velocity u_nep instead of
toward rest.  The equilibrium field comes from a pseudo-streamfunction
pnep = -f * snep^2 * H with the latitude-dependent length scale
snep = spnep + (senep - spnep) * (1/2 + 1/2 cos(2 lat)) (cnep.h:14-21),
differentiated exactly like the external-mode velocity (neptune.F:70-85
uses the same diagonal-difference stencil as add_ext_mode).

Host-side NumPy, computed once at model build.
"""

from __future__ import annotations

import numpy as np

from ...constants import OMEGA


def neptune_velocity(grid, topo, spnep: float = 3.0e5,
                     senep: float = 12.0e5) -> np.ndarray:
    """(2, jmt, imt) equilibrium Neptune velocity at U cells [cm/s]."""
    jmt, imt = grid.jmt, grid.imt
    km = grid.km
    kmu = np.asarray(topo.kmu)

    # kmz: min of the four surrounding U-cell depths (neptune.F:34-42)
    kmz = np.zeros((jmt, imt), dtype=int)
    kmz[1:, 1:] = np.minimum.reduce([
        kmu[:-1, :-1], kmu[1:, :-1], kmu[:-1, 1:], kmu[1:, 1:]])

    tlat = np.deg2rad(np.asarray(grid.yt))[:, None]
    f = 2.0 * OMEGA * np.sin(tlat)
    snep = spnep + (senep - spnep) * (0.5 + 0.5 * np.cos(2.0 * tlat))
    zw = np.asarray(grid.zw)
    hnep = np.where(kmz > 0, zw[np.clip(kmz, 1, km) - 1], 0.0)
    pnep = -f * snep ** 2 * hnep
    if grid.cyclic:
        pnep[:, 0] = pnep[:, -2]
        pnep[:, -1] = pnep[:, 1]

    # same diagonal differences as add_ext_mode (neptune.F:70-85)
    hr = np.asarray(topo.hr)
    dyu2r = np.asarray(grid.dyu2r)[:, None]
    dxu2r = np.asarray(grid.dxu2r)[None, :]
    csur = np.asarray(grid.csur)[:, None]
    unep = np.zeros((2, jmt, imt))
    d1 = np.zeros((jmt, imt))
    d0 = np.zeros((jmt, imt))
    d1[1:-1, 1:-1] = pnep[2:, 2:] - pnep[1:-1, 1:-1]
    d0[1:-1, 1:-1] = pnep[2:, 1:-1] - pnep[1:-1, 2:]
    unep[0] = -(d1 + d0) * dyu2r * hr
    unep[1] = (d1 - d0) * dxu2r * csur * hr
    if grid.cyclic:
        unep[:, :, 0] = unep[:, :, -2]
        unep[:, :, -1] = unep[:, :, 1]
    return unep
