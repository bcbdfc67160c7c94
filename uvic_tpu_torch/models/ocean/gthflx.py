"""Geothermal bottom heat flux (O_gthflx, updates/07-10 bhf.F).

Hamza, Cardoso & Ponte Neto (2007) degree-12 spherical-harmonic
expansion of the global conductive heat-flow field, evaluated at every
T cell on the host at init (the field is static).  ``qq`` is in
mW/m^2; the 1/41840000 factor converts to cal/(cm^2 s), the unit of
the ocean's surface/bottom tracer heat fluxes (bhf.F:212-215).  The
flux enters the deepest wet cell as a negative (upward) bottom tracer
flux: setvbc.F (updates/09) btf(i,j,itemp) = -bhf.
"""

from __future__ import annotations

from math import factorial

import numpy as np

# (n, m) -> (anm, bnm), bhf.F:14-209 (Hamza et al. 2007 appendix)
_COEFFS = {
    (0, 0): (86.674, 0.0),
    (1, 0): (-12.999, 0.0),
    (1, 1): (-2.689, -10.417),
    (2, 0): (-1.917, 0.0),
    (2, 1): (4.578, 1.022),
    (2, 2): (-14.076, 6.507),
    (3, 0): (7.122, 0.0),
    (3, 1): (-2.934, 3.555),
    (3, 2): (7.232, -3.295),
    (3, 3): (10.299, 4.646),
    (4, 0): (-3.511, 0.0),
    (4, 1): (2.778, -1.873),
    (4, 2): (1.728, -2.546),
    (4, 3): (-4.822, 0.486),
    (4, 4): (4.408, -17.946),
    (5, 0): (5.316, 0.0),
    (5, 1): (-1.984, -2.642),
    (5, 2): (2.167, 3.835),
    (5, 3): (4.57, -6.087),
    (5, 4): (-8.353, 10.283),
    (5, 5): (-6.896, -4.199),
    (6, 0): (-5.204, 0.0),
    (6, 1): (2.795, 3.162),
    (6, 2): (2.065, -2.889),
    (6, 3): (-2.74, -0.252),
    (6, 4): (-0.012, -1.897),
    (6, 5): (0.637, 0.476),
    (6, 6): (3.739, 7.849),
    (7, 0): (2.01, 0.0),
    (7, 1): (0.912, 0.116),
    (7, 2): (-6.044, -0.179),
    (7, 3): (4.999, -0.123),
    (7, 4): (-1.605, -3.721),
    (7, 5): (-0.334, 3.466),
    (7, 6): (-4.111, -0.639),
    (7, 7): (4.126, -1.659),
    (8, 0): (2.621, 0.0),
    (8, 1): (-1.376, 1.795),
    (8, 2): (7.201, 1.436),
    (8, 3): (-1.947, 0.679),
    (8, 4): (0.204, 1.171),
    (8, 5): (1.851, 1.771),
    (8, 6): (3.579, -0.25),
    (8, 7): (1.886, 4.903),
    (8, 8): (-5.285, -4.412),
    (9, 0): (-0.211, 0.0),
    (9, 1): (3.14, 0.886),
    (9, 2): (-0.36, -3.894),
    (9, 3): (-3.004, -2.056),
    (9, 4): (1.947, -2.511),
    (9, 5): (0.328, -3.064),
    (9, 6): (1.03, -0.745),
    (9, 7): (-4.117, -3.888),
    (9, 8): (6.529, 3.889),
    (9, 9): (-4.084, -0.082),
    (10, 0): (2.735, 0.0),
    (10, 1): (-1.624, -1.998),
    (10, 2): (-1.309, 1.333),
    (10, 3): (4.576, 0.641),
    (10, 4): (-4.506, 0.927),
    (10, 5): (-0.363, -0.927),
    (10, 6): (-4.528, -1.353),
    (10, 7): (-0.952, 1.81),
    (10, 8): (-1.104, -0.739),
    (10, 9): (0.129, 0.644),
    (10, 10): (4.164, -3.463),
    (11, 0): (-1.708, 0.0),
    (11, 1): (0.429, 2.902),
    (11, 2): (2.106, 0.915),
    (11, 3): (-5.078, 0.595),
    (11, 4): (3.441, 0.907),
    (11, 5): (0.784, 2.762),
    (11, 6): (0.158, 0.782),
    (11, 7): (-0.377, -0.355),
    (11, 8): (-0.818, 1.851),
    (11, 9): (3.654, 1.336),
    (11, 10): (-1.765, 4.245),
    (11, 11): (-0.505, -3.52),
    (12, 0): (1.003, 0.0),
    (12, 1): (-0.689, -1.476),
    (12, 2): (-2.359, -0.066),
    (12, 3): (3.863, 0.504),
    (12, 4): (0.793, -1.034),
    (12, 5): (-1.761, -0.267),
    (12, 6): (2.439, -2.484),
    (12, 7): (-2.08, 3.714),
    (12, 8): (2.237, 0.809),
    (12, 9): (0.289, -0.838),
    (12, 10): (1.516, -4.821),
    (12, 11): (4.114, -0.533),
    (12, 12): (-3.033, 2.175),
}



def geoheatflux_field(xt_deg, yt_deg):
    """bhf field [cal/(cm^2 s)] on the (jmt, imt) T grid.

    xt_deg : (imt,) longitudes; yt_deg : (jmt,) latitudes.
    Faithful to bhf.F:218-258: unnormalized associated Legendre via
    the explicit factorial sum, quasi-normalized by
    sqrt(((n+m)!/(n-m)!)/(h(2n+1))).
    """
    lon = np.asarray(xt_deg, np.float64)[None, :]
    lat = np.asarray(yt_deg, np.float64)[:, None]
    colat = np.deg2rad(90.0 - lat)
    x = np.deg2rad(lon)
    cy = np.cos(colat)
    sy = np.sin(colat)
    qq = np.zeros(np.broadcast_shapes(lat.shape, lon.shape))
    qq = qq + 0.0 * (cy + x)   # broadcast to (jmt, imt)
    for (n, m), (a, b) in _COEFFS.items():
        s = np.zeros_like(qq)
        for t in range((n - m) // 2 + 1):
            s = s + ((-1.0) ** t * factorial(2 * n - 2 * t)
                     / (factorial(t) * factorial(n - t)
                        * factorial(n - m - 2 * t))
                     * cy ** (n - m - 2 * t))
        pprime = (sy ** m) / 2.0 ** n * s
        h = 1.0 if m == 0 else 2.0
        krt = ((factorial(n + m) / factorial(n - m))
               / (h * (2 * n + 1.0))) ** 0.5
        pp = pprime / krt
        qq = qq + (a * np.cos(m * x) + b * np.sin(m * x)) * pp
    return qq / 41840000.0
