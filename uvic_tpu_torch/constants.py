"""Physical constants (CGS units).

Values match the reference model so that namelist parameters (viscosities,
diffusivities, drag coefficients, ...) carry over unchanged.
Reference: source/common/pconst.h, source/common/UVic_ESCM.F:1251-1254,1427.
"""

import math

# numerics
EPSLN = 1.0e-20            # pconst.h:20
SECDAY = 1.0 / 86400.0     # 1/seconds-per-day

# earth (UVic_ESCM.F:1251-1254, 1427)
RHO0 = 1.035               # Boussinesq mean density [g/cm^3]
RHO0R = 1.0 / RHO0
GRAV = 980.6               # gravity [cm/s^2]
RADIUS = 6370.0e5          # earth radius [cm]
OMEGA = math.pi / 43082.0  # rotation rate [rad/s]

PI = math.pi
RADIAN = 360.0 / (2.0 * PI)   # degrees per radian (grids.F:415)
DEG_TO_CM = RADIUS / RADIAN   # cm per degree of latitude (grids.F:416)

# calendar (reference equal-month calendar: 12 x 30 days)
DAYLEN = 86400.0           # seconds per day
YRLEN_EQ = 360.0           # days per equal-month year
MONLEN_EQ = 30.0
