"""EMBM physical constants (cembm.h values set in setembm.F:60-103 and
UVic_ESCM.F:1539-1593). CGS units."""

CPATM = 1.004e7       # atmosphere specific heat [erg/g/K]
SHT = 8.4e5           # temperature scale height [cm]
SHQ = 1.8e5           # humidity scale height [cm]
SHC = 8.049e5         # carbon scale height [cm]
RHOATM = 1.250e-3     # air density [g/cm^3]
ESATM = 4.6e-5        # atmosphere emissivity * stefan [g/s^3/K^4]
CSSH = 3.8011e-3      # saturation-humidity constant [g/g]
RHOOCN = 1.035
ESOCN = 5.4e-5        # ocean emissivity * stefan
VLOCN = 2.501e10      # latent heat of vaporisation [erg/g]
CDATM = 1.0e-3        # drag coefficient
RHOICE = 0.913
RHOSNO = 0.330
ESICE = 5.347e-5
SLICE = 2.835e10      # latent heat of sublimation [erg/g]
FLICE = 3.34e9        # latent heat of fusion [erg/g]
CONDICE = 2.1656e5    # ice conductivity [erg/cm/s/K]
SOILMAX = 15.0        # max soil moisture [cm]
ESLND = 5.347e-5
DALT_V = 3.3e-3       # dalton number over vegetation
DALT_O = 1.4e-3       # dalton number over ocean
DALT_I = 1.4e-3       # dalton number over ice
RLAPSE = 5.0e-5       # lapse rate [K/cm]
RF1 = 0.3             # lapse-rate reduction factors (UVic_ESCM.F:1540)
RF2 = 3.0e5
SCATTER = 0.23        # shortwave scattering fraction
PASS = 1.0 - SCATTER
RHMAX = 0.85          # max relative humidity before precipitation
CO2FOR = 5.35e3       # CO2 radiative forcing coefficient [mW/m^2-ish cgs]
TSNO = 0.0            # snowfall offset temperature
SOLARCONST = 1.368e6  # solar constant [erg/cm^2/s]
C2K = 273.15

# Thompson & Warren (1982) outgoing longwave coefficients (fluxes.F:63-75)
TW_B = dict(
    b00=2.3829382e2, b10=-3.47968e1, b20=1.02790e1,
    b01=2.60065, b11=-1.62064, b21=6.34856e-1,
    b02=4.40272e-3, b12=-2.26092e-2, b22=1.12265e-2,
    b03=-2.05237e-5, b13=-9.67e-5, b23=5.62925e-5,
)
