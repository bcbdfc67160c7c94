"""Top-of-atmosphere insolation (insolation.F zenith/decl), torch.

Port of ``uvic_tpu.models.embm.insolation``: daily-mean insolation from
the declination and the hour angle for the modern orbit or the orbit
of another year (``orbital_params``, the leading terms of Berger 1978),
and its annual mean as the mean of the daily
values (setembm.F:250-259).  ``day_of_year`` may be a 0-d tensor, so a
captured segment reads the day from a buffer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import SOLARCONST

ECC = 0.016724
OBLIQ = float(np.deg2rad(23.446))
PER = float(np.deg2rad(102.04))

# Berger (1978) trigonometric series, leading terms (insolation.F
# ``orbit`` carries the full 47/19-term tables; these truncations give
# the modern epoch to obliquity +/-0.03 deg, perihelion +/-1.5 deg,
# eccentricity +/-0.002, and the 41/21-kyr paleo cycles)
_OBL_TERMS = (  # amplitude ["], rate ["/yr], phase [deg]
    (-2462.2214, 31.609974, 251.9025),
    (-857.3232, 32.620504, 280.8325),
    (-629.3231, 24.172203, 128.3057),
    (-414.2804, 31.983787, 292.7252),
    (-311.7632, 44.828336, 15.3747),
    (-128.6276, 30.973257, 263.7951),
    (-116.6270, 18.934030, 308.4258),
    (101.1587, 17.147623, 240.0099),
    (-92.4634, 43.428093, 222.9725),
    (-66.1648, 32.696528, 210.2515),
)
_ECC_TERMS = (  # M, g ["/yr], beta [deg] (e sin/cos series)
    (0.01860798, 4.207205, 28.620089),
    (0.01627522, 7.346091, 193.788772),
    (-0.01300660, 17.857263, 308.307024),
    (0.00988829, 17.220546, 320.199637),
    (-0.00336700, 16.846733, 279.376984),
    (0.00333077, 5.199079, 87.195000),
    (-0.00235400, 18.231076, 349.129999),
    (0.00140015, 26.216758, 128.443387),
    (0.00100700, 6.359169, 154.143880),
    (0.00085700, 16.210016, 71.885981),
)
_PSI_TERMS = (  # general precession [''], rate ["/yr], phase [deg]
    (7391.0225, 31.609974, 251.9025),
    (2555.1526, 32.620504, 280.8325),
    (2022.7611, 34.847130, 308.3071),
    (-1973.6517, 0.158002, 317.7450),
)
_SEC = np.pi / 180.0 / 3600.0   # arcsec -> rad


def orbital_params(year: float = 1950.0):
    """Orbital parameters at a calendar year (negative = BC; a paleo run
    passes e.g. -19050 for 21 ka BP) from the Berger 1978 series
    (insolation.F ``orbit``): (eccentricity, obliquity [rad], longitude
    of perihelion [rad]), the keywords ``ecc``, ``obliq`` and ``per`` of
    ``daily_insolation``."""
    t = year - 1950.0
    eps = 23.320556 + sum(A / 3600.0 * np.cos(np.deg2rad(ph) + f * _SEC * t)
                          for A, f, ph in _OBL_TERMS)
    esin = sum(M * np.sin(np.deg2rad(b) + g * _SEC * t)
               for M, g, b in _ECC_TERMS)
    ecos = sum(M * np.cos(np.deg2rad(b) + g * _SEC * t)
               for M, g, b in _ECC_TERMS)
    ecc = float(np.hypot(esin, ecos))
    pif = np.rad2deg(np.arctan2(esin, ecos))
    psi = (50.439273 * _SEC * t * 180.0 / np.pi + 3.392506
           + sum(F / 3600.0 * np.sin(np.deg2rad(ph) + f * _SEC * t)
                 for F, f, ph in _PSI_TERMS))
    per = np.deg2rad((pif + psi) % 360.0)
    return ecc, np.deg2rad(eps), per


def declination_eccf(day_of_year, ecc=ECC, obliq=OBLIQ, per=PER,
                     yrlen=365.0):
    """Solar declination [rad] and eccentricity factor (1/r^2) for a
    calendar day (0..yrlen), from the mean-anomaly expansion.  ``per``
    is the geocentric longitude of perihelion (the 102.04 deg
    convention): the sun's ecliptic longitude at perihelion is
    per + 180."""
    lam_m = 2.0 * math.pi * (day_of_year - 80.0) / yrlen
    per_sun = per + math.pi
    nu = lam_m + 2.0 * ecc * torch.sin(lam_m - per_sun)
    sindec = math.sin(obliq) * torch.sin(nu)
    dec = torch.arcsin(sindec)
    eccf = (1.0 + ecc * torch.cos(nu - per_sun)) ** 2 \
        / (1.0 - ecc ** 2) ** 2
    return dec, eccf


def daily_insolation(lat_rad, day_of_year, yrlen=365.0, ecc=ECC,
                     obliq=OBLIQ, per=PER):
    """Daily-mean TOA insolation [erg/cm^2/s] at latitudes ``lat_rad``
    (a tensor); ``day_of_year`` a tensor broadcasting against it."""
    dec, eccf = declination_eccf(day_of_year, ecc=ecc, obliq=obliq,
                                 per=per, yrlen=yrlen)
    coshr = -torch.tan(lat_rad) * torch.tan(dec)
    h0 = torch.arccos(torch.clamp(coshr, -1.0, 1.0))  # half daylength
    q = (SOLARCONST * eccf / math.pi) * (
        h0 * torch.sin(lat_rad) * torch.sin(dec)
        + torch.cos(lat_rad) * torch.cos(dec) * torch.sin(h0))
    return torch.clamp(q, min=0.0)


def annual_mean_insolation(lat_rad, yrlen=365.0, ndays=365):
    """Annual-mean TOA insolation (setembm.F:250-259 equivalent)."""
    lat_rad = torch.as_tensor(lat_rad)
    days = (torch.arange(ndays, dtype=lat_rad.dtype, device=lat_rad.device)
            + 0.5).reshape(-1, *([1] * lat_rad.dim()))
    q = daily_insolation(lat_rad[None], days, yrlen)
    return q.mean(dim=0)
