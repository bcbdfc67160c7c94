"""Top-of-atmosphere insolation (insolation.F zenith/decl), torch.

Port of ``uvic_tpu.models.embm.insolation``: daily-mean insolation from
the declination and the hour angle for the modern orbit (the leading
terms of Berger 1978), and its annual mean as the mean of the daily
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
