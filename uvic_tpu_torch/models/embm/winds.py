"""Anomalous wind feedback (O_embm_awind, source/embm/winds.F), in PyTorch.

Port of ``uvic_tpu.models.embm.winds``: surface-air-temperature anomalies
relative to a climatology drive an anomalous surface pressure (quadratic
density-temperature fit, winds.F calc_awind:88-169) whose
damped-geostrophic response perturbs the advecting winds, the wind
stress (with the Gill 1982 turning-angle surface drag) and the wind
speed.  The climatology is a field set by ``set_climatology`` (the
reference reads it from data files); until it is set there is no
feedback.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...constants import EPSLN, OMEGA, RADIAN
from ...ops.stencil import E, N
from . import constants as C

RD = 287.0e4        # gas constant [cm^2/K/s^2]
B_RHO = 2.58e-3     # rho(T) intercept [g/cm^3]
RNOT = 1.0 / 3600.0
DLAT = 22.5
SLAT = 30.0
CONTR = 0.8         # contraction factor (winds.F:1-80)
TURN = 20.0 / RADIAN


def slope_s(tlat_deg):
    """Latitude-dependent rho-T slope (winds.F:120-129)."""
    s = np.full_like(tlat_deg, -4.67e-6)
    const = 180.0 / (90.0 - SLAT) / RADIAN
    south = tlat_deg < -SLAT
    north = tlat_deg > SLAT
    s = np.where(south, s + 1.8e-6 * (np.cos(
        (tlat_deg + SLAT) * const) * 0.5 - 0.5), s)
    s = np.where(north, s + 0.9e-6 * (np.cos(
        (tlat_deg - SLAT) * const) * 0.5 - 0.5), s)
    return s


class WindFeedback:
    def __init__(self, grid, area_weights, dtype=torch.float64,
                 device="cpu"):
        jmt, imt = grid.jmt, grid.imt
        tlat = np.broadcast_to(grid.yt[:, None], (jmt, imt))
        ulat = np.broadcast_to(grid.yu[:, None], (jmt, imt))

        def tn(x):
            return torch.as_tensor(np.array(x, np.float64), dtype=dtype,
                                   device=device)

        self.dtype, self.device = dtype, device
        self.s = tn(slope_s(tlat))
        self.fcor = tn(2.0 * OMEGA * np.sin(np.deg2rad(ulat)))
        self.rlat = tn(RNOT * np.exp(-np.abs(ulat) / DLAT))
        self.dxu2r = tn(0.5 / grid.dxu)[None, :]
        self.dyu2r = tn(0.5 / grid.dyu)[:, None]
        self.cstr = tn(1.0 / grid.cst)[:, None]
        self.sign_lat = tn(np.sign(ulat) + (ulat == 0))
        self.area = tn(area_weights)
        self.t_clim = None

    def set_climatology(self, sat):
        """The SAT climatology [C] the anomalies are taken against."""
        self.t_clim = torch.as_tensor(sat, dtype=self.dtype,
                                      device=self.device).clone()

    def anomalous_wind(self, sat_mean, t_clim=None):
        """(awx, awy) anomalous wind at U points from the SAT anomaly
        (calc_awind)."""
        c2k = 273.15
        tm = sat_mean + c2k
        tc = (self.t_clim if t_clim is None else t_clim) + c2k
        apress = RD * (self.s * (tm ** 2 - tc ** 2) + B_RHO * (tm - tc))
        apress = apress - torch.sum(apress * self.area) \
            / torch.sum(self.area)
        diag1 = N(E(apress)) - apress
        diag0 = N(apress) - E(apress)
        adpdy = (diag1 + diag0) * self.dyu2r
        adpdx = (diag1 - diag0) * self.dxu2r * self.cstr
        const = 1.0 / (C.RHOATM * (self.rlat ** 2 + self.fcor ** 2))
        awy = const * (self.fcor * adpdx - self.rlat * adpdy)
        awx = -const * (self.rlat * adpdx + self.fcor * adpdy)
        return awx, awy

    def apply(self, sat_mean, winds, taux, tauy, wspd, t_clim=None):
        """Blend the anomalous wind into the advecting winds, the stress
        and the speed (add_awind, winds.F:1-80)."""
        awx, awy = self.anomalous_wind(sat_mean, t_clim=t_clim)
        cosa = math.cos(TURN)
        sina = math.sin(TURN) * self.sign_lat
        x = awx * cosa - awy * sina
        y = awx * sina + awy * cosa
        winds_new = torch.stack([winds[0] + CONTR * x,
                                 winds[1] + CONTR * y])
        drag = C.CDATM * C.RHOATM
        f = 1.0 / drag / (torch.sqrt(
            torch.sqrt(taux ** 2 + tauy ** 2) / drag) + EPSLN)
        xs = CONTR * x + f * taux
        ys = CONTR * y + f * tauy
        s = torch.sqrt(xs ** 2 + ys ** 2)
        taux_new = drag * xs * s
        tauy_new = drag * ys * s
        wspd_new = torch.sqrt((CONTR * x) ** 2 + (CONTR * y) ** 2
                              + wspd ** 2)
        return winds_new, taux_new, tauy_new, wspd_new
