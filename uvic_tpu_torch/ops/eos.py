"""Equation of state: per-level cubic polynomial fit to UNESCO (1981).

PyTorch port of ``uvic_tpu.ops.eos`` (source/mom/state.F, dens.h,
denscoef.F):
density anomalies are a 9-term cubic polynomial in (theta', S') anomalies
per model level, with coefficients fit at init by least squares to the
UNESCO equation of state (Bryan & Cox 1972 method, denscoef.F `eqstate`).
The reference's 1969-vintage Householder iterative solver becomes a single
`numpy.linalg.lstsq`; the polynomial evaluation is a fused Horner form
identical to the dens() statement function (dens.h:14-16).

Units: T [deg C], model salinity S = (psu - 35)/1000, density anomaly
[g/cm^3], depth [cm].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def unesco_density(t, s, z_m):
    """In-situ density [kg/m^3] from in-situ T [C], S [psu], depth [m]
    (UNESCO 1981; Gill 1982 pp 599-600; denscoef.F:1210)."""
    p = z_m * 0.1  # approx pressure in bars
    rw = (9.99842594e2 + 6.793952e-2 * t - 9.095290e-3 * t**2
          + 1.001685e-4 * t**3 - 1.120083e-6 * t**4 + 6.536332e-9 * t**5)
    rsto = (rw
            + (8.24493e-1 - 4.0899e-3 * t + 7.6438e-5 * t**2
               - 8.2467e-7 * t**3 + 5.3875e-9 * t**4) * s
            + (-5.72466e-3 + 1.0227e-4 * t - 1.6546e-6 * t**2) * s**1.5
            + 4.8314e-4 * s**2)
    xkw = (1.965221e4 + 1.484206e2 * t - 2.327105 * t**2
           + 1.360477e-2 * t**3 - 5.155288e-5 * t**4)
    xksto = (xkw
             + (5.46746e1 - 6.03459e-1 * t + 1.09987e-2 * t**2
                - 6.1670e-5 * t**3) * s
             + (7.944e-2 + 1.6483e-2 * t - 5.3009e-4 * t**2) * s**1.5)
    xkstp = (xksto
             + (3.239908 + 1.43713e-3 * t + 1.16092e-4 * t**2
                - 5.77905e-7 * t**3) * p
             + (2.2838e-3 - 1.0981e-5 * t - 1.6078e-6 * t**2) * p * s
             + 1.91075e-4 * p * s**1.5
             + (8.50935e-5 - 6.12293e-6 * t + 5.2787e-8 * t**2) * p**2
             + (-9.9348e-7 + 2.0816e-8 * t + 9.1697e-10 * t**2) * p**2 * s)
    return rsto / (1.0 - p / xkstp)


def potential_temperature(t, s, z_m):
    """Potential temperature from in-situ T [C], S [psu], depth [m]
    (Fofonoff & Froese 1958 polynomial; denscoef.F:1164)."""
    p = z_m
    t2, t3 = t * t, t * t * t
    s2, p2 = s * s, p * p
    potmp = (-1.60e-5 * p + 1.014e-5 * p * t - 1.27e-7 * p * t2
             + 2.7e-9 * p * t3 + 1.322e-6 * p * s - 2.62e-8 * p * s * t
             + 4.1e-9 * p * s2 + 9.14e-9 * p2 - 2.77e-10 * p2 * t
             + 9.5e-13 * p2 * t2 - 1.557e-13 * p2 * p)
    return t - potmp


# T/S fitting ranges per 250 m depth bin (denscoef.F data tables). These are
# the published Bryan-Cox ranges bounding observed WOA T/S per depth.
_TS_TMIN = np.array([-2.0] * 4 + [-1.0] * 15 + [0.0] * 14)
_TS_TMAX = np.array([29.0, 19.0, 14.0, 11.0, 9.0] + [7.0] * 28)
_TS_SMIN = np.array([28.5, 33.7, 34.0, 34.1, 34.2, 34.4, 34.5, 34.5]
                    + [34.6] * 15 + [34.7] * 10)
_TS_SMAX = np.array([37.0, 36.6, 35.8, 35.7, 35.3, 35.1, 35.1] + [35.0] * 26)


@dataclass(frozen=True)
class EosCoefficients:
    """Per-level polynomial EOS (state.h analog)."""
    to: np.ndarray      # (km,) reference potential temperature
    so: np.ndarray      # (km,) reference model salinity
    ro0: np.ndarray     # (km,) reference sigma (x1e-3) per level
    c: np.ndarray       # (km, 9) polynomial coefficients
    tmin: np.ndarray
    tmax: np.ndarray
    smin: np.ndarray
    smax: np.ndarray


def fit_eos(zt_cm: np.ndarray) -> EosCoefficients:
    """Fit the 9-coefficient cubic per level (denscoef.F `eqstate`).

    Samples a 10x5 grid of (in-situ T, S) over the per-depth ranges,
    converts T to potential temperature, and least-squares fits the sigma
    anomaly. Output units follow dens.h: T in deg C, model salinity
    (psu-35)/1000, density in g/cm^3.
    """
    z_m = np.asarray(zt_cm, dtype=np.float64) / 100.0
    km = len(z_m)
    if np.any(z_m > 8000.0):
        raise ValueError("depth exceeds 8000 m: outside EOS fit tables")
    kx, kxx = 5, 10
    to = np.empty(km); so = np.empty(km); ro0 = np.empty(km)
    cs = np.empty((km, 9))
    tminc = np.empty(km); tmaxc = np.empty(km)
    sminc = np.empty(km); smaxc = np.empty(km)
    for k in range(km):
        ibin = min(int(z_m[k] / 250.0), 32)
        tmin, tmax = _TS_TMIN[ibin], _TS_TMAX[ibin]
        smin, smax = _TS_SMIN[ibin], _TS_SMAX[ibin]
        ta = tmin + np.arange(kxx) * (tmax - tmin) / (2 * kx - 1)
        sa = smin + np.arange(kx) * (smax - smin) / (kx - 1)
        tp, sp = np.meshgrid(ta, sa, indexing="ij")
        tp, sp = tp.ravel(), sp.ravel()
        sigma = unesco_density(tp, sp, z_m[k]) - 1.0e3 + 2.5e-2
        theta = potential_temperature(tp, sp, z_m[k])
        t1 = theta.mean()
        s1 = sp.mean()
        sig_ref = unesco_density(tp.mean(), s1, z_m[k]) - 1.0e3 + 2.5e-2
        tanom = theta - t1
        sanom = sp - s1
        A = np.stack([tanom, sanom, tanom**2, tanom * sanom, sanom**2,
                      tanom**3, sanom**2 * tanom, tanom**2 * sanom,
                      sanom**3], axis=1)
        x, *_ = np.linalg.lstsq(A, sigma - sig_ref, rcond=None)
        # unit conversions (denscoef.F:342-352): sigma->g/cm^3 (1e-3),
        # salinity psu -> model units (x1e3 per salinity power)
        scale = np.array([1e-3, 1.0, 1e-3, 1.0, 1e3, 1e-3, 1e3, 1.0, 1e6])
        cs[k] = x * scale
        to[k] = t1
        so[k] = 1.0e-3 * s1 - 0.035
        ro0[k] = 1.0e-3 * sig_ref
        tminc[k] = potential_temperature(tmin, smin, z_m[k])
        tmaxc[k] = potential_temperature(tmax, smax, z_m[k])
        sminc[k], smaxc[k] = smin, smax
    return EosCoefficients(to=to, so=so, ro0=ro0, c=cs,
                           tmin=tminc, tmax=tmaxc, smin=sminc, smax=smaxc)


def dens(c, tq, sq):
    """Density anomaly from *pre-subtracted* anomalies tq = T - to[k],
    sq = S - so[k] (dens.h:14-16 Horner form). ``c`` is (..., 9) broadcast
    against tq/sq; for full-field use pass c[:, :, None, None] with
    (km, jmt, imt) fields."""
    c1, c2, c3, c4, c5, c6, c7, c8, c9 = [c[..., i] for i in range(9)]
    return ((c1 + (c4 + c7 * sq) * sq + (c3 + c8 * sq + c6 * tq) * tq) * tq
            + (c2 + (c5 + c9 * sq) * sq) * sq)


def drodt(c, tq, sq):
    """d(rho)/dT (dens.h:18-19), for the isopycnal slope computation."""
    c1, c2, c3, c4, c5, c6, c7, c8, c9 = [c[..., i] for i in range(9)]
    return (c1 + (c4 + c7 * sq) * sq
            + (2.0 * c3 + 2.0 * c8 * sq + 3.0 * c6 * tq) * tq)


def drods(c, tq, sq):
    """d(rho)/dS (dens.h:21-22)."""
    c1, c2, c3, c4, c5, c6, c7, c8, c9 = [c[..., i] for i in range(9)]
    return ((c4 + 2.0 * c7 * sq + c8 * tq) * tq
            + c2 + (2.0 * c5 + 3.0 * c9 * sq) * sq)


def state(eos: EosCoefficients, t, s):
    """rho(k,j,i) from full T, S tensors (state.F:1-61). Level-local
    reference coefficients; valid for horizontal gradients only."""
    def tt(x):
        return torch.as_tensor(x, dtype=t.dtype, device=t.device)
    c = tt(eos.c)[:, None, None, :]
    return dens(c, t - tt(eos.to)[:, None, None], s - tt(eos.so)[:, None, None])
