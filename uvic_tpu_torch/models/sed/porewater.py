"""Pore-water CaCO3 diagenesis columns (Archer 1996; sed/sediment.F), in
PyTorch.

Port of ``uvic_tpu.models.sed.porewater``: every ocean-bottom cell
carries a 7-level sediment column as dense (KMAX, jmt, imt) fields, and
the pore-water (CO2, HCO3, CO3) system of every column is solved at once
by a Newton iteration on a batched block-tridiagonal system (3x3 blocks,
block Thomas with explicit 3x3 inverses).

Pieces and their sources:
- grid: KMAX=7, delz=[0,.5,.5,1,2,3,3] cm, dissc=1.1574e-5/s, n=4.5
  (setsed.F:82-91); level 1 is the bottom-water boundary cell,
- porosity and formation factor: set_pore (sediment.F:200-222),
  pore_2_form = pore^3 (sediment.F:1596-1615),
- diffusion operators: calc_do2/calc_dc/calc_db (sediment.F:1051-1092,
  1381-1430, 1548-1594),
- organic carbon and O2: the orgc/o2ss tridiagonal steady states with
  the oxygen-penetration depth update (o2org, sediment.F:638-1050),
- pore-water carbonate Newton: the co3 residuals and Jacobian
  (sediment.F:1667-1995) with the 75%-step damping (sediment.F:1900-1960)
  and the Keir/Archer rate law cal_c = dissc*(1-CO3/csat)^n*(1-pore)*
  calgg*25 (sediment.F:1973),
- interface fluxes: sed_diag (sediment.F:1433-1530),
- bottom-water chemistry: calc_k (Mehrbach and pressure) and the
  alkalinity iteration calc_buff (sediment.F:517-637),
- driver cadence: sed.F n_control=2 (steady pore water at constant
  calcite, then the mixed-layer mass update).

The reference's divergences from sediment.F are kept: the buried-stack
history is a bulk buried-mass accumulator per column, and the loop
counts are fixed (Newton 60, organic carbon and O2 12, calc_buff 50).
The reference's ``lax.scan`` over levels is a Python loop over the 7
levels on batched tensors, and its per-level constant arrays (depths,
thicknesses) are Python numbers, level by level; no step reads a value
back to the host or copies one to the device, so the whole step can be
captured in a CUDA graph.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

KMAX = 7
DELZ = (0.0, 0.5, 0.5, 1.0, 2.0, 3.0, 3.0)   # cm
ZSED = tuple(float(z) for z in np.cumsum(DELZ))
ZTOP = (0.0,) + ZSED[:-1]                      # depth of each level's top
DISSC = 1.1574e-5       # dissolution rate [1/s] (setsed.F:90)
DISSN = 4.5
DB = 0.15               # bioturbation [cm^2/yr] (sediment.F:1568)
DIFO2 = 12.0e-6         # [cm^2/s] (calc_do2 overrides to 12e-6)
DIFC = (10.5e-6, 6.4e-6, 5.2e-6)
EXPB = 3.0
SEC_PER_YR = 3.15e7
RAINCAL_CUTOFF = 0.1e-6  # mol/cm^2/yr (calss:1131)

PW_FIELDS = ("calgg", "orggg", "carb", "o2", "zrct", "buried", "buried_org")


@dataclass
class PoreWaterState:
    calgg: torch.Tensor      # (KMAX, jmt, imt) calcite mass fraction
    orggg: torch.Tensor      # organic carbon mass fraction
    carb: torch.Tensor       # (3, KMAX, jmt, imt) CO2/HCO3/CO3 [mol/l]
    o2: torch.Tensor         # (KMAX, jmt, imt) pore-water O2 [mol/l]
    zrct: torch.Tensor       # (jmt, imt) O2 penetration depth [cm]
    buried: torch.Tensor     # cumulative burial [mol CaCO3/cm^2]
    buried_org: torch.Tensor

    def replace(self, **kw) -> "PoreWaterState":
        return replace(self, **kw)


def init_porewater(jmt, imt, dtype=torch.float64, device="cpu"):
    z2 = torch.zeros((jmt, imt), dtype=dtype, device=device)
    zk = torch.zeros((KMAX, jmt, imt), dtype=dtype, device=device)
    carb = torch.stack([zk + 2.0e-5, zk + 1.8e-3, zk + 9.0e-5])
    return PoreWaterState(
        calgg=zk + 0.5, orggg=zk + 0.003, carb=carb,
        o2=zk + 1.5e-4, zrct=z2 + ZSED[-1], buried=z2.clone(),
        buried_org=z2.clone())


def _column_sum(level):
    """sum over the levels k of level(k) * DELZ[k]."""
    return sum(level(k) * DELZ[k] for k in range(KMAX))


# ----------------------------------------------------------------------
# bottom-water chemistry (sediment.F:517-637)
# ----------------------------------------------------------------------
def calc_k(temp, sal, depth_m):
    """Mehrbach K1/K2 and Lyman KB with the pressure ratios, and the
    Sayles calcite saturation CO3 [mol/l] (calc_k, sediment.F:517-585)."""
    tk = temp + 273.15
    s = torch.clamp(sal, min=1.0)
    k1 = 10.0 ** (13.7201 - 0.031334 * tk - 3235.76 / tk
                  - 1.3e-5 * s * tk + 0.1032 * torch.sqrt(s))
    cp = (depth_m / 10.0) / 83.143 / tk
    k1 = k1 * torch.exp((24.2 - 0.085 * temp) * cp)
    ln10 = 2.30259
    k2 = 10.0 ** (-5371.9645 - 1.671221 * tk + 128375.28 / tk
                  + 2194.3055 * torch.log(tk) / ln10 - 0.22913 * s
                  - 18.3802 * torch.log(s) / ln10
                  + 8.0944e-4 * s * tk
                  + 5617.11 * torch.log(s) / tk / ln10 - 2.136 * s / tk)
    k2 = k2 * torch.exp((16.4 - 0.04 * temp) * cp)
    kb = 10.0 ** -(2291.9 / tk + 0.01756 * tk - 3.385
                   - 0.32051 * (s / 1.80655) ** (1.0 / 3.0))
    kb = kb * torch.exp((27.5 - 0.095 * temp) * cp)
    # Sayles: Ksp(P)/[Ca] with [Ca] = 0.01 mol/l
    pres = depth_m / 10.0
    rr = 83.14
    kpres = math.log(4.75e-7) + 44.0 / (rr * tk) * pres \
        + 0.5 * (-0.0133) / (rr * tk) * pres ** 2
    csat = torch.exp(kpres) / 0.01
    return k1, k2, kb, csat


def calc_buff(alk, tco2, sal, k1, k2, kb, n_iter=50):
    """Bottom-water CO2/HCO3/CO3 from ALK and TCO2 (calc_buff,
    sediment.F:589-637), all mol/l."""
    tbor = 4.106e-4 * sal / 35.0
    c1 = k1 / 2.0
    c2 = 1.0 - 4.0 * k2 / k1
    c4 = tbor * kb
    tco2 = torch.clamp(tco2, min=1e-6)

    ah1 = torch.full_like(alk, 0.74e-8)
    for _ in range(n_iter):
        a = alk - c4 / (kb + ah1)
        x = a / tco2
        ah1 = c1 / x * (1.0 - x + torch.sqrt(torch.clamp(
            1.0 + c2 * x * (-2.0 + x), min=0.0)))
    a = alk - c4 / (kb + ah1)
    co3 = (a - tco2) / (1.0 - ah1 * ah1 / (k1 * k2))
    hco3 = tco2 / (1.0 + ah1 / k1 + k2 / ah1)
    co2 = tco2 / (1.0 + k1 / ah1 + k1 * k2 / (ah1 * ah1))
    return co2, hco3, co3


# ----------------------------------------------------------------------
# static column operators
# ----------------------------------------------------------------------
def _set_pore(calgg_bot):
    """Porosity profile from the deep calcite fraction (set_pore)."""
    pore_max = 1.0 - (0.483 + 0.45 * calgg_bot) / 2.5
    exp_pore = 0.25 * calgg_bot + 3.0 * (1.0 - calgg_bot)
    return torch.stack([torch.exp(-z / exp_pore) * (1.0 - pore_max)
                        + pore_max for z in ZSED])


def _face(form, i, j, harmonic):
    """The form factor on the face between levels i and j."""
    if not harmonic:
        return (form[j] + form[i]) * 0.5
    return (DELZ[i] * form[j] + DELZ[j] * form[i]) / (DELZ[i] + DELZ[j])


def _face_ops(coef, form, pore, harmonic=False):
    """(dplus, dminus) second-difference operators (calc_dc/calc_do2):
    dplus(k) multiplies (x(k+1)-x(k)), dminus(k) multiplies
    (x(k)-x(k-1)); the top face of level 1 exchanges with the
    bottom-water boundary (form=1 there)."""
    zero = torch.zeros_like(form[0])
    dplus, dminus = [zero] * KMAX, [zero] * KMAX
    for i in range(1, KMAX - 1):
        dplus[i] = (coef * _face(form, i, i + 1, harmonic) / pore[i]
                    * 2.0 / ((DELZ[i + 1] + DELZ[i]) * DELZ[i]))
    for i in range(2, KMAX):
        dminus[i] = (coef * _face(form, i, i - 1, harmonic) / pore[i]
                     * 2.0 / ((DELZ[i - 1] + DELZ[i]) * DELZ[i]))
    dminus[1] = coef * (form[1] + 1.0) * 0.5 / pore[1] / DELZ[1] ** 2
    return torch.stack(dplus), torch.stack(dminus)


def _db_ops(pore):
    """Bioturbation operators (calc_db, sediment.F:1548-1594), db in
    cm^2/yr."""
    zero = torch.zeros_like(pore[0])
    dbpls, dbmin = [zero] * KMAX, [zero] * KMAX
    for k in range(1, KMAX - 1):
        dbpls[k] = (DB * 2.0 / ((DELZ[k] + DELZ[k + 1]) * DELZ[k])
                    * (2.0 - pore[k] - pore[k + 1]) / (1.0 - pore[k]))
    for k in range(2, KMAX):
        dbmin[k] = (DB * 2.0 / ((DELZ[k] + DELZ[k - 1]) * DELZ[k])
                    * (2.0 - pore[k] - pore[k - 1]) / (1.0 - pore[k]))
    return torch.stack(dbpls), torch.stack(dbmin)


def _tridiag(a, b, c, r):
    """Batched Thomas solve along axis 0: a lower, b diagonal, c upper,
    each (n, ...); mirrors sediment.F tridiag."""
    n = a.shape[0]
    bet = b[0]
    u = [r[0] / bet]
    gam = [None]
    for k in range(1, n):
        g = c[k - 1] / bet
        bet = b[k] - a[k] * g
        u.append((r[k] - a[k] * u[k - 1]) / bet)
        gam.append(g)
    for k in range(n - 2, -1, -1):
        u[k] = u[k] - gam[k + 1] * u[k + 1]
    return torch.stack(u)


# ----------------------------------------------------------------------
# organic carbon and O2 (o2org, sediment.F:638-1050)
# ----------------------------------------------------------------------
def _react_gate(zrct):
    """Per-level reaction weight: 1 fully above the O2 penetration
    depth, fractional in the crossing level, 0 below (get_resp)."""
    gate = []
    for z, ztop in zip(ZSED, ZTOP):
        frac = torch.clamp((zrct - ztop) / max(z - ztop, 1e-12), 0.0, 1.0)
        gate.append(torch.where(zrct >= z, 1.0, frac * (zrct >= ztop)))
    return torch.stack(gate)


def _reacting(zrct):
    """The reaction gate of the unknown levels: level 0, the bottom
    water, reacts nowhere."""
    gate = _react_gate(zrct)
    gate[0] = 0.0
    return gate


def _orgc_o2(rain_org, rc, pore, form, o2_bw, zrct0, orggg0, n_outer=12):
    """Coupled organic-carbon / O2 steady state (o2org).  rain_org in
    mol C/cm^2/yr; rc [1/s]; returns (orggg, orgml, o2, zrct, resp_c1)
    with resp_c1 the TCO2 respiration source [mol/l-porewater/s] per
    level."""
    dbpls, dbmin = _db_ops(pore)                   # per year
    dopls, domin = _face_ops(DIFO2, form, pore)    # per second
    rain1 = rain_org * 12.0 / DELZ[1] / (1.0 - pore[1]) / 2.5
    # the organic-carbon system's fixed coefficients (levels 1..KMAX-1)
    a = dbmin[1:]
    c = dbpls[1:]
    a2 = domin[1:]
    b2 = (-dopls - domin)[1:].clone()
    b2[-1] = -domin[-1]
    c2 = dopls[1:]

    orggg = orggg0
    o2 = torch.zeros_like(orggg0) + o2_bw[None] * 0.5
    zrct = zrct0
    for _ in range(n_outer):
        gate = _reacting(zrct)
        # organic carbon: one Newton step, linear in orggg for a fixed
        # gate
        dreac = -rc * SEC_PER_YR * gate
        react = dreac * orggg
        up = torch.cat([orggg[1:], orggg[-1:]], 0)
        dn = torch.cat([orggg[:1], orggg[:-1]], 0)
        res = dbpls * (up - orggg) - dbmin * (orggg - dn) + react
        res[1] = dbpls[1] * (orggg[2] - orggg[1]) + react[1] + rain1
        res[-1] = -dbmin[-1] * (orggg[-1] - orggg[-2]) + react[-1]
        b = (-dbpls - dbmin + dreac)[1:]
        b[0] = (-dbpls + dreac)[1]
        b[-1] = (-dbmin + dreac)[-1]
        du = _tridiag(a, b, c, -res[1:])
        orggg = torch.cat([orggg[:1], orggg[1:] + du], 0)
        orggg = torch.clamp(orggg, 0.0, 1.0)
        orgml = orggg * 2.5 * (1.0 - pore) * 1000.0 / 12.0

        # O2: the steady state (linear solve), the bottom water as the
        # Dirichlet value above level 1
        sink = 1.3 * rc * orgml / pore * gate
        up2 = torch.cat([o2[1:], o2[-1:]], 0)
        dn2 = torch.cat([o2[:1], o2[:-1]], 0)
        res2 = dopls * (up2 - o2) - domin * (o2 - dn2) - sink
        res2[-1] = -domin[-1] * (o2[-1] - o2[-2]) - sink[-1]
        du2 = _tridiag(a2, b2, c2, -res2[1:])
        o2 = torch.cat([o2_bw[None], o2[1:] + du2], 0)
        # the O2 penetration depth (o2org, sediment.F:683-687)
        zrct = torch.clamp(
            zrct * o2[0] / (o2[0] - o2[-1] + 1e-20), max=ZSED[-1])
        zrct = torch.clamp(zrct, min=0.1)
    orgml = orggg * 2.5 * (1.0 - pore) * 1000.0 / 12.0
    resp_c1 = rc * orgml * _reacting(zrct)
    return orggg, orgml, o2, zrct, resp_c1


# ----------------------------------------------------------------------
# pore-water carbonate Newton (co3, sediment.F:1667-1995)
# ----------------------------------------------------------------------
def _minv3(m):
    """Explicit 3x3 inverse (adjugate / determinant) of (3, 3, ...)."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-300,
                      torch.sign(det) * 1e-300 + 1e-300, det)
    inv = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e]),
        torch.stack([B, a * i - c * g, -(a * f - c * d)]),
        torch.stack([C, -(a * h - b * g), a * e - b * d])])
    return inv / det


def _mm(x, y):
    """Block product of (3, 3, ...) blocks."""
    return (x[:, :, None] * y[None]).sum(1)


def _mv(x, v):
    """Block times vector: (3, 3, ...) by (3, ...)."""
    return (x * v[None]).sum(1)


def _block_thomas(L, D, U, R):
    """Block-tridiagonal solve with 3x3 blocks.

    L/D/U : (n, 3, 3, ...) lower/diagonal/upper blocks
    R     : (n, 3, ...)
    The batch dimensions trail.  Each diagonal's inverse is taken once
    and serves the forward sweep and the back substitution.
    """
    n = R.shape[0]
    dprime, rprime = D[0], R[0]
    invs, rs, gams = [], [R[0]], [None]
    for k in range(1, n):
        inv = _minv3(dprime)
        gam = _mm(inv, U[k - 1])
        rnew = R[k] - _mv(L[k], _mv(inv, rprime))
        dprime = D[k] - _mm(L[k], gam)
        invs.append(inv)
        rs.append(rnew)
        gams.append(gam)
        rprime = rnew
    invs.append(_minv3(dprime))
    x = [None] * n
    x[n - 1] = _mv(invs[n - 1], rs[n - 1])
    for k in range(n - 2, -1, -1):
        x[k] = _mv(invs[k], rs[k]) - _mv(gams[k + 1], x[k + 1])
    return torch.stack(x)


def _co3_newton(carb0, resp_c1, calgg, pore, form, csat, k1, k2,
                n_iter=60):
    """Newton iteration for the (CO2, HCO3, CO3) pore-water profiles
    (co3/co3ss).  carb0: (3, KMAX, ...) with level 0 the fixed
    bottom-water boundary.  Returns (carb, cal_c)."""
    ops = [_face_ops(DIFC[j], form, pore, harmonic=True) for j in range(3)]
    dplus = torch.stack([o[0] for o in ops])      # (3, KMAX, ...)
    dminus = torch.stack([o[1] for o in ops])
    keq = k2 / k1
    diss_fac = (1.0 - pore) / pore * 25.0         # *(2.5*1000)/100
    csat_k = csat[None]

    def cal_rate(co3):
        under = torch.clamp(1.0 - co3 / csat_k, min=0.0)
        return DISSC * under ** DISSN

    # the blocks' fixed entries at the unknown levels 1..KMAX-1: the
    # diffusion couplings; the bottom row folds its upper block into
    # its diagonal (no-flux, co3:1880-1885) and level 1's lower block
    # couples to the fixed boundary level 0 (dropped, Dirichlet)
    sl = slice(1, KMAX)
    zero = torch.zeros_like(carb0[0, sl])
    diag_p = (-dplus - dminus)[:, sl]
    lo = [dminus[0][sl], dminus[1][sl], dminus[2][sl],
          0.5 * dminus[1][sl], dminus[2][sl]]
    hi = [dplus[0][sl], dplus[1][sl], dplus[2][sl],
          0.5 * dplus[1][sl], dplus[2][sl]]

    def blocks(e, last_zero=False, first_zero=False):
        m = torch.stack([torch.stack([e[0], e[1], e[2]]),
                         torch.stack([zero, e[3], e[4]]),
                         torch.stack([zero, zero, zero])], 0)
        m = torch.movedim(m, 2, 0)                # (n, 3, 3, ...)
        if first_zero:
            m[0] = 0.0
        if last_zero:
            m[-1] = 0.0
        return m

    U_full = blocks(hi)
    U = blocks(hi, last_zero=True)
    L = blocks(lo, first_zero=True)

    carb = carb0
    for _ in range(n_iter):
        co2, hco3, co3 = carb[0], carb[1], carb[2]
        up = torch.cat([carb[:, 1:], carb[:, -1:]], 1)
        dn = torch.cat([carb[:, :1], carb[:, :-1]], 1)
        lap = dplus * (up - carb) - dminus * (carb - dn)
        # no-flux bottom boundary: carb(kmax+1) = carb(kmax) through the
        # `up` clamp; dplus at kmax is zero already
        diss = cal_rate(co3) * diss_fac * calgg
        ddiss = torch.where(
            co3 < csat_k,
            -DISSC * DISSN / csat_k
            * torch.clamp(1.0 - co3 / csat_k, min=0.0) ** (DISSN - 1.0)
            * diss_fac * calgg, 0.0)
        hco3_c = torch.clamp(hco3, min=1e-12)
        r1 = lap[0] + lap[1] + lap[2] + resp_c1 / pore + diss
        r2 = lap[2] + 0.5 * lap[1] + diss
        r3 = co2 * co3 / hco3_c ** 2 - keq

        # diagonal blocks (function x variable) at each unknown level
        d11 = diag_p[0]
        d12 = diag_p[1]
        d13 = diag_p[2] + ddiss[sl]
        d22 = 0.5 * diag_p[1]
        d23 = diag_p[2] + ddiss[sl]
        d31 = (co3 / hco3_c ** 2)[sl]
        d32 = (-2.0 * co2 * co3 / hco3_c ** 3)[sl]
        d33 = (co2 / hco3_c ** 2)[sl]
        D = torch.stack([torch.stack([d11, d12, d13]),
                         torch.stack([zero, d22, d23]),
                         torch.stack([d31, d32, d33])], 0)
        D = torch.movedim(D, 2, 0)               # (n, 3, 3, ...)
        D[-1] = D[-1] + U_full[-1]

        R = -torch.stack([r1[sl], r2[sl], r3[sl]], 1)   # (n, 3, ...)
        dx = _block_thomas(L, D, U, R)                  # (n, 3, ...)
        dx = torch.movedim(dx, 1, 0)                    # (3, n, ...)

        # 75%-step damping per column (co3:1900-1935)
        def wlimit(x, d):
            tw = -0.75 * x / (d + 1e-20)
            return torch.where((tw > 0.0) & (tw < 1.0), tw, 1.0)

        w = torch.minimum(
            torch.amin(wlimit(carb[2, sl], dx[2]), dim=0),
            torch.amin(wlimit(carb[0, sl], dx[0]), dim=0))
        carb = torch.cat([carb[:, :1], carb[:, sl] + dx * w[None, None]],
                         1)
        carb = torch.clamp(carb, min=1e-12)
    cal_c = cal_rate(carb[2]) * (1.0 - pore) * calgg * 25.0
    # [mol/l-total/s] (sediment.F:1973 without the /pore factor)
    return carb, cal_c


# ----------------------------------------------------------------------
# the per-dtsed driver (sed.F n_control=2)
# ----------------------------------------------------------------------
def porewater_step(state: PoreWaterState, temp, sal, alk_bw, tco2_bw,
                   o2_bw, rain_cal, rain_org, depth_m, ocean_mask,
                   dtsed_s):
    """One sediment coupling step over all bottom cells.

    temp/sal : bottom-water T [C], S [psu]
    alk_bw/tco2_bw : [mol/l] bottom water
    o2_bw   : [mol/l]
    rain_cal/rain_org : [mol/cm^2/s] particle rain
    depth_m : (jmt, imt) water depth [m]
    dtsed_s : the step [s], a number
    Returns (new state, fluxes) with the dic/alk/o2 fluxes to the bottom
    water [umol/cm^2/s, positive into the ocean] and the burial rate.
    """
    dt_yr = dtsed_s / SEC_PER_YR
    rain_cal_y = rain_cal * SEC_PER_YR          # mol/cm^2/yr
    rain_org_y = rain_org * SEC_PER_YR

    k1, k2, kb, csat = calc_k(temp, sal, depth_m)
    co2_bw, hco3_bw, co3_bw = calc_buff(alk_bw, tco2_bw,
                                        torch.clamp(sal, min=1.0),
                                        k1, k2, kb)
    carb = state.carb.clone()
    carb[0, 0] = co2_bw
    carb[1, 0] = hco3_bw
    carb[2, 0] = co3_bw

    pore = _set_pore(state.calgg[-1])
    form = pore ** EXPB
    rc = torch.full_like(temp, 2.0e-9)          # estimate_rc

    orggg, orgml, o2, zrct, resp_c1 = _orgc_o2(
        rain_org_y, rc, pore, form, torch.clamp(o2_bw, min=1e-6),
        state.zrct, state.orggg)

    carb, cal_c = _co3_newton(carb, resp_c1, state.calgg, pore, form,
                              csat, k1, k2)

    # interface fluxes (sed_diag): total dissolution and respiration
    # [mol/cm^2/yr]
    ttrcal = _column_sum(lambda k: cal_c[k]) * SEC_PER_YR / 1.0e3
    ttrorg = _column_sum(lambda k: resp_c1[k]) * SEC_PER_YR / 1.0e3
    # the sediment and calcite masses of the mixed layer [g/cm^2]
    sed_mass = _column_sum(lambda k: (1.0 - pore[k]) * 2.5)
    cal_mass = _column_sum(lambda k: state.calgg[k] * (1.0 - pore[k]) * 2.5)
    # dissolution cannot exceed the rain plus the standing mixed-layer
    # stock this step (mass positivity)
    stock = cal_mass / 100.0                          # mol CaCO3/cm^2
    ttrcal = torch.minimum(ttrcal, rain_cal_y + stock / max(dt_yr, 1e-12))
    # sites with negligible rain pass it straight through (calss
    # raincal_cutoff branch, sediment.F:1130-1146)
    ttrcal = torch.where(rain_cal_y > RAINCAL_CUTOFF, ttrcal, rain_cal_y)

    # mixed-layer calcite mass update (bury, bulk form): mass change =
    # rain - dissolution; burial keeps calgg <= 0.95
    dcal = (rain_cal_y - ttrcal) * 100.0 * dt_yr              # g/cm^2
    cal_new = torch.minimum(torch.clamp(cal_mass + dcal, min=0.0),
                            0.95 * sed_mass)
    burial = torch.clamp(cal_mass + dcal - 0.95 * sed_mass, min=0.0) \
        / 100.0 / max(dtsed_s, 1.0)                           # mol/cm^2/s
    frac_new = cal_new / torch.clamp(sed_mass, min=1e-12)
    wet = ocean_mask > 0
    calgg_new = frac_new[None].expand_as(state.calgg) * wet[None]

    per_s = 1.0 / SEC_PER_YR
    fluxes = dict(
        dic=(ttrcal + ttrorg) * per_s * 1.0e6 * ocean_mask,
        alk=2.0 * ttrcal * per_s * 1.0e6 * ocean_mask,
        o2=-ttrorg * 1.3 * per_s * 1.0e6 * ocean_mask,
        burial=burial * 1.0e6 * ocean_mask,
        ttrcal=ttrcal, ttrorg=ttrorg, zrct=zrct, co3_bw=co3_bw,
        csat=csat)

    new = PoreWaterState(
        calgg=torch.where(wet[None], calgg_new, state.calgg),
        orggg=torch.where(wet[None], orggg, state.orggg),
        carb=torch.where(wet[None, None], carb, state.carb),
        o2=torch.where(wet[None], o2, state.o2),
        zrct=torch.where(wet, zrct, state.zrct),
        buried=state.buried + burial * dtsed_s * ocean_mask,
        buried_org=state.buried_org)
    return new, fluxes
