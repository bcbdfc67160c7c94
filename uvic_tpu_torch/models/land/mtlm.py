"""MTLM: MOSES/TRIFFID-derived land surface + dynamic vegetation, in
PyTorch.

Port of ``uvic_tpu.models.land.mtlm`` (source/mtlm/: MOSES surface
exchange + TRIFFID dynamic vegetation + soil carbon, Cox 2001):

- dense masked (jmt, imt) fields in place of the reference's compressed
  list of LAND_PTS points (mtlmio.F loadland/unloadland),
- photosynthesis: Collatz C3/C4 with the smoothed-minimum (quadratic)
  colimitation exactly as LEAF (canopy.F:99-280), big-leaf scaled by
  FPAR (canopy.F:1-47, sf_stom.F),
- leaf phenology (phenol.F) and leaf turnover (leaf_lit.F),
- TRIFFID (triffid.F/vegcarb.F/lotka.F): balanced-growth allocation,
  implicit growth update, Lotka competition with the height-based
  dominance hierarchy resolved by explicit tree/grass pairs, litter,
  soil carbon with implicit decay (soilcarb.F),
- soil respiration (microbe.F).

PFT parameter tables reproduce mtlm_data.h:60-101 (BT, NT, C3G, C4G,
shrub). SI units like the reference land model (kg C/m^2, seconds).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from types import SimpleNamespace

import numpy as np
import torch

NPFT = 5
# parameter tables (mtlm_data.h)                BT      NT     C3G    C4G     S
C3 = np.array([1, 1, 1, 0, 1])
ALPHA = np.array([0.06, 0.06, 0.06, 0.040, 0.06])
A_WL = np.array([0.65, 0.65, 0.005, 0.005, 0.10])
A_WS = np.array([10.0, 10.0, 1.0, 1.0, 10.0])
B_WL = np.array([1.667] * 5)
DGL_DM = np.array([100.0] * 5)
DGL_DT = np.array([9.0, 9.0, 0.0, 0.0, 9.0])
DQCRIT = np.array([0.090, 0.060, 0.100, 0.075, 0.100])
ETA_SL = np.array([0.01] * 5)
F0 = np.array([0.875, 0.875, 0.900, 0.800, 0.900])
FSMC_OF = np.array([0.85, 0.60, 0.05, 0.00, 0.50])
GLMIN = np.array([1.0e-6] * 5)
G_AREA = np.array([0.004, 0.004, 0.10, 0.10, 0.05])
G_GROW = np.array([20.0] * 5)
G_LEAF_0 = np.array([0.25] * 5)
G_ROOT = np.array([0.25] * 5)
G_WOOD = np.array([0.01, 0.01, 0.20, 0.20, 0.05])
KPAR = np.array([0.50] * 5)
LAI_MAX = np.array([8.0, 8.0, 3.5, 3.5, 3.5])
LAI_MIN = np.array([3.0, 3.0, 1.0, 1.0, 1.0])
NL0 = np.array([0.036, 0.030, 0.054, 0.027, 0.027])
NR_NL = np.array([2.0] * 5)
NS_NL = np.array([0.10, 0.10, 1.0, 1.0, 0.10])
OMEGA_L = np.array([0.15, 0.15, 0.15, 0.17, 0.15])
R_GROW = np.array([0.25] * 5)
SIGL = np.array([0.0375, 0.1000, 0.0250, 0.0500, 0.0500])
TLEAF_OF = np.array([273.15, 243.15, 258.15, 258.15, 243.15])
TLOW = np.array([-10.0, -15.0, -5.0, 8.0, -10.0])
TUPP = np.array([33.0, 25.0, 33.0, 42.0, 33.0])

ZERODEGC = 273.15
KAPS = 0.35e-8      # microbe.F:56
Q10 = 2.0
FRAC_MIN = 0.01
FRAC_SEED = 0.01
DENOM_MIN = 1.0e-6
EPCO2 = 1.5194      # ratio molecular weights co2/air
EPO2 = 1.106
O2_FRAC = 0.23

# soil / surface-exchange constants (mtlm.F:152-156, common/mtlm.h:101)
ROOTDEP = 1.0        # soil layer / root depth [m]
HCAP_SOIL = 3.3e5    # soil heat capacity [J/m3/K]
HCON_SOIL = 0.75     # soil heat conductivity [W/m/K]
VSAT = 0.458         # volumetric moisture at saturation
V_CRIT = 0.34        # above which stomata unstressed
VWILT = 0.13         # below which stomata fully closed
MSAT = 1000.0 * ROOTDEP * VSAT   # saturated column moisture [kg/m2]
SATCON = 0.0005      # saturated hydraulic conductivity KS [kg/m2/s]
CLAPP_B = 6.6        # Clapp-Hornberger exponent (mtlm_state.F:70)
Z1_REF = 10.0        # reference height [m]
Z0_SOIL = 0.0003     # bare-soil roughness [m]
RSS = 100.0          # bare-soil surface resistance [s/m]
R_GAS = 287.05
CP_AIR = 1005.0
KARMAN_SQ = 0.16
SIGMA_SB = 5.67e-8
LC_W = 2.501e6       # latent heat of condensation [J/kg]
LF_W = 0.334e6       # latent heat of fusion [J/kg]
EPS_W = 0.62198      # ratio molecular weights water/air


@dataclass
class LandState:
    frac: torch.Tensor     # (NPFT+1, jmt, imt) PFT + soil fractions
    ht: torch.Tensor       # (NPFT, jmt, imt) canopy height [m]
    lai: torch.Tensor      # (NPFT, jmt, imt)
    cs: torch.Tensor       # (jmt, imt) soil carbon [kg C/m2]
    tsoil: torch.Tensor    # (jmt, imt) soil temperature [K]
    # accumulators for the TRIFFID cadence (daily sums)
    npp_acc: torch.Tensor     # (NPFT, jmt, imt) [kg C/m2/360d units]
    gleaf_acc: torch.Tensor
    resp_w_acc: torch.Tensor
    resp_s_acc: torch.Tensor  # (jmt, imt)
    nacc: torch.Tensor        # scalar accumulation count
    # aggregate canopy conductance [m/s] from the last physics step:
    # the land->atmosphere feedback channel (glsbc.F evap/sens/lwr
    # accumulators) — the EMBM land surface solve consumes it as the
    # stomatal resistance (fluxes.F land branch)
    gc: torch.Tensor = None
    # MTLM hydrology prognostics (mtlm_state.F): soil moisture column
    # [kg/m2], negative-moisture conservation tracker, lying snow
    # [kg/m2].  These drive fsmc / soil respiration / snow masking;
    # the EMBM's own land bucket (atm.soilm) remains the reservoir
    # that closes the global water budget (documented divergence from
    # glsbc.F's full replacement — both are driven by the same
    # precip/evap fluxes)
    m_soil: torch.Tensor = None
    mneg: torch.Tensor = None
    lying_snow: torch.Tensor = None

    def replace(self, **kw) -> "LandState":
        return replace(self, **kw)


_TABLES = {}


def _tables(like):
    """The PFT tables as (NPFT, 1, 1) tensors of ``like``'s dtype and
    device, made once per (dtype, device) so that a captured step makes
    no host-to-device copy."""
    key = (like.dtype, like.device)
    if key not in _TABLES:
        def col(a):
            return torch.as_tensor(np.asarray(a, np.float64)[:, None, None],
                                   dtype=like.dtype, device=like.device)
        _TABLES[key] = SimpleNamespace(
            awl=col(A_WL), aws=col(A_WS), bwl=col(B_WL), etasl=col(ETA_SL),
            sigl=col(SIGL), g_root=col(G_ROOT), g_wood=col(G_WOOD),
            lai_min=col(LAI_MIN), lai_max=col(LAI_MAX), g_area=col(G_AREA))
    return _TABLES[key]


def init_land_state(jmt, imt, lmask, dtype, device="cpu"):
    lmask = np.asarray(lmask)
    frac = np.zeros((NPFT + 1, jmt, imt))
    frac[:NPFT] = 0.05
    frac[2] = 0.4          # C3 grass dominant initial cover
    frac[NPFT] = 1.0 - frac[:NPFT].sum(0)
    frac *= lmask[None]
    lai = np.maximum(LAI_MIN[:, None, None] * np.ones((NPFT, jmt, imt)),
                     0.0) * lmask[None]
    ht = A_WL[:, None, None] / (A_WS * ETA_SL)[:, None, None] \
        * lai ** (B_WL[:, None, None] - 1.0) * lmask[None]
    z = np.zeros((jmt, imt))

    def tn(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return LandState(
        frac=tn(frac), ht=tn(ht), lai=tn(lai), cs=tn(10.0 * lmask),
        tsoil=tn(283.0 * np.ones((jmt, imt))),
        npp_acc=tn(np.zeros((NPFT, jmt, imt))),
        gleaf_acc=tn(np.zeros((NPFT, jmt, imt))),
        resp_w_acc=tn(np.zeros((NPFT, jmt, imt))),
        resp_s_acc=tn(z),
        nacc=torch.zeros((), dtype=torch.int32, device=device),
        gc=tn(z), m_soil=tn(0.5 * MSAT * lmask), mneg=tn(z),
        lying_snow=tn(z))


def penman_monteith(rs, z0, lw_down, swn, pstar, q1, t1_k, ts1_k,
                    wind, lying_snow):
    """Aggregate-tile Penman-Monteith surface exchange (penmon.F:1-165).

    All SI: fluxes W/m^2, E kg/m^2/s.  ``rs`` surface resistance [s/m],
    ``z0`` roughness [m], ``lw_down`` downward longwave, ``swn`` net
    absorbed shortwave, ``wind`` [m/s].
    Returns dict(E, LE, SH, G, TSTAR, LW_OUT, RADNET)."""
    as1 = 2.0 * HCON_SOIL / ROOTDEP
    rhostar = pstar / (R_GAS * t1_k)
    qs1 = EPS_W * 610.78 * torch.exp(
        17.27 * (t1_k - ZERODEGC) / (t1_k - ZERODEGC + 237.3)) / pstar
    lat = torch.where(lying_snow > 50.0, LC_W + LF_W,
                      LC_W + torch.zeros_like(lying_snow))
    dqs_dt = EPS_W * lat * qs1 / (R_GAS * t1_k ** 2)
    dq1 = qs1 - q1
    ahat = swn + lw_down - SIGMA_SB * t1_k ** 4 - as1 * (t1_k - ts1_k)
    zetam = torch.log((Z1_REF + z0) / z0)
    zetah = torch.log((Z1_REF + z0) / (0.1 * z0))
    chn = KARMAN_SQ / (zetah * zetam)
    ra = 1.0 / (chn * torch.clamp(wind, min=0.1))
    resf = 1.0 / (1.0 + rs / ra)
    dum = rhostar * CP_AIR / ra + 4.0 * SIGMA_SB * t1_k ** 3 + as1
    numer = (dqs_dt * ahat + dum * dq1) * resf
    denom = resf * lat * dqs_dt + ra * dum / rhostar
    e = numer / denom
    le = lat * e
    tstar = t1_k + (ahat - lat * rhostar * dq1 * resf / ra) \
        / (dum + dqs_dt * lat * rhostar * resf / ra)
    sh = rhostar * CP_AIR / ra * (tstar - t1_k)
    lw_out = lw_down - SIGMA_SB * tstar ** 4
    radnet = swn + lw_out
    g = radnet - le - sh
    return dict(E=e, LE=le, SH=sh, G=g, TSTAR=tstar, LW_OUT=lw_out,
                RADNET=radnet)


def mtlm_state_update(tsoil, m_soil, mneg, lying_snow, g_flux, rain,
                      snow, e, esub, dt):
    """Land prognostic update (mtlm_state.F:74-121): soil temperature
    from the ground heat flux, snowmelt limited by the available snow,
    lying snow with the negative-snow fix, Clapp-Hornberger drainage,
    soil moisture with the MNEG conservation tracker.  All SI.
    Returns (tsoil, m_soil, mneg, lying_snow, runoff, snowmelt, e,
    esub)."""
    hc_dz = ROOTDEP * HCAP_SOIL
    tm = ZERODEGC
    ts1 = tsoil + dt * g_flux / hc_dz
    melt_cap = snow - esub + lying_snow / dt
    melt_raw = hc_dz * (ts1 - tm) / (LF_W * dt)
    snowy = (lying_snow > 0.0) & (ts1 > tm)
    limited = melt_raw > melt_cap
    snowmelt = torch.where(snowy,
                           torch.where(limited, melt_cap, melt_raw), 0.0)
    ts1 = torch.where(snowy,
                      torch.where(limited,
                                  ts1 - snowmelt * LF_W * dt / hc_dz,
                                  tm + torch.zeros_like(ts1)),
                      ts1)
    lying = lying_snow + dt * (snow - esub - snowmelt)
    # negative snow -> convert the excess sublimation to evaporation
    neg = lying < 0.0
    esub = torch.where(neg, esub + lying / dt, esub)
    e = torch.where(neg, e - lying / dt, e)
    ts1 = torch.where(neg, ts1 + LF_W * lying / hc_dz, ts1)
    lying = torch.clamp(lying, min=0.0)
    runoff = SATCON * torch.clamp(m_soil / MSAT, 0.0, 1.5) \
        ** (2.0 * CLAPP_B + 3.0)
    m = m_soil + dt * (rain + snowmelt - e - runoff)
    tot = m + mneg
    m_new = torch.where(tot < 0.0, 0.0, tot)
    mneg_new = torch.where(tot < 0.0, mneg + m, 0.0)
    return (ts1, m_new, mneg_new, lying, runoff, snowmelt, e, esub)


def leaf_photosynthesis(n, dq, apar, tl_k, ca, oa, pstar, fsmc):
    """Collatz leaf model for PFT n (canopy.F LEAF:99-280).
    Returns (gl [m/s], al net assimilation [mol CO2/m2/s], rd)."""
    c3 = C3[n] == 1
    fdc = 0.015 if c3 else 0.025
    neffc = 0.64e-3 if c3 else 0.32e-3
    tdegc = tl_k - ZERODEGC
    vcmax = neffc * float(NL0[n])
    qtenf = vcmax * 2.0 ** (0.1 * (tdegc - 25.0))
    denom = ((1 + torch.exp(0.3 * (tdegc - float(TUPP[n]))))
             * (1 + torch.exp(0.3 * (float(TLOW[n]) - tdegc))))
    vcm = qtenf / denom
    rd = fdc * qtenf

    if c3:
        tau = 2600.0 * 0.57 ** (0.1 * (tdegc - 25.0))
        ccp = 0.5 * oa / tau
    else:
        ccp = torch.zeros_like(tdegc)
    ci = (ca - ccp) * float(F0[n]) * (1.0 - dq / float(DQCRIT[n])) + ccp
    acr = apar / 2.19e5
    if c3:
        kc = 30.0 * 2.1 ** (0.1 * (tdegc - 25.0))
        ko = 30000.0 * 1.2 ** (0.1 * (tdegc - 25.0))
        wcarb = vcm * (ci - ccp) / (ci + kc * (1.0 + oa / ko))
        wlite = float(ALPHA[n]) * acr * (ci - ccp) / (ci + 2 * ccp)
        wexpt = 0.5 * vcm
    else:
        wcarb = vcm
        wlite = float(ALPHA[n]) * acr
        wexpt = 20000.0 * vcm * ci / pstar

    def smooth_min(w1, w2, beta):
        b2 = -(w1 + w2)
        b3 = w1 * w2
        disc = torch.clamp(b2 * b2 / (4 * beta * beta) - b3 / beta, min=0.0)
        return -b2 / (2 * beta) - torch.sqrt(disc)

    wp = smooth_min(wcarb, wlite, 0.83)
    wl = smooth_min(wp, wexpt, 0.93)
    al = (wl - rd) * fsmc
    # stomata closed where dry air / no light / no soil moisture
    closed = (fsmc <= 0.0) | (dq >= float(DQCRIT[n])) | (apar <= 0.0)
    al = torch.where(closed, -rd * fsmc, al)
    conv = 8.3144 * tl_k
    glco2 = torch.clamp(1.6 * al * conv / torch.clamp(ca - ci, min=1e-10),
                        min=float(GLMIN[n]))
    gl = torch.where(closed, float(GLMIN[n]), 1.6 * glco2)
    return gl, al, rd


def sf_stom(n, co2_ppm, fsmc, ht, ipar, lai, pstar, tstar_k, dq):
    """Canopy-scaled fluxes for PFT n (sf_stom.F): returns
    (gpp, npp, resp_w, gc) in kg C/m2/s and m/s."""
    kpar, a_ws, a_wl = float(KPAR[n]), float(A_WS[n]), float(A_WL[n])
    eta_sl, b_wl, nl0 = float(ETA_SL[n]), float(B_WL[n]), float(NL0[n])
    sigl = float(SIGL[n])
    fpar = (1.0 - torch.exp(-kpar * lai)) / kpar
    ca = co2_ppm * 1.0e-6 / EPCO2 * pstar
    oa = O2_FRAC / EPO2 * pstar
    apar = (1.0 - float(OMEGA_L[n])) * ipar
    gl, anetl, rd = leaf_photosynthesis(n, dq, apar, tstar_k, ca, oa,
                                        pstar, fsmc)
    anetc = anetl * fpar
    gc = fpar * gl
    rdc = rd * fpar

    lai_bal = (a_ws * eta_sl * torch.clamp(ht, min=1e-3)
               / a_wl) ** (1.0 / (b_wl - 1.0))
    root = sigl * lai_bal
    lai_s = torch.clamp(lai, min=1e-3)
    nl = (fpar / lai_s) * nl0
    nl_bal = (1.0 - torch.exp(-kpar * lai_bal)) \
        / (kpar * torch.clamp(lai_bal, min=1e-3)) * nl0
    n_leaf = nl * sigl * lai_s
    n_root = float(NR_NL[n]) * nl_bal * root
    n_stem = float(NS_NL[n]) * nl_bal * eta_sl * ht * lai_s
    gpp = 12.0e-3 * (anetc + rdc * fsmc)
    resp_p_m = 12.0e-3 * rdc * (n_leaf * fsmc + n_stem + n_root) \
        / torch.clamp(n_leaf, min=1e-10)
    resp_w = 12.0e-3 * rdc * n_stem / torch.clamp(n_leaf, min=1e-10)
    resp_p_g = float(R_GROW[n]) * (gpp - resp_p_m)
    npp = gpp - (resp_p_m + resp_p_g)
    return gpp, npp, resp_w, gc


def soil_respiration(cs, tsoil_k, sth=0.7):
    """RESP_S = KAPS*CS*FSTH*FTEMP (microbe.F:30-80), kg C/m2/s."""
    sth_wilt, sth_opt = 0.2, 0.5
    sth = torch.as_tensor(sth, dtype=cs.dtype, device=cs.device)
    fsth = torch.where(sth <= sth_wilt, 0.2,
                       torch.where(sth <= sth_opt,
                                   0.2 + 0.8 * (sth - sth_wilt)
                                   / (sth_opt - sth_wilt),
                                   1.0 - 0.8 * (sth - sth_opt)))
    ftemp = Q10 ** (0.1 * (tsoil_k - 298.15))
    return KAPS * cs * fsth * ftemp


def leaf_turnover(n, fsmc, tstar_k):
    """g_leaf [/360d] (leaf_lit.F)."""
    tleaf, dgl_dt = float(TLEAF_OF[n]), float(DGL_DT[n])
    fsmc_of, dgl_dm = float(FSMC_OF[n]), float(DGL_DM[n])
    ft = torch.where(tstar_k < tleaf, 1.0 + dgl_dt * (tleaf - tstar_k), 1.0)
    fm = torch.where((tstar_k >= tleaf) & (fsmc < fsmc_of),
                     1.0 + dgl_dm * (fsmc_of - fsmc), 1.0)
    return float(G_LEAF_0[n]) * ft * fm


def triffid_update(state: LandState, lmask, gamma, forw=0.0):
    """One TRIFFID step (triffid.F): vegetation carbon, competition,
    litter, soil carbon.  gamma = 1/timestep [/360days]."""
    tb = _tables(state.frac)
    nacc = torch.clamp(state.nacc, min=1).to(state.frac.dtype)
    npp = state.npp_acc / nacc
    g_leaf = state.gleaf_acc / nacc
    resp_s = state.resp_s_acc / nacc

    frac = state.frac
    ht = state.ht
    lai = state.lai
    eps = 1e-6
    awl, aws, bwl, etasl, sigl = tb.awl, tb.aws, tb.bwl, tb.etasl, tb.sigl

    # balanced-growth pools (triffid.F:104-121)
    lai_bal = (aws * etasl * torch.clamp(ht, min=1e-3)
               / awl) ** (1.0 / (bwl - 1.0))
    lai_bal = torch.clamp(lai_bal, 1e-2, 12.0)
    leaf = sigl * lai_bal
    root = leaf
    wood = awl * lai_bal ** bwl
    phen = torch.clamp(lai / torch.clamp(lai_bal, min=eps), 0.01, 1.0)

    # ---- vegcarb/growth: implicit wood increment (vegcarb.F) ----------
    lai_v = torch.clamp(lai_bal, min=1e-2)
    lit_c_l = g_leaf * leaf + tb.g_root * root + tb.g_wood * wood
    pc = npp - lit_c_l
    lambda_g = torch.clamp(
        1.0 - (lai_v - tb.lai_min) / (tb.lai_max - tb.lai_min), 0.0, 1.0)
    pc_g = lambda_g * npp - lit_c_l

    dl_dw = leaf / torch.clamp(bwl * wood, min=eps)
    denom = (1.0 + 2.0 * dl_dw) * gamma
    dwood = pc_g / torch.clamp(denom, min=DENOM_MIN)
    wood_min = awl * tb.lai_min ** bwl
    wood_max = awl * tb.lai_max ** bwl
    dwood = torch.minimum(torch.maximum(dwood, wood_min - wood),
                          wood_max - wood)
    wood_n = wood + dwood
    leaf_n = sigl * (wood_n / awl) ** (1.0 / bwl)
    root_n = leaf_n
    dcveg = (leaf_n + root_n + wood_n) - (leaf + root + wood)
    c_veg = leaf_n + root_n + wood_n
    pc_s = pc - dcveg * gamma

    ht_n = wood_n / (aws * etasl) * (awl / wood_n) ** (1.0 / bwl)
    lai_bal_n = leaf_n / sigl
    lai_n = phen * lai_bal_n

    # ---- Lotka competition (lotka.F + COMPETE): dominance-ordered
    # sequential implicit solve, trees (taller of BT/NT first) > shrub >
    # grasses (taller of C3/C4 first); each rank claims space, is
    # clipped to [FRAC_MIN, remaining space] and reduces the space of
    # the next rank (lotka.F:275-400).  FORW=0 (the dynamic mode,
    # mtlm.F:476) makes each solve explicit.
    hc = awl / (aws * etasl) * lai_bal_n ** (bwl - 1.0)
    pow_ = 20.0
    c12 = 1.0 / (1.0 + torch.exp(
        pow_ * (hc[0] - hc[1]) / torch.clamp(hc[0] + hc[1], min=eps)))
    c34 = 1.0 / (1.0 + torch.exp(
        pow_ * (hc[2] - hc[3]) / torch.clamp(hc[2] + hc[3], min=eps)))
    # competition matrix com[n, m]: shading of n by m (lotka.F:70-105)
    one = torch.ones_like(c12)
    zero = torch.zeros_like(c12)
    com = torch.stack([
        torch.stack([one, c12, zero, zero, zero]),
        torch.stack([1 - c12, one, zero, zero, zero]),
        torch.stack([one, one, one, c34, one]),
        torch.stack([one, one, 1 - c34, one, one]),
        torch.stack([one, one, zero, zero, one]),
    ])
    frac_vs = torch.sum(frac[:NPFT], dim=0) + frac[NPFT]
    nosoil = 1.0 - frac_vs
    # dominance rank per PFT (1-based, lotka.F:135-138)
    t_dom = hc[0] >= hc[1]          # BT dominant over NT
    g_dom = hc[2] >= hc[3]          # C3 dominant over C4
    rank = torch.stack([
        torch.where(t_dom, 1.0, 2.0 * one), torch.where(t_dom, 2.0, one),
        torch.where(g_dom, 4.0, 5.0 * one), torch.where(g_dom, 5.0,
                                                        4.0 * one),
        3.0 * one])
    # COM(n,n)=1 and the sum includes the self-term (lotka.F:139-146)
    space_n = (1.0 - nosoil[None] - FRAC_MIN * (NPFT - rank)
               - torch.einsum("nm...,m...->n...", com, frac[:NPFT]))
    pc_cv = pc_s / torch.clamp(c_veg, min=eps)
    b = pc_cv * space_n - tb.g_area
    db = -com * pc_cv[:, None]      # DB_DFRAC(n,m) = -COM(n,m)*PC/CV

    forw_w = forw
    dfrac = [torch.zeros_like(one) for _ in range(NPFT)]
    frac_l = [frac[n] for n in range(NPFT)]
    space = 1.0 - nosoil - FRAC_MIN * (NPFT - 1)

    def coupled_rhs(n):
        r = b[n]
        for k in range(NPFT):
            r = r + forw_w * db[n, k] * dfrac[k]
        return r

    def clip_and_claim(n, d, space):
        f = frac_l[n] + d
        lo = f < FRAC_MIN
        hi = f > space
        # the seed floor first, then the space ceiling last (COMPETE
        # sets FRAC=SPACE even when space < FRAC_MIN)
        f = torch.minimum(torch.clamp(f, min=FRAC_MIN),
                          torch.clamp(space, min=0.0))
        d = torch.where(lo | hi, f - frac_l[n], d)
        frac_l[n] = f
        dfrac[n] = d
        return space - f + FRAC_MIN

    def solve_pair(i0, i1, dom01, space):
        """2x2 implicit solve for a dominance pair, dominant first
        (COMPETE P/Q/R elimination), with where-swaps for the per-cell
        dominance direction."""
        swapped = ~dom01

        def sel(a, bsl):
            return torch.where(swapped, bsl, a)

        iN, iM = i0, i1
        fracn = torch.clamp(sel(frac_l[iN], frac_l[iM]), min=FRAC_SEED)
        fracm = torch.clamp(sel(frac_l[iM], frac_l[iN]), min=FRAC_SEED)
        dbNN = sel(db[iN, iN], db[iM, iM])
        dbMM = sel(db[iM, iM], db[iN, iN])
        dbNM = sel(db[iN, iM], db[iM, iN])
        dbMN = sel(db[iM, iN], db[iN, iM])
        p1 = gamma / fracn - forw_w * dbNN
        p2 = gamma / fracm - forw_w * dbMM
        q1 = -forw_w * dbNM
        q2 = -forw_w * dbMN
        r1 = sel(coupled_rhs(iN), coupled_rhs(iM))
        r2 = sel(coupled_rhs(iM), coupled_rhs(iN))
        dN = (r1 - (q1 / p2) * r2) / torch.clamp(p1 - (q1 / p2) * q2,
                                                 min=DENOM_MIN)
        # the dominant claims space first
        fN_old = sel(frac_l[iN], frac_l[iM])
        fN = fN_old + dN
        fN_cl = torch.minimum(torch.clamp(fN, min=FRAC_MIN),
                              torch.clamp(space, min=0.0))
        dN = torch.where((fN < FRAC_MIN) | (fN > space), fN_cl - fN_old,
                         dN)
        space = space - fN_cl + FRAC_MIN
        # subordinate
        dM = (r2 - q2 * dN) / torch.clamp(p2, min=DENOM_MIN)
        fM_old = sel(frac_l[iM], frac_l[iN])
        fM = fM_old + dM
        fM_cl = torch.minimum(torch.clamp(fM, min=FRAC_MIN),
                              torch.clamp(space, min=0.0))
        dM = torch.where((fM < FRAC_MIN) | (fM > space), fM_cl - fM_old,
                         dM)
        space = space - fM_cl + FRAC_MIN
        # scatter back to physical indices
        frac_l[i0] = torch.where(swapped, fM_cl, fN_cl)
        frac_l[i1] = torch.where(swapped, fN_cl, fM_cl)
        dfrac[i0] = torch.where(swapped, dM, dN)
        dfrac[i1] = torch.where(swapped, dN, dM)
        return space

    space = solve_pair(0, 1, t_dom, space)          # trees
    # shrub (single, rank 3)
    fracn = torch.clamp(frac_l[4], min=FRAC_SEED)
    d4 = coupled_rhs(4) / torch.clamp(
        gamma / fracn - forw_w * db[4, 4], min=DENOM_MIN)
    space = clip_and_claim(4, d4, space)
    space = solve_pair(2, 3, g_dom, space)          # grasses

    frac_new = torch.stack(frac_l)
    # soil is the exact residual (lotka.F:449-452)
    soil_frac = torch.clamp(1.0 - nosoil - torch.sum(frac_new, dim=0),
                            min=0.0)
    frac_out = torch.cat([frac_new, soil_frac[None]], dim=0)
    dfrac = frac_new - frac[:NPFT]

    # ---- litter + soil carbon (triffid.F:157-178, soilcarb.F) --------
    lit_c = npp - gamma * (c_veg * frac_new
                           - (c_veg - dcveg)
                           * (frac_new - dfrac)) \
        / torch.clamp(frac_new, min=eps)
    lit_c_t = torch.sum(frac_new * lit_c, dim=0)
    pc_soil = lit_c_t - resp_s
    dpc_dcs = resp_s / torch.clamp(state.cs, min=eps)
    dcs = pc_soil / torch.clamp(gamma + forw * dpc_dcs, min=DENOM_MIN)
    cs_new = torch.clamp(state.cs + dcs, min=1e-3)

    zero_acc = torch.zeros_like(state.npp_acc)
    return state.replace(
        frac=frac_out * lmask[None] + state.frac * (1 - lmask[None]),
        ht=torch.clamp(ht_n, 1e-3, 60.0) * lmask[None],
        lai=torch.clamp(lai_n, 0.01, 12.0) * lmask[None],
        cs=cs_new * lmask + state.cs * (1 - lmask),
        npp_acc=zero_acc, gleaf_acc=zero_acc.clone(),
        resp_w_acc=zero_acc.clone(),
        resp_s_acc=torch.zeros_like(state.resp_s_acc),
        nacc=torch.zeros_like(state.nacc),
    ), dict(lit_c_t=lit_c_t, npp=npp, resp_s=resp_s)


def mtlm_physics_step(state: LandState, lmask, sat_c, shum, swr, rh,
                      soilm_frac, co2_ppm=280.0, pstar=1.0e5,
                      precip=None, psno=None, wspd=None, dt=None):
    """Per-coupling-step land physics (mtlm.F driver): photosynthesis,
    respiration, accumulation for TRIFFID; with the hydrology forcing
    (precip/psno [kg/m2/s], wspd [m/s], dt [s]) also the per-tile
    Penman-Monteith surface exchange (penmon.F) and the prognostic
    snow / soil-moisture / soil-temperature update (mtlm_state.F).
    sat_c in degC, swr in erg/cm^2/s.
    Returns (new_state, fluxes) with nep [kg C/m2/s] (+ = land uptake)
    and the canopy conductance."""
    tstar_k = sat_c + ZERODEGC
    ipar = torch.clamp(swr, min=0.0) * 1e-3 * 0.5   # W/m2 -> PAR
    qs = 3.8011e-3 * torch.exp(17.67 * sat_c / (sat_c + 243.5))
    dq = torch.clamp(qs * (1.0 - rh), min=0.0)
    hydrology = precip is not None and dt is not None
    if hydrology and state.m_soil is not None:
        # MOSES soil-moisture stress from the prognostic column
        # (mtlm.F:223-229)
        v_root = state.m_soil / (1000.0 * ROOTDEP)
        fsmc = torch.clamp((v_root - VWILT) / (V_CRIT - VWILT), 0.0, 1.0)
    else:
        fsmc = torch.clamp(soilm_frac, 0.0, 1.0)

    nep = torch.zeros_like(sat_c)
    gc_eff = torch.zeros_like(sat_c)
    npp_pft = []
    gleaf_pft = []
    respw_pft = []
    gc_pft = []
    per360 = 360.0 * 86400.0
    for n in range(NPFT):
        gpp, npp, resp_w, gc = sf_stom(
            n, co2_ppm, fsmc, state.ht[n], ipar, state.lai[n],
            pstar, tstar_k, dq)
        # accumulate in TRIFFID units [kg C/m2/360days]
        npp_pft.append(npp * per360)
        respw_pft.append(resp_w * per360)
        gleaf_pft.append(leaf_turnover(n, fsmc, tstar_k))
        gc_pft.append(gc)
        nep = nep + state.frac[n] * npp
        gc_eff = gc_eff + state.frac[n] * gc
    # bare-soil conductance for the non-vegetated fraction
    gc_soil = 1.0e-3 * fsmc
    gc_eff = gc_eff + state.frac[NPFT] * gc_soil
    # soil respiration at the prognostic soil temperature when the
    # hydrology runs (microbe.F uses TSOIL)
    t_resp = state.tsoil if hydrology and state.m_soil is not None \
        else tstar_k
    resp_s = soil_respiration(state.cs, t_resp, 0.3 + 0.6 * fsmc)
    nep = nep - resp_s

    updates = dict(
        npp_acc=state.npp_acc + torch.stack(npp_pft) * lmask[None],
        gleaf_acc=state.gleaf_acc + torch.stack(gleaf_pft) * lmask[None],
        resp_w_acc=state.resp_w_acc + torch.stack(respw_pft) * lmask[None],
        resp_s_acc=state.resp_s_acc + resp_s * 360.0 * 86400.0 * lmask,
        nacc=state.nacc + 1,
        gc=gc_eff * lmask,
    )
    flx = dict(nep=nep * lmask, resp_s=resp_s * lmask, gc=gc_eff * lmask)

    if hydrology and state.m_soil is not None:
        # per-PFT tile Penman-Monteith (mtlm.F:240-320): each tile sees
        # its own stomatal resistance and roughness; the surface fluxes
        # aggregate frac-weighted
        ntile = NPFT + 1
        gc_tiles = torch.stack(gc_pft + [gc_soil])
        rs_tiles = torch.clamp(1.0 / torch.clamp(gc_tiles, min=1e-6),
                               0.0, 1.0e4)
        # snow > 50 kg/m2 behaves as a saturated surface (mtlm.F:255)
        rs_tiles = torch.where(state.lying_snow[None] > 50.0, 0.0,
                               rs_tiles)
        z0_tiles = torch.cat([
            torch.clamp(0.05 * state.ht, min=Z0_SOIL),
            torch.full_like(state.ht[:1], Z0_SOIL)], dim=0)
        swn = torch.clamp(swr, min=0.0) * 1e-3       # erg -> W/m2
        lw_down = 4.6e-5 * 1e-3 * tstar_k ** 4       # ESATM, cgs->SI
        pm_t = penman_monteith(
            rs_tiles, z0_tiles, lw_down[None], swn[None], pstar,
            shum[None], tstar_k[None], state.tsoil[None], wspd[None],
            state.lying_snow[None])
        frac_t = state.frac[:ntile]
        fsum = torch.clamp(torch.sum(frac_t, dim=0), min=1e-6)
        pm = {k: torch.sum(frac_t * v, dim=0) / fsum
              for k, v in pm_t.items()}
        e_tot = torch.clamp(pm["E"], min=0.0)
        snowy = state.lying_snow > 0.0
        esub = torch.where(snowy, e_tot, 0.0)
        e_soil = torch.where(snowy, 0.0, e_tot)
        snow_in = psno if psno is not None else torch.zeros_like(precip)
        rain_in = torch.clamp(precip - snow_in, min=0.0)
        ts1, m_new, mneg_new, lying, runoff, snowmelt, e_soil, esub = \
            mtlm_state_update(state.tsoil, state.m_soil, state.mneg,
                              state.lying_snow, pm["G"], rain_in,
                              snow_in, e_soil, esub, dt)
        land = lmask > 0
        updates.update(
            tsoil=torch.where(land, ts1, state.tsoil),
            m_soil=torch.where(land, m_new, state.m_soil),
            mneg=torch.where(land, mneg_new, state.mneg),
            lying_snow=torch.where(land, lying, state.lying_snow))
        flx.update(evap_land=e_tot * lmask, runoff_land=runoff * lmask,
                   snowmelt=snowmelt * lmask, tstar=pm["TSTAR"],
                   gflux=pm["G"] * lmask)
    else:
        updates["tsoil"] = 0.99 * state.tsoil + 0.01 * tstar_k

    return state.replace(**updates), flx
