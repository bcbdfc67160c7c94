"""Air-sea gas exchange and carbonate chemistry, in PyTorch.

Port of ``uvic_tpu.models.bgc.gasx``: the carbonate chemistry of
source/common/co2calc.F (OCMIP-2 ``co2calc_SWS``: equilibrium constants
on the seawater H+ scale with the Millero (1995) pressure corrections,
and the alkalinity-DIC iteration for pH as a fixed number of safeguarded
Newton trips over every point at once), and the gasbc.F flux block
(gasbc.F:310-470: Wanninkhof piston velocities through the open-water
fraction, Garcia & Gordon O2 saturation, the CO2 and C14 fluxes from
dco2star, the CFC fluxes from the Warner & Weiss solubilities).  Trip
counts are fixed and nothing reads a value back to the host, so the
fluxes can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

XCONV = 33.7 / 3.6e5     # piston velocity conversion (gasbc.F:63)
PERMIL = 1.0 / 1024.5
C2K = 273.15


def _equilibrium_constants(t, s, pres=0.0):
    """OCMIP constants (co2calc.F:140-300).

    pres is pressure in bars (co2calc.F:121 ``pres = depth*0.1``); the
    Millero (1995) pressure corrections collapse to 1 at the surface.
    """
    tk = C2K + t
    tk100 = tk / 100.0
    tk1002 = tk100 * tk100
    invtk = 1.0 / tk
    dlogtk = torch.log(tk)
    is_ = 19.924 * s / (1000.0 - 1.005 * s)
    is2 = is_ * is_
    sqrtis = torch.sqrt(is_)
    s2 = s * s
    t2 = t * t
    sqrts = torch.sqrt(s)
    s15 = s ** 1.5
    scl = s / 1.80655
    # pres/tk/R with R = 83.15 cm^3 bar / (mol K) (co2calc.F:154)
    pitkr = pres / tk / 83.15
    p2itkr = pres * pitkr
    log_s = torch.log(1.0 - 0.001005 * s)

    bt = 0.000232 * scl / 10.811
    st = 0.14 * scl / 96.062
    ft = 0.000067 * scl / 18.9984

    ff = torch.exp(-162.8301 + 218.2968 / tk100 + 90.9241 * torch.log(tk100)
                   - 1.47696 * tk1002 + s * (0.025695 - 0.025225 * tk100
                                             + 0.0049867 * tk1002))
    k1 = 10.0 ** (-(3670.7 * invtk - 62.008 + 9.7944 * dlogtk
                    - 0.0118 * s + 0.000116 * s2)) \
        * torch.exp((25.5 - 0.1271 * t) * pitkr
                    + 0.5 * (-3.08e-3 + 8.77e-5 * t) * p2itkr)
    k2 = 10.0 ** (-(1394.7 * invtk + 4.777 - 0.0184 * s
                    + 0.000118 * s2)) \
        * torch.exp((15.82 + 0.0219 * t) * pitkr
                    + 0.5 * (1.13e-3 - 1.475e-4 * t) * p2itkr)
    k1p = torch.exp(-4576.752 * invtk + 115.540 - 18.453 * dlogtk
                    + (-106.736 * invtk + 0.69171) * sqrts
                    + (-0.65643 * invtk - 0.01844) * s
                    + (14.51 - 0.1211 * t + 3.21e-4 * t2) * pitkr
                    + 0.5 * (-2.67e-3 + 4.27e-5 * t) * p2itkr)
    k2p = torch.exp(-8814.715 * invtk + 172.1033 - 27.927 * dlogtk
                    + (-160.340 * invtk + 1.3566) * sqrts
                    + (0.37335 * invtk - 0.05778) * s
                    + (23.12 - 0.1758 * t + 2.647e-3 * t2) * pitkr
                    + 0.5 * (-5.15e-3 + 9.0e-5 * t) * p2itkr)
    k3p = torch.exp(-3070.75 * invtk - 18.126
                    + (17.27039 * invtk + 2.81197) * sqrts
                    + (-44.99486 * invtk - 0.09984) * s
                    + (26.57 - 0.202 * t + 3.042e-3 * t2) * pitkr
                    + 0.5 * (-4.08e-3 + 7.14e-5 * t) * p2itkr)
    ksi = torch.exp(-8904.2 * invtk + 117.400 - 19.334 * dlogtk
                    + (-458.79 * invtk + 3.5913) * sqrtis
                    + (188.74 * invtk - 1.5998) * is_
                    + (-12.1652 * invtk + 0.07871) * is2
                    + log_s
                    + (29.48 - 0.1622 * t - 2.608e-3 * t2) * pitkr
                    + 0.5 * (-2.84e-3) * p2itkr)
    kw = torch.exp(-13847.26 * invtk + 148.9802 - 23.6521 * dlogtk
                   + (118.67 * invtk - 5.977 + 1.0495 * dlogtk) * sqrts
                   - 0.01615 * s
                   + (20.02 - 0.1119 * t + 1.409e-3 * t2) * pitkr
                   + 0.5 * (-5.13e-3 + 7.94e-5 * t) * p2itkr)
    ks = torch.exp(-4276.1 * invtk + 141.328 - 23.093 * dlogtk
                   + (-13856.0 * invtk + 324.57 - 47.986 * dlogtk) * sqrtis
                   + (35474.0 * invtk - 771.54 + 114.723 * dlogtk) * is_
                   - 2698.0 * invtk * is_ ** 1.5 + 1776.0 * invtk * is2
                   + log_s
                   + (18.03 - 0.0466 * t - 3.16e-4 * t2) * pitkr
                   + 0.5 * (-4.53e-3 + 9.0e-5 * t) * p2itkr)
    kf = torch.exp(1590.2 * invtk - 12.641 + 1.525 * sqrtis
                   + log_s
                   + (9.78 + 9.0e-3 * t + 9.42e-4 * t2) * pitkr
                   + 0.5 * (-3.91e-3 + 5.4e-5 * t) * p2itkr)
    kb = torch.exp((-8966.90 - 2890.53 * sqrts - 77.942 * s
                    + 1.728 * s15 - 0.0996 * s2) * invtk
                   + (148.0248 + 137.1942 * sqrts + 1.62142 * s)
                   + (-24.4344 - 25.085 * sqrts - 0.2474 * s) * dlogtk
                   + 0.053105 * sqrts * tk
                   + torch.log((1 + (st / ks) + (ft / kf)) / (1 + (st / ks)))
                   + (29.48 - 0.1622 * t - 2.608e-3 * t2) * pitkr
                   + 0.5 * (-2.84e-3) * p2itkr)
    return dict(k1=k1, k2=k2, k1p=k1p, k2p=k2p, k3p=k3p, ksi=ksi, kw=kw,
                ks=ks, kf=kf, kb=kb, ff=ff, bt=bt, st=st, ft=ft)


def _ta_residual(h, k, dic, ta, pt, sit):
    """Total alkalinity residual f(H) (OCMIP ta_iter_SWS)."""
    x2 = h * h
    x3 = x2 * h
    k12 = k["k1"] * k["k2"]
    k12p = k["k1p"] * k["k2p"]
    k123p = k12p * k["k3p"]
    c = 1.0 + k["st"] / k["ks"] + k["ft"] / k["kf"]
    a = x3 + k["k1p"] * x2 + k12p * h + k123p
    b = x2 + k["k1"] * h + k12
    f = (k["k1"] * h * dic / b + 2.0 * dic * k12 / b
         + k["bt"] / (1.0 + h / k["kb"]) + k["kw"] / h
         + pt * k12p * h / a + 2.0 * pt * k123p / a
         + sit / (1.0 + h / k["ksi"])
         - h / c
         - k["st"] / (1.0 + k["ks"] / (h / c))
         - k["ft"] / (1.0 + k["kf"] / (h / c))
         - pt * x3 / a
         - ta)
    return f


def co2calc_sws(t, s, dic_in, ta_in, co2ppm, pt_in=0.0, sit_in=0.0,
                atmpres=1.0, ph_lo=6.0, ph_hi=10.0, n_iter=40,
                depth_m=0.0):
    """Carbonate chemistry at depth (co2calc.F co2calc_SWS).

    dic_in/ta_in in umol/cm^3 (mol/m^3); co2ppm in ppmv; depth_m in
    meters (pressure ~ depth/10 bars, co2calc.F:121), a number or a
    tensor that broadcasts against t.
    Returns dict with co2star, dco2star, pCO2 [uatm], pH, CO3 [mol/m^3]
    and the calcite/aragonite saturation states Omega_c / Omega_a
    (Mucci 1983 Ksp0 + Millero 1983 pressure terms,
    co2calc.F:356-398).
    """
    dic = dic_in * PERMIL
    ta = ta_in * PERMIL
    pt = pt_in * PERMIL
    sit = sit_in * PERMIL
    co2 = co2ppm * 1.0e-6
    pres = depth_m * 0.1
    k = _equilibrium_constants(t, s, pres)

    # safeguarded Newton (drtsafe, co2calc.F:407-470): bisect when the
    # Newton step leaves the bracket; n_iter trips, no early exit
    lo = torch.full_like(t, 10.0 ** (-ph_hi))
    hi = torch.full_like(t, 10.0 ** (-ph_lo))
    h = torch.sqrt(lo * hi)
    for _ in range(n_iter):
        f = _ta_residual(h, k, dic, ta, pt, sit)
        eps = 1e-8 * h
        df = (_ta_residual(h + eps, k, dic, ta, pt, sit) - f) / eps
        pos = f > 0                        # residual decreasing in h
        lo = torch.where(pos, h, lo)
        hi = torch.where(pos, hi, h)
        h_newton = h - f / df
        bad = (h_newton <= lo) | (h_newton >= hi) \
            | ~torch.isfinite(h_newton)
        h = torch.where(bad, torch.sqrt(lo * hi), h_newton)

    h2 = h * h
    k12 = k["k1"] * k["k2"]
    co2star = dic * h2 / (h2 + k["k1"] * h + k12)
    co2starair = co2 * k["ff"] * atmpres
    dco2star = co2starair - co2star
    ph = -torch.log10(h)
    pco2 = co2star / k["ff"] / 1.0e-6
    co3 = k12 * co2star / h2          # mol/kg

    # calcite/aragonite solubility (Mucci 1983, co2calc.F:360-368)
    tk = C2K + t
    sqrts = torch.sqrt(s)
    s15 = s ** 1.5
    logtk = torch.log(tk)
    kspc = torch.exp(-395.8293 + 6537.773 / tk + 71.595 * logtk
                     - 0.17959 * tk
                     + (-1.78938 + 410.64 / tk + 0.0065453 * tk) * sqrts
                     - 0.17755 * s + 0.0094979 * s15)
    kspa = torch.exp(-395.9180 + 6685.079 / tk + 71.595 * logtk
                     - 0.17959 * tk
                     + (-0.157481 + 202.938 / tk + 0.0039780 * tk) * sqrts
                     - 0.23067 * s + 0.0136808 * s15)
    # Millero (1983) pressure dependence (co2calc.F:374-388)
    pitkr = pres / tk / 83.15
    p2itkr = pres * pitkr
    srat = torch.sqrt(s / 35.0)
    t2 = t * t
    dvc = -65.28 + 0.397 * t - 0.005155 * t2 \
        + (19.816 - 0.0441 * t - 0.00017 * t2) * srat
    dva = -65.50 + 0.397 * t - 0.005155 * t2 \
        + (19.82 - 0.0441 * t - 0.00017 * t2) * srat
    dk = 0.01847 + 0.0001956 * t - 0.000002212 * t2 \
        + (-0.03217 - 0.0000711 * t + 0.000002212) * srat
    kspc = kspc * torch.exp(-dvc * pitkr + 0.5 * dk * p2itkr)
    kspa = kspa * torch.exp(-dva * pitkr + 0.5 * dk * p2itkr)
    ca = 10.28e-3
    omega_c = ca * co3 / kspc
    omega_a = ca * co3 / kspa
    return dict(co2star=co2star / PERMIL, dco2star=dco2star / PERMIL,
                pco2=pco2, ph=ph, co3=co3 / PERMIL,
                omega_c=omega_c, omega_a=omega_a)


def o2_saturation(t, s):
    """O2 saturation [mol/m^3] (Garcia & Gordon 1992; gasbc.F:404-411)."""
    f1 = torch.log((298.15 - t) / (C2K + t))
    f2 = f1 * f1
    f3 = f2 * f1
    f4 = f3 * f1
    f5 = f4 * f1
    o2sat = torch.exp(2.00907 + 3.22014 * f1 + 4.05010 * f2
                      + 4.94457 * f3 - 2.56847e-1 * f4 + 3.88767 * f5
                      + s * (-6.24523e-3 - 7.37614e-3 * f1
                             - 1.03410e-2 * f2 - 8.17083e-3 * f3)
                      - 4.88682e-7 * s * s)
    return o2sat / 22391.6 * 1000.0


def schmidt_co2(t):
    return 2073.1 - 125.62 * t + 3.6276 * t ** 2 - 0.043219 * t ** 3


def schmidt_o2(t):
    return 1638.0 - 81.83 * t + 1.483 * t ** 2 - 0.008004 * t ** 3


def schmidt_cfc11(t):
    """CFC-11 Schmidt number, Zheng et al. 1998 (gasbc.F:428)."""
    return 3501.8 + t * (-210.31 + t * (6.1851 + t * (-0.07513)))


def schmidt_cfc12(t):
    """CFC-12 Schmidt number (gasbc.F:456)."""
    return 3845.4 + t * (-228.95 + t * (6.1908 + t * (-0.067430)))


def cfc_solubility(t, s, which: int):
    """Warner & Weiss (1985) CFC solubility in mol/(l atm)
    (gasbc.F:432-436, 460-464).  t in deg C, s in psu."""
    f1 = (t + 273.16) * 0.01
    if which == 11:
        d = (0.091459 - 0.0157274 * f1) * f1 - 0.142382
        return torch.exp(-229.9261 + 319.6552 / f1
                         + 119.4471 * torch.log(f1)
                         - 1.39165 * f1 * f1 + s * d)
    d = (0.091015 - 0.0153924 * f1) * f1 - 0.143566
    return torch.exp(-218.0971 + 298.9702 / f1 + 113.8049 * torch.log(f1)
                     - 1.39165 * f1 * f1 + s * d)


def cfc_saturation(t, s, ccn_pptv, which: int):
    """Surface saturation concentration in mol/m^3 for an atmospheric
    dry mole fraction in pptv (gasbc.F:439-440)."""
    return 1.0e-12 * 1000.0 * cfc_solubility(t, s, which) * ccn_pptv


def hemispheric_blend(tlat_deg, north, south):
    """Hemispheric atmospheric values blended linearly across +-10 deg
    latitude (gasbc.F:419-426)."""
    wt = torch.clamp((tlat_deg + 10.0) / 20.0, 0.0, 1.0)
    return north * wt + south * (1.0 - wt)


def piston_velocity(wspd_cms, schmidt, open_water):
    """Wanninkhof (1992) piston velocity [cm/s] (gasbc.F:360-363)."""
    return open_water * XCONV * (wspd_cms * 0.01) ** 2 \
        * (schmidt / 660.0) ** -0.5


def surface_gas_fluxes(sst, sss, wspd, open_water, surf_tracers, idx,
                       co2ccn=280.0, alk_default=None, cfc_atm=None,
                       dc14ccn=0.0):
    """Gas-exchange surface fluxes of dic, o2, c14, cfc11 and cfc12
    (gasbc.F:330-467; c14: updates/10 gasbc.F:652-654); dic13 gets none,
    as in the reference.

    cfc_atm : None or (cfc11ccn, cfc12ccn), 2-D fields in pptv, already
    blended across the hemispheres (``hemispheric_blend``).
    dc14ccn : atmospheric Delta-14C [permil] (c14data.F): the c14 flux
    follows the CO2 exchange with the atmospheric and oceanic 14C ratios.
    co2ccn and dc14ccn may be numbers or 0-d tensors.

    surf_tracers: (nt, jmt, imt) surface tracer fields.  Returns the
    (nt, jmt, imt) fluxes [tracer units cm/s], positive into the ocean,
    and the carbonate diagnostics.
    """
    sst_c = torch.clamp(sst, -2.0, 35.0)
    sss_c = torch.clamp(sss, 0.0, 45.0)
    rows = {}
    diags = {}
    if "dic" in idx:
        dic = surf_tracers[idx.idic]
        if "alk" in idx:
            ta = surf_tracers[idx.ialk]
        else:
            ta = 2.36775 * sss_c / 35.0 if alk_default is None \
                else alk_default
        carb = co2calc_sws(sst_c, sss_c, dic, ta, co2ccn)
        pv = piston_velocity(wspd, schmidt_co2(sst_c), open_water)
        rows[idx.idic] = pv * carb["dco2star"]
        diags.update(pco2=carb["pco2"], ph=carb["ph"], co3=carb["co3"])
        if "c14" in idx:
            # in the normalized c14 units (true c14 / rc14std)
            c14 = surf_tracers[idx["c14"]]
            rc_ocn = c14 / torch.clamp(dic, min=1e-12)
            rows[idx["c14"]] = pv * (
                (carb["dco2star"] + carb["co2star"])
                * (1.0 + dc14ccn * 1.0e-3)
                - carb["co2star"] * rc_ocn)
    if "o2" in idx:
        o2 = surf_tracers[idx.io2]
        pv = piston_velocity(wspd, schmidt_o2(sst_c), open_water)
        o2sat = o2_saturation(sst_c, sss_c)  # mol/m^3 == umol/cm^3
        rows[idx.io2] = pv * (o2sat - o2)
    if cfc_atm is not None and "cfc11" in idx:
        for which, name, sc_fn, ccn in (
                (11, "cfc11", schmidt_cfc11, cfc_atm[0]),
                (12, "cfc12", schmidt_cfc12, cfc_atm[1])):
            k = idx[name]
            pv = piston_velocity(wspd, sc_fn(sst_c), open_water)
            sat = cfc_saturation(sst_c, sss_c, ccn, which)
            rows[k] = pv * (sat - surf_tracers[k])
    zero = torch.zeros_like(surf_tracers[0])
    flux = torch.stack([rows.get(n, zero)
                        for n in range(surf_tracers.shape[0])])
    return flux, diags
