"""Elastic-viscous-plastic sea-ice dynamics (Hunke & Dukowicz 1997), in
PyTorch.

Port of ``uvic_tpu.models.ice.evp`` (source/ice/evp.F): the
four-triangle (N/E/S/W) stress discretization on the B-grid, with the
ndte elastic subcycles as a host loop carrying (uice, vice, 12 stress
components), full-grid masked arithmetic.

Constants follow setembm.F:995-1013 and evp.F.
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import EPSLN
from ...ops.stencil import E, N, S, W, setbcx
from ..embm import constants as C

ECCICE = 2.0
ECC2 = 1.0 / ECCICE ** 2
ECC2M = 2.0 * (1.0 - ECC2)
ECC2P = 1.0 + ECC2
ZETAMIN = 4.0e11
EYC = 0.25
FLOOR = 1.0e-11
PSTAR = 2.75e5
COSTH = 0.9063
SINTH = 0.4226
DRAGW_RHO = 0.0055 * 1.03


def SW(a):
    return S(W(a))


def evp_xymin(cst, dxt, dyt):
    """Square of the smallest interior T-cell side [cm^2] (evp.F
    xyminevp), from the grid's NumPy arrays."""
    return float(np.min(np.minimum(
        np.asarray(cst)[1:-1, None] * np.asarray(dxt)[None, 1:-1],
        np.asarray(dyt)[1:-1, None])) ** 2)


def _zero_rows(a):
    z = torch.zeros_like(a[:1])
    return torch.cat([z, a[1:-1], z])


def evp_dynamics(uice, vice, hice, aice, tmsk, umsk, fcor,
                 taux, tauy, uocn, vocn, g, dtatm, ndte, cyclic=True,
                 sig_in=None, xyminevp=None):
    """Run one EVP dynamics step (evp.F `evp`).

    Returns (uice, vice, sig_out, xint, yint): the velocities, the
    (4, 3, jmt, imt) triangle stress tensor carried ACROSS steps (the
    reference keeps sig11n..sig12w in evp.h between calls — the elastic
    closure needs the stress memory), and the internal ice stress
    divergence (xint/yint, evp.F:632-633) that sum_flux adds to the
    ocean-surface stress where ice is present (embm.F:188-201).

    uice/vice : (jmt, imt) ice velocity at U points
    hice/aice : T-cell mean thickness / area fraction (time level 2)
    tmsk/umsk : ocean masks at T/U points
    fcor      : Coriolis parameter at U points
    taux/tauy : wind stress on ice at U points [g/cm/s^2]
    uocn/vocn : surface geostrophic ocean currents at U points [cm/s]
    sig_in    : optional (4, 3, jmt, imt) stress state from the last step
    xyminevp  : ``evp_xymin`` of the grid (computed from ``g`` if None)
    """
    dte = dtatm / float(ndte)
    dtei = 1.0 / dte
    if xyminevp is None:
        xyminevp = evp_xymin(g.cst.cpu(), g.dxt.cpu(), g.dyt.cpu())

    dyt2r = g.dyt2r[:, None]
    dytr = g.dytr[:, None]
    dxt2r = g.dxt2r[None, :]
    dxtr = g.dxtr[None, :]
    dxur = g.dxur[None, :]
    dyur = g.dyur[:, None]
    cstr = g.cstr[:, None]
    csur = g.csur[:, None]
    csu = g.csu[:, None]
    dxu = g.dxu[None, :]
    dyu = g.dyu[:, None]
    cst = g.cst[:, None]
    dxt = g.dxt[None, :]
    dyt = g.dyt[:, None]

    # ---- mass_prss (evp.F:450-533) -----------------------------------
    tmass = C.RHOICE * hice * tmsk
    umass = 0.25 * (tmass + E(tmass) + N(tmass) + N(E(tmass)))
    pice = setbcx(PSTAR * hice * torch.exp(-20.0 * (1.0 - aice)), cyclic)

    # ---- viscevp (evp.F:51-195): strain rates & viscosities ----------
    def strain_rates(u, v):
        cc = (u + W(u) - S(u) - SW(u)) * dyt2r
        dd = (v + S(v) - W(v) - SW(v)) * cstr * dxt2r
        xi11n = (u - W(u)) * csur * dxur
        xi12n = ((v - W(v)) * csur * dxur + cc) * 0.5
        xi22n = (v + W(v) - S(v) - SW(v)) * dyt2r
        xi11e = (u + S(u) - W(u) - SW(u)) * cstr * dxt2r
        xi12e = ((u - S(u)) * dyur + dd) * 0.5
        xi22e = (v - S(v)) * dyur
        xi11s = (S(u) - SW(u)) * S(csur) * dxur
        xi12s = ((S(v) - SW(v)) * S(csur) * dxur + cc) * 0.5
        xi22s = xi22n
        xi11w = xi11e
        xi12w = ((W(u) - SW(u)) * dyur + dd) * 0.5
        xi22w = (W(v) - SW(v)) * dyur
        return ((xi11n, xi12n, xi22n), (xi11e, xi12e, xi22e),
                (xi11s, xi12s, xi22s), (xi11w, xi12w, xi22w))

    prs = 0.5 * pice
    zetamax = 2.5e8 * pice
    tris = strain_rates(uice, vice)
    zetas_ = []
    etas_ = []
    for (x11, x12, x22) in tris:
        delta = torch.sqrt((x11 ** 2 + x22 ** 2) * ECC2P
                         + 4.0 * x12 ** 2 * ECC2 + x11 * x22 * ECC2M)
        delta = torch.clamp(delta, min=1.0e-20)
        z = torch.minimum(torch.clamp(prs / delta, min=ZETAMIN),
                          torch.clamp(zetamax, min=ZETAMIN))
        z = z * tmsk
        zetas_.append(z)
        etas_.append(z * ECC2)

    # ---- stressprep (evp.F:198-349) ----------------------------------
    econst = 2.0 * EYC * C.RHOICE * xyminevp * dtei ** 2
    ey = torch.clamp(econst * hice, min=FLOOR)
    e2 = 0.5 * ey
    edy = e2 * dytr
    edx = e2 * cstr * dxtr
    eHN = e2 / (csu * dxu)
    eHE = e2 / dyu
    eHNm = e2 / (S(csu * torch.ones_like(pice)) * dxu)
    eHEm = e2 / dyu

    h2 = []
    b2 = []
    a2a = []
    prss = []
    for z, eta in zip(zetas_, etas_):
        en = e2 / (eta + EPSLN)
        zn = e2 / (z + EPSLN)
        c2 = dtei + en
        c3 = 0.5 * (en - zn)
        d2 = c2 - c3
        h2_ = 1.0 / c2
        a2 = h2_ / (d2 - c3 + EPSLN)
        h2.append(h2_)
        b2.append(a2 * d2)
        a2a.append(a2 * c3)
        prss.append(prs * zn)

    HTN4 = 0.25 / (csu * dxu)
    HTE4 = 0.25 / dyu
    dxt8 = 0.125 / (cst * dxt)
    dyt8 = 0.125 / dyt

    fmass = fcor * umass
    sinth_s = torch.sign(fmass) * SINTH
    waterx = umsk * (uocn * COSTH - vocn * sinth_s)
    watery = umsk * (vocn * COSTH + uocn * sinth_s)
    strairx = umsk * (taux - fmass * vocn)
    strairy = umsk * (tauy + fmass * uocn)

    active_t = (tmsk > FLOOR).to(uice.dtype)
    active_u = ((umsk > FLOOR) & (umass > 0.01)).to(uice.dtype)
    umassdtei = umass * dtei

    # ---- subcycles: stressevp + stepu (evp.F:36-41,303-447,537-653) --
    def subcycle(u, v, sig):
        du = dict(n=u - W(u), s=S(u) - SW(u), e=u - S(u), w=W(u) - SW(u))
        dv = dict(n=v - W(v), s=S(v) - SW(v), e=v - S(v), w=W(v) - SW(v))
        cc = 0.5 * edy * (du["e"] + du["w"])
        dd = 0.5 * edx * (dv["n"] + dv["s"])
        xi = dict(
            n=(2.0 * du["n"] * eHN, dv["n"] * eHN + cc,
               edy * (dv["e"] + dv["w"])),
            e=(edx * (du["n"] + du["s"]), du["e"] * eHE + dd,
               2.0 * dv["e"] * eHE),
            s=(2.0 * du["s"] * eHNm, dv["s"] * eHNm + cc,
               edy * (dv["e"] + dv["w"])),
            w=(edx * (du["n"] + du["s"]), du["w"] * eHEm + dd,
               2.0 * dv["w"] * eHEm),
        )
        new_sig = {}
        for idx, tri in enumerate(("n", "e", "s", "w")):
            x11, x12, x22 = xi[tri]
            s11, s12, s22 = sig[tri]
            c4 = dtei * s11 + x11 - prss[idx]
            c5 = dtei * s22 + x22 - prss[idx]
            s11n = (a2a[idx] * c5 + c4 * b2[idx]) * active_t
            s22n = (a2a[idx] * c4 + c5 * b2[idx]) * active_t
            s12n = h2[idx] * (x12 + dtei * s12) * active_t
            new_sig[tri] = (s11n, s12n, s22n)
        sig = new_sig

        # stepu helper fields
        s11ew = dxt8 * (sig["e"][0] + sig["w"][0])
        s22ns = dyt8 * (sig["n"][2] + sig["s"][2])
        s12ns = dyt8 * (sig["n"][1] + sig["s"][1])
        s12ew = dxt8 * (sig["e"][1] + sig["w"][1])
        s22ew = HTE4 * (sig["e"][2] + E(sig["w"][2]))
        s12ewi = HTE4 * (sig["e"][1] + E(sig["w"][1]))
        s11ns = HTN4 * (N(sig["s"][0]) + sig["n"][0])
        s12nsj = HTN4 * (N(sig["s"][1]) + sig["n"][1])

        s11 = (-s11ns + E(s11ns) + N(E(s11ew)) + E(s11ew)
               - N(s11ew) - s11ew)
        s12 = (-s12ewi + N(s12ewi) + N(E(s12ns)) + N(s12ns)
               - E(s12ns) - s12ns)
        s21 = (-s12nsj + E(s12nsj) + N(E(s12ew)) + E(s12ew)
               - N(s12ew) - s12ew)
        s22 = (-s22ew + N(s22ew) + N(E(s22ns)) + N(s22ns)
               - E(s22ns) - s22ns)
        xint = s11 + s12
        yint = s21 + s22

        uorel = uocn - u
        vorel = vocn - v
        vrel = DRAGW_RHO * torch.sqrt(uorel ** 2 + vorel ** 2)
        cca = umassdtei + vrel * COSTH
        ccb = fmass + vrel * sinth_s
        ab2 = cca ** 2 + ccb ** 2 + EPSLN
        c1 = xint + strairx + vrel * waterx + umassdtei * u
        c2 = yint + strairy + vrel * watery + umassdtei * v
        u_new = (cca * c1 + ccb * c2) / ab2 * active_u
        v_new = (cca * c2 - ccb * c1) / ab2 * active_u
        u_new = _zero_rows(setbcx(u_new, cyclic))
        v_new = _zero_rows(setbcx(v_new, cyclic))
        return u_new, v_new, sig, xint, yint

    z = torch.zeros_like(uice)
    if sig_in is None:
        sig = {t: (z, z, z) for t in ("n", "e", "s", "w")}
    else:
        sig = {t: (sig_in[i, 0], sig_in[i, 1], sig_in[i, 2])
               for i, t in enumerate(("n", "e", "s", "w"))}
    u, v, xint, yint = uice, vice, z, z
    for _ in range(ndte):
        u, v, sig, xint, yint = subcycle(u, v, sig)
    sig_out = torch.stack([torch.stack(sig[t])
                           for t in ("n", "e", "s", "w")])
    return u, v, sig_out, xint * active_u, yint * active_u
