"""MOBI 2.x: Model of Ocean Biogeochemistry and Isotopes, in PyTorch.

Port of ``uvic_tpu.models.bgc.mobi`` (updates/10/source/mom/mobi.F:
mobi_init, mobi_driver, mobi_src, plus the Pa/Th reversible-scavenging
module protac_thor.F).  The process set, the units and the documented
divergences from mobi.F are the reference's; see its module docstring.

The column driver is a Python loop down the levels carrying the light
attenuation and the sinking-export chain for every (j,i) column at
once: it must stay sequential (the export of level k is the import of
level k+1).  The ``nbio`` ecosystem substeps of one level are an inner
Python loop over whole-slab pools.  The pools' positivity flags, the
first clamp and the final increments are kept as one stacked
(pool, jmt, imt) tensor each, which computes the same numbers as the
reference's per-pool dictionaries with fewer launches on the card.
Nothing here reads a value back to the host, so a step that calls
``sources`` can be captured in a CUDA graph.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ...constants import DAYLEN
from .gasx import co2calc_sws
from .npzd import TRCMIN, calcite_profiles, phi, solar_geometry

RC13STD = 0.0112372       # PDB (mobi.h rc13std)
RN15STD = 0.0036765       # atmospheric N2 (mobi.h rn15std)
C14_LAMBDA = 3.836e-12    # DIC-14 decay [1/s] (tracer.F:639)

YRLEN = 365.0 * 86400.0
# protac_thor.F:43-56 (production in dpm/m^3/yr, decay in 1/yr)
BETA_PA = 2.33e-3 / YRLEN
BETA_TH = 2.52e-2 / YRLEN
LAMBDA_PA = 2.13e-5 / YRLEN
LAMBDA_TH = 9.22e-6 / YRLEN
RHOSW = 1024.5
MW_C = 12.01e-3           # kg/mol (protac_thor.h:22)
MW_CACO3 = 100.1e-3
MW_OPAL = 67.3e-3
ORG_TO_C_MASS = 2.199     # Klaas & Archer 2002 (protac_thor.F:90)
# partition-coefficient factors (protac_thor.F:74-85)
PATH_SPM_EXP = 0.66
KPA_FAC = dict(pom=1.0, caco3=1.0 / 40.0, opal=1.0 / 6.0)
KTH_FAC = dict(pom=1.0, caco3=1.0, opal=1.0 / 20.0)


@dataclass
class MobiParams:
    """mobi_init namelist defaults (mobi.F:59-196), input units
    (per-day rates, m lengths) — converted in ``Mobi.__init__``."""
    alpha: float = 0.16
    kw: float = 0.04
    kc: float = 0.047
    ki: float = 5.0
    abio_P: float = 0.6
    bbio: float = 1.066
    cbio: float = 1.0
    nup: float = 0.03          # linear phyt mortality [1/day]
    nup_D: float = 0.0001      # quadratic diaz mortality
    nupt0: float = 0.015
    nupt0_D: float = 0.001
    gamma1: float = 0.70
    gbio: float = 0.38
    nuz: float = 0.06
    nud0: float = 0.07
    nudon0: float = 2.33e-5
    nudop0: float = 7.0e-5
    wd0: float = 16.0          # m/day
    mwz: float = 100000.0      # cm
    mw: float = 0.02           # 1/day
    mw_c: float = 0.06
    par: float = 0.43
    redctn: float = 7.1        # (mmol->mol conversion applied later)
    redptn: float = 1.0 / 16.0
    redotn: float = 10.6
    caprmax: float = 0.022
    kcapr: float = 0.4
    dcaco3: float = 650000.0   # cm
    jdiar: float = 0.08
    dbct_D: float = 2.6
    kzoo: float = 0.15
    geZ: float = 0.6
    diazntp: float = 28.0
    dfr: float = 0.08
    dfrt: float = 0.01
    hdop: float = 0.4
    k1n: float = 0.7
    knmin: float = 0.15
    knmax: float = 1.5
    pmax: float = 0.15
    zprefP: float = 0.18
    zprefDiat: float = 0.18
    zprefDiaz: float = 0.1
    zprefZ: float = 0.18
    zprefDet: float = 0.18
    # silicon (mobi.F:103-121)
    abiodiat: float = 3.45
    nu_diat: float = 0.03
    nudt0: float = 0.015
    wo0: float = 50.0          # m/day
    opl_disk0: float = 8.3e-3  # 1/day
    sipr0: float = 0.13
    knmin_Diat: float = 0.3
    knmax_Diat: float = 3.0
    pmax_Diat: float = 0.15
    kfemin_Diat: float = 0.04e-3
    kfemax_Diat: float = 0.8e-3
    # caco3
    kc_c: float = 0.047
    wc0: float = 35.0          # m/day
    dissk0: float = 0.013      # 1/day
    # iron (mobi.F:167-196)
    kfemin: float = 0.04e-3
    kfemax: float = 0.2e-3
    kfe_D: float = 0.1e-3
    kfeleq: float = 10.0 ** 5.5
    lig: float = 1.0e-3
    thetamaxhi: float = 0.04
    thetamaxlo: float = 0.01
    alphamax: float = 73.6e-6 * 86400.0
    alphamin: float = 18.4e-6 * 86400.0
    mc: float = 12.011
    fetopsed: float = 0.004
    o2min: float = 5.0         # uM
    kfeorg: float = 0.45 / 86400.0
    rfeton: float = 10.0e-6 * 6.625
    kfecol: float = 0.005 / 86400.0
    # nitrogen-15 epsilons (mobi.F:160-166)
    eps_assim: float = 6.0
    eps_excr: float = 4.0
    eps_nfix: float = 1.0
    eps_wcdeni: float = 25.0
    eps_bdeni0: float = 6.0
    eps_recy: float = 1.0
    # benthic denitrification factor
    sgbdfac: float = 1.0


def _flag(x):
    """0.5 + sign(0.5, x): 1 where x >= 0 else 0 (Fortran sign)."""
    return (x >= 0.0).to(x.dtype)


def _pos(x):
    return torch.clamp(x, min=0.0)


def _ratio(x, y, rstd):
    """Isotope ratio x / y with the reference's floors and clamp."""
    r = torch.clamp(x, min=TRCMIN * rstd / (1 + rstd)) \
        / torch.clamp(y, min=TRCMIN)
    return torch.clamp(r, 0.5 * rstd / (1 + rstd), 2.0 * rstd / (1 + rstd))


class Mobi:
    """Full MOBI kinetics; drop-in for Npzd (same sources() contract).

    Option flags are inferred from tracer presence in the registry, so
    the active process set mirrors the reference CPP options.
    """

    def __init__(self, params, grid, idx, c2dtts: float,
                 dtype=torch.float64, device="cpu"):
        # `params` is the model's NpzdParams; only the substep length is
        # taken from it — rates use MOBI defaults.
        self.idx = idx
        self.p = p = MobiParams()
        self.nitrogen = "no3" in idx
        self.o2 = "o2" in idx
        self.carbon = "dic" in idx
        self.alk = "alk" in idx
        self.silicon = "diat" in idx
        self.iron = "dfe" in idx
        self.caco3 = "caco3" in idx
        self.c13 = "dic13" in idx
        self.n15 = "din15" in idx
        self.c14 = "c14" in idx
        self.pa_th = "pa231" in idx

        # --- unit conversions (mobi.F:204-266) ------------------------
        self.redctn = p.redctn * 1.0e-3      # mol C / mmol N
        self.redotn = p.redotn * 1.0e-3
        self.redptn = p.redptn
        self.redotp = self.redotn / p.redptn
        self.redctp = self.redctn / p.redptn
        self.redotc = self.redotn / self.redctn
        self.redntp = 1.0 / p.redptn
        self.redntc = 1.0 / self.redctn      # mmol N / mol C
        self.diazptn = 1.0 / p.diazntp
        self.kw = p.kw * 1.0e-2              # 1/cm
        self.kc = p.kc * 1.0e-2
        self.kc_c = p.kc_c * 1.0e-2
        self.ki = p.ki * 1.0e-2
        self.abio_P = p.abio_P / DAYLEN
        self.abiodiat = p.abiodiat / DAYLEN
        self.nup = p.nup / DAYLEN
        self.nup_D = p.nup_D / DAYLEN
        self.nupt0 = p.nupt0 / DAYLEN
        self.nupt0_D = p.nupt0_D / DAYLEN
        self.gbio = p.gbio / DAYLEN
        self.nuz = p.nuz / DAYLEN
        self.nud0 = p.nud0 / DAYLEN
        self.nudon0 = p.nudon0 / DAYLEN
        self.nudop0 = p.nudop0 / DAYLEN
        self.nu_diat = p.nu_diat / DAYLEN
        self.nudt0 = p.nudt0 / DAYLEN
        self.dissk0 = p.dissk0 / DAYLEN
        self.opl_disk0 = p.opl_disk0 / DAYLEN
        self.alpha = p.alpha / DAYLEN
        self.alphamax = p.alphamax / DAYLEN
        self.alphamin = p.alphamin / DAYLEN
        # with iron the P-I slope is computed from chlorophyll
        # (mobi.F:264); otherwise folded into tap (mobi.F:266)
        self.tap = 2.0 * p.par if self.iron \
            else 2.0 * self.alpha * p.par

        # grazing preference normalization over the ACTIVE prey set
        prefs = dict(P=p.zprefP, Det=p.zprefDet, Z=p.zprefZ)
        if self.nitrogen:
            prefs["Diaz"] = p.zprefDiaz
        if self.silicon:
            prefs["Diat"] = p.zprefDiat
        tot = sum(prefs.values())
        self.zpref = {k: v / tot for k, v in prefs.items()}

        zt = np.asarray(grid.zt)     # cm
        zw = np.asarray(grid.zw)
        dzt = np.asarray(grid.dzt)
        wd0, wc0, wo0 = p.wd0 * 1e2, p.wc0 * 1e2, p.wo0 * 1e2  # cm/day
        zcap = np.minimum(zt, p.mwz)
        wd = (wd0 + p.mw * zcap) / DAYLEN / dzt
        wc = (wc0 + p.mw_c * zcap) / DAYLEN / dzt
        wo = wo0 / DAYLEN / dzt + 0 * zt
        # ztt(1)=0, ztt(k+1)=-zw(k) (mobi.F:288-291)
        ztt = np.concatenate([[0.0], -zw[:-1]])

        def tn(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=device)[:, None, None]

        def floats(x):
            return [float(v) for v in x]

        # per-level constants: Python floats for the level loop, (km,1,1)
        # tensors for the whole-column passes
        self.wd, self.wc, self.wo = floats(wd), floats(wc), floats(wo)
        self.ztt, self.dzt = floats(ztt), floats(dzt)
        self.dztr, self.zt_m = floats(1.0 / dzt), floats(zt * 1e-2)
        self.zt_m3 = tn(zt * 1e-2)
        self.dzt3 = tn(dzt)
        self.dzm_r3 = tn(1.0 / (dzt * 1e-2))
        # sinking speeds in m/s (protac_thor.F:197-199)
        self.w_pom3 = tn(wd * 1e-2 * dzt)
        self.w_ca3 = tn(wc * 1e-2 * dzt)
        self.w_op3 = tn(wo * 1e-2 * dzt)
        # calcite remin profiles for the non-prognostic-caco3 path
        rcak, rcab = calcite_profiles(zw, dzt, p.dcaco3)
        self.rcak3, self.rcab3 = tn(rcak), tn(rcab)

        self.nbio = max(1, int(round(c2dtts / params.dtnpzd)))
        self.dtbio = c2dtts / self.nbio
        self.rdtts = 1.0 / c2dtts
        self.rnbio = 1.0 / self.nbio
        self.c2dtts = c2dtts

        # names stepped inside mobi_src, in a stable order
        names = ["po4", "phyt", "phyt_phos", "zoop", "detr",
                 "detr_phos"]
        if self.carbon:
            names.append("dic")
        if self.nitrogen:
            names += ["dop", "no3", "don", "diaz"]
        if self.n15:
            names += ["din15", "don15", "phytn15", "zoopn15",
                      "detrn15", "diazn15"]
            if self.silicon:
                names.append("diatn15")
        if self.c13:
            names += ["dic13", "phytc13", "zoopc13", "detrc13"]
            if self.nitrogen:
                names += ["doc13", "diazc13"]
            if self.silicon:
                names.append("diatc13")
            if self.caco3:
                names.append("caco3c13")
        if self.caco3:
            names.append("caco3")
        if self.silicon:
            names += ["diat", "sil", "opl"]
        if self.iron:
            names += ["dfe", "detrfe"]
        self.bio_names = names
        self.bio_idx = torch.tensor([idx[n] for n in names],
                                    dtype=torch.int64, device=device)

    # ==================================================================
    # mobi_src (mobi.F:1497-3323): nbio substeps on one level's slabs
    # ==================================================================
    def _mobi_src(self, bstack, gl, bct, bctz, nud, o2um, dissk1, capr,
                  ac13b, wwd, wwc, wwo, dzt_k, dayfrac, imp, dtbio):
        """bstack: (pool, jmt, imt) pools in ``bio_names`` order; imp:
        dict of import fluxes.  Returns (final-minus-initial pools as one
        stacked tensor, accumulated outputs dict)."""
        p = self.p
        nit, sil_on, fe_on = self.nitrogen, self.silicon, self.iron
        ca_on, c13_on, n15_on = self.caco3, self.c13, self.n15
        names = self.bio_names

        # initial latched flags (mobi.F:1845-1920) and the pools clamped
        # positive (mobi.F:1925-2000)
        flags = _flag(bstack - TRCMIN)
        b = dict(zip(names, torch.clamp(bstack, min=TRCMIN).unbind(0)))

        ptn_P0 = b["phyt_phos"] / b["phyt"]
        ptn_d0 = b["detr_phos"] / b["detr"]
        sf_P_phosflag = _flag(ptn_P0 - p.gamma1 * p.redptn)
        sf_d_phosflag = _flag(ptn_d0 - p.gamma1 * p.redptn)

        # --- light / growth ceilings (computed once, mobi.F:2005-2105)
        kirr = -self.kw - self.kc * (b["phyt"]
                                     + (b["diaz"] if nit else 0.0)
                                     + (b["diat"] if sil_on else 0.0))
        if ca_on:
            kirr = kirr - self.kc_c * b["caco3"]
        f1 = torch.exp(kirr * dzt_k)
        rkdz = 1.0 / (-kirr * dzt_k)

        def avej_of(gl_eff, jmx):
            gd = torch.clamp(jmx * dayfrac, min=1.0e-14)
            u1 = torch.clamp(gl_eff / gd, min=1.0e-6)
            u2 = u1 * f1
            return gd * (phi(u1) - phi(u2)) * rkdz

        if fe_on:
            dfe = b["dfe"]
            p1 = torch.clamp(b["phyt"], max=p.pmax)
            p2 = _pos(b["phyt"] - p.pmax)
            kfevar = (p.kfemin * p1 + p.kfemax * p2) / (p1 + p2)
            deffe = dfe / (kfevar + dfe)
            thetamax = p.thetamaxlo \
                + (p.thetamaxhi - p.thetamaxlo) * deffe
            alpha_O = self.alphamin \
                + (self.alphamax - self.alphamin) * deffe
            avej = avej_of(gl * thetamax * alpha_O,
                           self.abio_P * bct * deffe)
            if nit:
                deffe_D = dfe / (p.kfe_D + dfe)
                th_D = p.thetamaxlo \
                    + (p.thetamaxhi - p.thetamaxlo) * deffe_D
                al_D = self.alphamin \
                    + (self.alphamax - self.alphamin) * deffe_D
                jmax_D0 = _pos(self.abio_P * (bct - p.dbct_D) * deffe_D) \
                    * p.jdiar
                avej_D = avej_of(gl * th_D * al_D, jmax_D0)
            if sil_on:
                p1d = torch.clamp(b["diat"], max=p.pmax_Diat)
                p2d = _pos(b["diat"] - p.pmax_Diat)
                kfevar_Dt = (p.kfemin_Diat * p1d
                             + p.kfemax_Diat * p2d) / (p1d + p2d)
                deffe_Dt = dfe / (kfevar_Dt + dfe)
                th_Dt = p.thetamaxlo \
                    + (p.thetamaxhi - p.thetamaxlo) * deffe_Dt
                al_Dt = self.alphamin \
                    + (self.alphamax - self.alphamin) * deffe_Dt
                avej_Diat = avej_of(gl * th_Dt * al_Dt,
                                    self.abiodiat * bct * deffe_Dt)
        else:
            avej = avej_of(gl, self.abio_P * bct)
            if nit:
                jmax_D0 = _pos(self.abio_P * (bct - p.dbct_D)) * p.jdiar
                avej_D = avej_of(gl, jmax_D0)
            if sil_on:
                avej_Diat = avej_of(gl, self.abiodiat * bct)

        nupt = self.nupt0 * bct
        nupt_D = self.nupt0_D * bct
        nudt = self.nudt0 * bct
        gmax = self.gbio * bctz
        zp = self.zpref

        keys = ["expo", "expo_phos", "calpro", "nfix"]
        if ca_on:
            keys += ["dissl", "expocaco3"]
        if sil_on:
            keys.append("expoopl")
        if fe_on:
            keys.append("expofe")
        if n15_on:
            keys.append("rn15expo")
        if c13_on:
            keys.append("rc13expo")
            if ca_on:
                keys.append("rcaco3c13expo")
        zero = torch.zeros_like(gl)
        acc = {k: zero for k in keys}

        for _ in range(self.nbio):
            fl = dict(zip(names, flags.unbind(0)))
            phyt, zoop, detr, po4 = (b["phyt"], b["zoop"], b["detr"],
                                     b["po4"])
            ptn_P = b["phyt_phos"] / torch.clamp(phyt, min=TRCMIN)
            ptn_d = b["detr_phos"] / torch.clamp(detr, min=TRCMIN)

            p1 = torch.clamp(phyt, max=p.pmax)
            p2 = _pos(phyt - p.pmax)
            k1n_v = (p.knmin * p1 + p.knmax * p2) \
                / torch.clamp(p1 + p2, min=TRCMIN)
            k1p_P = k1n_v * ptn_P
            if fe_on:
                dfe = b["dfe"]
                kfevar = (p.kfemin * p1 + p.kfemax * p2) \
                    / torch.clamp(p1 + p2, min=TRCMIN)
                deffe = dfe / (kfevar + dfe)
                jmax = self.abio_P * bct * deffe
                if sil_on:
                    p1d = torch.clamp(b["diat"], max=p.pmax_Diat)
                    p2d = _pos(b["diat"] - p.pmax_Diat)
                    k1n_Dt = (p.knmin_Diat * p1d + p.knmax_Diat * p2d) \
                        / torch.clamp(p1d + p2d, min=TRCMIN)
                    k1p_Dt = k1n_Dt * p.redptn
                    kfevar_Dt = (p.kfemin_Diat * p1d
                                 + p.kfemax_Diat * p2d) \
                        / torch.clamp(p1d + p2d, min=TRCMIN)
                    deffe_Dt = dfe / (kfevar_Dt + dfe)
                    jmax_Diat = self.abiodiat * bct * deffe_Dt
                if nit:
                    deffe_D = dfe / (p.kfe_D + dfe)
                    jmax_D = _pos(self.abio_P * (bct - p.dbct_D)
                                  * deffe_D) * p.jdiar
            else:
                jmax = self.abio_P * bct
                if sil_on:
                    k1n_Dt = 0.003
                    k1p_Dt = k1n_Dt * p.redptn
                    jmax_Diat = self.abiodiat * bct
                if nit:
                    jmax_D = _pos(self.abio_P * (bct - p.dbct_D)) * p.jdiar

            # growth limitation (mobi.F:2219-2260)
            if nit:
                dop = b["dop"]
                limP_dop = p.hdop * dop / (k1p_P + dop)
                limP_po4 = po4 / (k1p_P + po4)
                dopupt_flag = _flag(limP_dop - limP_po4)
                limP = limP_dop * dopupt_flag \
                    + limP_po4 * (1.0 - dopupt_flag)
            else:
                limP = po4 / (k1p_P + po4)
                dopupt_flag = 0.0
            u_P = torch.minimum(avej, jmax * limP)
            if sil_on:
                k1si = 5.0e-3                       # mobi.F:2230
                sil = b["sil"]
                limSi = sil / (k1si + sil)
                if nit:
                    lpd = p.hdop * dop / (k1p_Dt + dop)
                    lpp = po4 / (k1p_Dt + po4)
                    dopupt_Dt_flag = _flag(lpd - lpp)
                    limP_Dt = lpd * dopupt_Dt_flag \
                        + lpp * (1.0 - dopupt_Dt_flag)
                else:
                    limP_Dt = po4 / (k1p_Dt + po4)
                    dopupt_Dt_flag = 0.0
                u_Diat = torch.minimum(avej_Diat, jmax_Diat * limSi)
                u_Diat = torch.minimum(u_Diat, jmax_Diat * limP_Dt)
            if nit:
                no3 = b["no3"]
                u_P = torch.minimum(u_P, jmax * no3 / (k1n_v + no3))
                if sil_on:
                    u_Diat = torch.minimum(
                        u_Diat, jmax_Diat * no3 / (k1n_Dt + no3))
                u_D = torch.minimum(avej_D, jmax_D * limP)

            # grazing coefficients (mobi.F:2270-2300)
            thetaZ = zp["P"] * phyt + zp["Det"] * detr \
                + zp["Z"] * zoop + p.kzoo
            if nit:
                thetaZ = thetaZ + zp["Diaz"] * b["diaz"]
            if sil_on:
                thetaZ = thetaZ + zp["Diat"] * b["diat"]
            npp = u_P * phyt
            if sil_on:
                npp_Diat = u_Diat * b["diat"]
            else:
                npp_Diat = 0.0
            if nit:
                diaz = b["diaz"]
                dopupt = npp * dopupt_flag
                dopupt_Diat = (npp_Diat * dopupt_Dt_flag
                               if sil_on else 0.0)
                npp_D = _pos(u_D * diaz)
                graz_D = gmax * zp["Diaz"] / thetaZ * diaz * zoop
                morpt_D = nupt_D * diaz
                morp_D = self.nup_D * diaz * diaz
                no3upt_D = (0.5 + 0.5 * torch.tanh(no3 - 5.0)) * npp_D
                dopupt_D = npp_D * dopupt_flag
            graz = gmax * zp["P"] / thetaZ * phyt * zoop
            graz_Z = gmax * zp["Z"] / thetaZ * zoop * zoop
            graz_Det = gmax * zp["Det"] / thetaZ * detr * zoop
            morp = self.nup * phyt          # linear (mobi.F:2329)
            morpt = nupt * phyt
            if nit:
                recy_don = self.nudon0 * bct * b["don"]
                recy_dop = self.nudop0 * bct * b["dop"]
            morz = self.nuz * zoop * zoop
            remi = nud * bct * detr
            expo = wwd * detr
            expo_phos = wwd * b["detr_phos"]
            if ca_on:
                dissl = b["caco3"] * dissk1
                expocaco3 = wwc * b["caco3"]
            if sil_on:
                graz_Diat = gmax * zp["Diat"] / thetaZ \
                    * b["diat"] * zoop
                morp_Diat = self.nu_diat * b["diat"]
                morpt_Diat = nudt * b["diat"]
                opldis = b["opl"] * self.opl_disk0
                expoopl = wwo * b["opl"]
            else:
                morp_Diat = morpt_Diat = graz_Diat = 0.0
            if fe_on:
                remife = nud * bct * b["detrfe"]
                o2f = _flag(o2um - p.o2min)
                fepa = (1.0 + p.kfeleq * (p.lig - b["dfe"])) * o2f
                feprime = ((-fepa + torch.sqrt(
                    fepa * fepa + 4.0 * p.kfeleq * b["dfe"]))
                    / (2.0 * p.kfeleq)) * o2f
                feorgads = (p.kfeorg * (
                    _pos(detr * fl["detr"] * p.mc * self.redctn) ** 0.58)
                    * feprime) * o2f
                fecol = p.kfecol * feprime * o2f
                expofe = wwd * b["detrfe"]

            # negative-pool outflux gating (mobi.F:2405-2500)
            pf = fl["phyt"] * fl["phyt_phos"]
            if n15_on:
                pf = pf * fl["phytn15"]
            graz = graz * pf * sf_P_phosflag
            zf = fl["zoop"] * (fl["zoopn15"] if n15_on else 1.0)
            graz_Z = graz_Z * zf
            df = fl["detr"] * fl["detr_phos"] \
                * (fl["detrn15"] if n15_on else 1.0)
            graz_Det = graz_Det * df * sf_d_phosflag
            morp = morp * pf
            morpt = morpt * pf
            morz = morz * zf
            remi = remi * df
            expo = expo * fl["detr"] \
                * (fl["detrn15"] if n15_on else 1.0)
            expo_phos = expo_phos * fl["detr_phos"]
            if nit:
                recy_dop = recy_dop * fl["dop"]
                nflag = fl["no3"] * (fl["din15"] if n15_on else 1.0)
                pool_ok = (dopupt_flag * fl["dop"]
                           + (1.0 - dopupt_flag) * fl["po4"])
                npp = npp * nflag * pool_ok
                if sil_on:
                    pool_ok_Dt = (dopupt_Dt_flag * fl["dop"]
                                  + (1.0 - dopupt_Dt_flag) * fl["po4"])
                    npp_Diat = npp_Diat * nflag * pool_ok_Dt
                npp_D = npp_D * pool_ok \
                    * (fl["din15"] if n15_on else 1.0)
                dzf = fl["diaz"] * (fl["diazn15"] if n15_on else 1.0)
                graz_D = graz_D * dzf
                morpt_D = morpt_D * dzf
                morp_D = morp_D * dzf
                no3upt_D = no3upt_D * nflag
                recy_don = recy_don \
                    * fl["don"] * (fl["don15"] if n15_on else 1.0)
            else:
                npp = npp * fl["po4"]
                if sil_on:
                    npp_Diat = npp_Diat * fl["po4"]
            if ca_on:
                dissl = dissl * fl["caco3"]
                expocaco3 = expocaco3 * fl["caco3"]
            if sil_on:
                graz_Diat = graz_Diat * fl["diat"]
                morp_Diat = morp_Diat * fl["diat"]
                morpt_Diat = morpt_Diat * fl["diat"]
            if fe_on:
                remife = remife * fl["detrfe"]
                feorgads = feorgads * fl["dfe"]
                expofe = expofe * fl["detrfe"]
                fecol = fecol * fl["dfe"]

            # digestion / excretion / sloppy feeding (mobi.F:2500-2560)
            dig_P = p.gamma1 * graz
            dig_Z = p.gamma1 * graz_Z
            dig_Det = p.gamma1 * graz_Det
            dig_Diat = p.gamma1 * graz_Diat if sil_on else 0.0
            dig = dig_P + dig_Z + dig_Det + dig_Diat
            excr_P = p.gamma1 * (1 - p.geZ) * graz
            excr_Z = p.gamma1 * (1 - p.geZ) * graz_Z
            excr_Det = p.gamma1 * (1 - p.geZ) * graz_Det
            excr_Diat = (p.gamma1 * (1 - p.geZ) * graz_Diat
                         if sil_on else 0.0)
            excr = excr_P + excr_Z + excr_Det + excr_Diat
            sf_P = (1.0 - p.gamma1) * graz
            sf_Z = (1.0 - p.gamma1) * graz_Z
            sf_Det = (1.0 - p.gamma1) * graz_Det
            sf_Diat = (1.0 - p.gamma1) * graz_Diat if sil_on else 0.0
            sf = sf_P + sf_Z + sf_Det + sf_Diat
            sf_P_phos = graz * ptn_P - dig_P * p.redptn
            sf_Det_phos = graz_Det * ptn_d - dig_Det * p.redptn
            sf_phos = sf_P_phos + sf_Z * p.redptn + sf_Det_phos \
                + sf_Diat * p.redptn
            rr = self.redntp * self.diazptn     # redntp/diazntp
            if nit:
                dig_D = p.gamma1 * graz_D * rr
                dig = dig + dig_D
                excr_D = p.gamma1 * (1 - p.geZ) * graz_D * rr
                excr = excr + excr_D
                nr_excr_D = graz_D * (1.0 - rr)
                sf_D = (1 - p.gamma1) * graz_D * rr
                sf = sf + sf_D
                sf_phos = sf_phos + sf_D * p.redptn
            else:
                nr_excr_D = 0.0
                dig_D = sf_D = 0.0

            # nitrogen-15 beta fractionation (mobi.F:2565-2625)
            if n15_on:
                uno3 = torch.clamp(npp * dtbio / torch.clamp(no3, min=TRCMIN),
                                   TRCMIN, 0.999)
                rno3 = torch.clamp(
                    b["din15"] / torch.clamp(no3 - b["din15"], min=TRCMIN),
                    RN15STD / 2.0, 2.0 * RN15STD)
                bassim = rno3 + p.eps_assim * (1 - uno3) / uno3 \
                    * torch.log1p(-uno3) * rno3 / 1000.0
                fcassim = bassim / (1 + bassim)
                udon = torch.clamp(recy_don * dtbio
                                   / torch.clamp(b["don"], min=TRCMIN),
                                   TRCMIN, 0.999)
                rdon = torch.clamp(
                    b["don15"] / torch.clamp(b["don"] - b["don15"],
                                             min=TRCMIN),
                    RN15STD / 2.0, 2.0 * RN15STD)
                brecy = rdon + p.eps_recy * (1 - udon) / udon \
                    * torch.log1p(-udon) * rdon / 1000.0
                fcrecy = brecy / (1 + brecy)
                rzoop = torch.clamp(
                    b["zoopn15"] / torch.clamp(zoop - b["zoopn15"],
                                               min=TRCMIN),
                    RN15STD / 2.0, 2.0 * RN15STD)
                bexcr = rzoop - p.eps_excr * rzoop / 1000.0
                fcexcr = bexcr / (1 + bexcr)
                bnfix = RN15STD - p.eps_nfix * RN15STD / 1000.0
                fcnfix = bnfix / (1 + bnfix)
                rtphytn15 = _ratio(b["phytn15"], phyt, RN15STD)
                rtzoopn15 = _ratio(b["zoopn15"], zoop, RN15STD)
                rtdetrn15 = _ratio(b["detrn15"], detr, RN15STD)
                rtdiazn15 = _ratio(b["diazn15"], diaz, RN15STD)
                if sil_on:
                    rtdiatn15 = _ratio(b["diatn15"], b["diat"], RN15STD)

            # carbon-13 beta fractionation (mobi.F:2625-2670)
            if c13_on:
                dic = b["dic"]
                rdic13 = torch.clamp(
                    b["dic13"] / torch.clamp(dic - b["dic13"], min=TRCMIN),
                    0.5 * RC13STD, 2.0 * RC13STD)
                bc13npp = ac13b * rdic13
                fcnpp = bc13npp / (1 + bc13npp)
                rtdic13 = _ratio(b["dic13"], dic, RC13STD)
                rtphytc13 = _ratio(b["phytc13"], phyt * self.redctn,
                                   RC13STD)
                rtzoopc13 = _ratio(b["zoopc13"], zoop * self.redctn,
                                   RC13STD)
                rtdetrc13 = _ratio(b["detrc13"], detr * self.redctn,
                                   RC13STD)
                if nit:
                    rtdoc13 = _ratio(b["doc13"], b["don"] * self.redctn,
                                     RC13STD)
                    rtdiazc13 = _ratio(b["diazc13"], diaz * self.redctn,
                                       RC13STD)
                else:
                    rtdoc13 = rtdiazc13 = 0.0
                if sil_on:
                    rtdiatc13 = _ratio(b["diatc13"],
                                       b["diat"] * self.redctn, RC13STD)
                else:
                    rtdiatc13 = 0.0
                if ca_on:
                    rtcaco3c13 = _ratio(b["caco3c13"], b["caco3"], RC13STD)

            # calcite / opal production (mobi.F:2670-2700)
            if ca_on:
                calpro = ((sf_Z + morz) + (sf_P + morp)) * capr \
                    * self.redctn * 1.0e3
            else:
                calpro = (morp + morz
                          + (graz + graz_Z) * (1.0 - p.gamma1)) \
                    * capr * self.redctn * 1.0e3
            if sil_on:
                if fe_on:
                    sipr_v = (-0.46204044117647
                              * torch.tanh(6.9 * b["dfe"] * 1.0e3
                                           - 3.673092)
                              + 1.60266544117647)
                    oplpro = (morp_Diat + sf_Diat) * sipr_v \
                        * fl["sil"] * 1.0e-3
                else:
                    oplpro = (morp_Diat + sf_Diat) * p.sipr0 \
                        * self.redctn * fl["sil"]
                opldis = opldis * fl["opl"]
                expoopl = expoopl * fl["opl"]

            # --- prognostic updates (mobi.F:2700-3100) ----------------
            nb = dict(b)
            ts = dtbio
            if nit:
                gm15ptn = (0.0060 + 0.0069 * po4) * self.redctn * 1e3
                nb["po4"] = po4 + ts * (
                    dopupt * ptn_P - gm15ptn * npp
                    + (1 - p.dfrt) * morpt * ptn_P + remi * ptn_d
                    + self.diazptn * (morpt_D - (npp_D - dopupt_D))
                    + recy_dop
                    + p.redptn * (excr + (1 - p.dfrt) * morpt_Diat
                                  - (npp_Diat - dopupt_Diat)))
                nb["dop"] = b["dop"] + ts * (
                    p.dfr * morp * ptn_P
                    + p.redptn * (p.dfr * morp_Diat
                                  + p.dfrt * morpt_Diat - dopupt_Diat)
                    + p.dfrt * morpt * ptn_P - ptn_P * dopupt
                    - self.diazptn * dopupt_D - recy_dop)
                nb["phyt"] = phyt + ts * (npp - morp - graz - morpt)
                nb["phyt_phos"] = b["phyt_phos"] + ts * (
                    npp * gm15ptn - (morp + graz + morpt) * ptn_P)
                nb["zoop"] = zoop + ts * (dig - morz - graz_Z - excr)
                nb["detr"] = detr + ts * (
                    (1 - p.dfr) * morp + sf + morz - remi - graz_Det
                    - expo + imp["expo"] + morp_D * rr
                    + (1 - p.dfr) * morp_Diat)
                nb["detr_phos"] = b["detr_phos"] + ts * (
                    (1 - p.dfr) * morp * ptn_P + sf_phos
                    + morz * p.redptn - remi * ptn_d
                    - graz_Det * ptn_d - expo_phos + imp["expo_phos"]
                    + morp_D * rr * p.redptn
                    + (1 - p.dfr) * morp_Diat * p.redptn)
                organic_net = (excr + remi + (1 - p.dfrt) * morpt
                               - npp + (1 - p.dfrt) * morpt_Diat
                               - npp_Diat + morpt_D + recy_don
                               + nr_excr_D + morp_D * (1.0 - rr))
                if self.carbon:
                    nb["dic"] = b["dic"] + ts * self.redctn \
                        * (organic_net - npp_D)
                nb["no3"] = no3 + ts * (organic_net - no3upt_D)
                nb["don"] = b["don"] + ts * (
                    p.dfr * morp + p.dfrt * morpt - recy_don
                    + p.dfr * morp_Diat + p.dfrt * morpt_Diat)
                nb["diaz"] = diaz + ts * (npp_D - morp_D - morpt_D
                                          - graz_D)
            else:
                nb["po4"] = po4 + ts * p.redptn * (
                    remi + excr - npp + morpt - npp_Diat + morpt_Diat)
                nb["phyt"] = phyt + ts * (npp - morp - graz - morpt)
                # divergence: Redfield-slaved quotas (ref leaves them)
                nb["phyt_phos"] = b["phyt_phos"] + ts * p.redptn * (
                    npp - morp - graz - morpt)
                nb["zoop"] = zoop + ts * (dig - morz - graz_Z - excr)
                nb["detr"] = detr + ts * (
                    morp + sf + morz - remi - graz_Det - expo
                    + imp["expo"] + morp_Diat)
                nb["detr_phos"] = b["detr_phos"] + ts * p.redptn * (
                    morp + sf + morz - remi - graz_Det + morp_Diat) \
                    + ts * (imp["expo_phos"] - expo_phos)
                if self.carbon:
                    nb["dic"] = b["dic"] + ts * self.redctn * (
                        morpt + excr + remi - npp
                        + morpt_Diat - npp_Diat)
            if ca_on:
                nb["caco3"] = b["caco3"] + ts * (
                    calpro - dissl - expocaco3 + imp["expocaco3"])
            if sil_on:
                nb["diat"] = b["diat"] + ts * (
                    npp_Diat - morp_Diat - graz_Diat - morpt_Diat)
                nb["sil"] = b["sil"] + ts * (opldis - oplpro)
                nb["opl"] = b["opl"] + ts * (
                    oplpro - opldis - expoopl + imp["expoopl"])
            if fe_on:
                rfe = p.rfeton
                if nit:
                    nb["dfe"] = b["dfe"] + ts * (
                        rfe * (excr + (1 - p.dfrt) * morpt - npp
                               + morpt_D - npp_D + recy_don
                               + nr_excr_D + morp_D * (1 - rr)
                               + (1 - p.dfrt) * morpt_Diat - npp_Diat)
                        - feorgads + remife - fecol)
                    nb["detrfe"] = b["detrfe"] + ts * (
                        rfe * (sf + (1 - p.dfr) * morp + morp_D * rr
                               + morz - graz_Det
                               + (1 - p.dfr) * morp_Diat)
                        + feorgads + fecol - remife - expofe
                        + imp["expofe"])
                else:
                    nb["dfe"] = b["dfe"] + ts * (
                        rfe * (excr + morpt - npp
                               + morpt_Diat - npp_Diat)
                        - feorgads + remife - fecol)
                    nb["detrfe"] = b["detrfe"] + ts * (
                        rfe * (sf + morp + morz - graz_Det
                               + morp_Diat)
                        + feorgads + fecol - remife - expofe
                        + imp["expofe"])
            if n15_on:
                nb["din15"] = b["din15"] + ts * (
                    rtphytn15 * (1 - p.dfrt) * morpt
                    + (rtdiatn15 * (1 - p.dfrt) * morpt_Diat
                       - fcassim * npp_Diat if sil_on else 0.0)
                    + fcexcr * excr + rtdiazn15 * morpt_D
                    + rtdiazn15 * nr_excr_D
                    + rtdiazn15 * morp_D * (1 - rr)
                    + rtdetrn15 * remi + fcrecy * recy_don
                    - fcassim * npp - fcassim * no3upt_D)
                nb["don15"] = b["don15"] + ts * (
                    p.dfr * rtphytn15 * morp
                    + (p.dfr * rtdiatn15 * morp_Diat
                       + p.dfrt * rtdiatn15 * morpt_Diat
                       if sil_on else 0.0)
                    + p.dfrt * rtphytn15 * morpt - fcrecy * recy_don)
                nb["phytn15"] = b["phytn15"] + ts * (
                    fcassim * npp
                    - rtphytn15 * (morp + graz + morpt))
                if sil_on:
                    nb["diatn15"] = b["diatn15"] + ts * (
                        fcassim * npp_Diat - rtdiatn15
                        * (morp_Diat + graz_Diat + morpt_Diat))
                nb["zoopn15"] = b["zoopn15"] + ts * (
                    rtphytn15 * dig_P
                    + (rtdiatn15 * dig_Diat if sil_on else 0.0)
                    + rtzoopn15 * dig_Z + rtdetrn15 * dig_Det
                    + rtdiazn15 * dig_D - rtzoopn15 * morz
                    - rtzoopn15 * graz_Z - fcexcr * excr)
                nb["detrn15"] = b["detrn15"] + ts * (
                    rtphytn15 * (1 - p.dfr) * morp
                    + (rtdiatn15 * (1 - p.dfr) * morp_Diat
                       + rtdiatn15 * sf_Diat if sil_on else 0.0)
                    + rtphytn15 * sf_P + rtzoopn15 * sf_Z
                    + rtdetrn15 * sf_Det + rtdiazn15 * sf_D
                    + rtzoopn15 * morz - rtdetrn15 * remi
                    - rtdetrn15 * graz_Det - rtdetrn15 * expo
                    + imp["rn15"] * imp["expo"]
                    + rtdiazn15 * morp_D * rr)
                nb["diazn15"] = b["diazn15"] + ts * (
                    fcnfix * (npp_D - no3upt_D)
                    + fcassim * no3upt_D
                    - rtdiazn15 * (morp_D + graz_D + morpt_D))
            if c13_on:
                rc = self.redctn
                if nit:
                    nb["dic13"] = b["dic13"] + ts * rc * (
                        rtphytc13 * (1 - p.dfrt) * morpt
                        + rtzoopc13 * excr + rtdiazc13 * morpt_D
                        + rtdiazc13 * nr_excr_D
                        + rtdiazc13 * morp_D * (1 - rr)
                        + rtdetrc13 * remi
                        + (rtdiatc13 * (1 - p.dfrt) * morpt_Diat
                           - fcnpp * npp_Diat if sil_on else 0.0)
                        + rtdoc13 * recy_don - fcnpp * npp
                        - fcnpp * npp_D)
                    nb["doc13"] = b["doc13"] + ts * rc * (
                        p.dfr * rtphytc13 * morp
                        + (rtdiatc13 * (p.dfr * morp_Diat
                                        + p.dfrt * morpt_Diat)
                           if sil_on else 0.0)
                        + rtphytc13 * p.dfrt * morpt
                        - rtdoc13 * recy_don)
                    nb["diazc13"] = b["diazc13"] + ts * rc * (
                        fcnpp * npp_D
                        - rtdiazc13 * (morp_D + graz_D + morpt_D))
                else:
                    nb["dic13"] = b["dic13"] + ts * rc * (
                        rtphytc13 * morpt + rtzoopc13 * excr
                        + rtdetrc13 * remi - fcnpp * npp
                        + (rtdiatc13 * morpt_Diat - fcnpp * npp_Diat
                           if sil_on else 0.0))
                nb["phytc13"] = b["phytc13"] + ts * rc * (
                    fcnpp * npp - rtphytc13 * (morp + graz + morpt))
                nb["zoopc13"] = b["zoopc13"] + ts * rc * (
                    rtphytc13 * dig_P
                    + (rtdiatc13 * dig_Diat if sil_on else 0.0)
                    + rtzoopc13 * dig_Z + rtdetrc13 * dig_Det
                    + rtdiazc13 * dig_D
                    - rtzoopc13 * (morz + graz_Z + excr))
                nb["detrc13"] = b["detrc13"] + ts * rc * (
                    rtphytc13 * (1 - p.dfr) * morp
                    + (rtdiatc13 * (1 - p.dfr) * morp_Diat
                       + rtdiatc13 * sf_Diat if sil_on else 0.0)
                    + rtphytc13 * sf_P + rtzoopc13 * sf_Z
                    + rtdetrc13 * sf_Det + rtdiazc13 * sf_D
                    + rtzoopc13 * morz - rtdetrc13 * remi
                    - rtdetrc13 * graz_Det - rtdetrc13 * expo
                    + imp["rc13"]
                    + (rtdiazc13 * morp_D * rr if nit else 0.0))
                if sil_on:
                    nb["diatc13"] = b["diatc13"] + ts * rc * (
                        fcnpp * npp_Diat - rtdiatc13
                        * (morp_Diat + graz_Diat + morpt_Diat))
                if ca_on:
                    nb["caco3c13"] = b["caco3c13"] + ts * (
                        rtdic13 * calpro - rtcaco3c13 * dissl
                        - rtcaco3c13 * expocaco3 + imp["rcaco3c13"])

            # accumulate outputs (mobi.F:3100-3160)
            acc["expo"] = acc["expo"] + expo
            acc["expo_phos"] = acc["expo_phos"] + expo_phos
            acc["calpro"] = acc["calpro"] + calpro
            if nit:
                acc["nfix"] = acc["nfix"] + npp_D - no3upt_D
            if ca_on:
                acc["dissl"] = acc["dissl"] + dissl
                acc["expocaco3"] = acc["expocaco3"] + expocaco3
            if sil_on:
                acc["expoopl"] = acc["expoopl"] + expoopl
            if fe_on:
                acc["expofe"] = acc["expofe"] + expofe
            if n15_on:
                acc["rn15expo"] = acc["rn15expo"] + rtdetrn15
            if c13_on:
                acc["rc13expo"] = acc["rc13expo"] + rtdetrc13 * expo
                if ca_on:
                    acc["rcaco3c13expo"] = acc["rcaco3c13expo"] \
                        + rtcaco3c13 * expocaco3

            # latch flags (mobi.F:3170-3265)
            b = nb
            nbstack = torch.stack([nb[n] for n in names])
            flags = flags * _flag(nbstack - TRCMIN)

        return nbstack - bstack, acc

    # ==================================================================
    # mobi_driver (mobi.F:493-1496): the column model over all (j,i)
    # ==================================================================
    def sources(self, t_tm1, kmt, tmask, swr_in, aice, hice, hsno,
                tlat_rad, relyr, c2dtts=None, co2ccn=280.0):
        """Source terms for all bgc tracers (mobi_driver).

        t_tm1 : (nt, km, jmt, imt) tracers at tau-1
        swr_in: (jmt, imt) downward surface shortwave [erg/cm^2/s]
        relyr : 0-d tensor, fractional year
        c2dtts: a number overriding the instance's interval (the
                substep count stays the instance's)
        returns src: (nt, km, jmt, imt), zeros for the tracers without
        a source here.
        """
        p = self.p
        idx = self.idx
        km = t_tm1.shape[1]
        dt = t_tm1.dtype
        if c2dtts is None:
            dtbio, rdtts, c2dtts = self.dtbio, self.rdtts, self.c2dtts
        else:
            dtbio, rdtts = c2dtts / self.nbio, 1.0 / c2dtts

        # solar geometry (tracer.F:356-402)
        rctheta, dayfrac = solar_geometry(tlat_rad, relyr, self.kw)
        swr0 = self.tap * swr_in * 1e-3 * (
            1.0 + aice * (torch.exp(-self.ki * (hice + hsno)) - 1.0))

        temp = t_tm1[idx.itemp]
        bct = p.bbio ** (p.cbio * temp)
        if self.o2:
            o2um = t_tm1[idx.io2] * 1000.0        # tracer.F:559
            bctz = 0.5 * (torch.tanh(o2um - 8.0) + 1.0) \
                * p.bbio ** (p.cbio * temp)
            nud = self.nud0 * (0.65 + 0.35 * torch.tanh(o2um - 3.0))
        else:
            o2um = torch.full_like(temp, 300.0)
            bctz = p.bbio ** (p.cbio * torch.clamp(temp, max=20.0))
            nud = torch.full_like(temp, self.nud0)

        # 3-D carbonate state for dissolution/production/ac13b
        # (mobi_driver:740-766); only CO3/Omega/co2star enter, which
        # depend on DIC/ALK, not on the atmospheric CO2
        if (self.caco3 or self.c13) and self.carbon and self.alk:
            salt = 1.0e3 * t_tm1[idx.isalt] + 35.0
            carb = co2calc_sws(
                torch.clamp(temp, -2.0, 35.0), torch.clamp(salt, 0.0, 45.0),
                t_tm1[idx.idic], t_tm1[idx.ialk], co2ccn,
                depth_m=self.zt_m3, n_iter=25)
            dissk1 = self.dissk0 * _pos(1.0 - carb["omega_c"])
            # Gehlen et al. (2007) eq. 3 with the positive part inside
            # the Michaelis term (the reference's documented choice)
            om1 = _pos(carb["omega_c"] - 1.0)
            capr = p.caprmax * om1 / (p.kcapr + om1)
            if self.c13:
                ac13_dic_aq = -1.0512994e-4 * temp + 1.011765
                ac13_aq_poc = -0.017 * torch.log10(
                    torch.clamp(carb["co2star"] * 1000.0, 2.0, 74.0)) \
                    + 1.0034
                ac13b = ac13_aq_poc / ac13_dic_aq
            else:
                ac13b = torch.zeros_like(temp)
        else:
            dissk1 = torch.full_like(temp, self.dissk0)
            capr = torch.full_like(temp, p.caprmax)
            ac13b = torch.full_like(temp, 1.0)

        levels = torch.arange(km, device=t_tm1.device)[:, None, None]
        in_col = (levels < kmt[None]).to(dt)
        is_bot = ((levels == (kmt - 1)[None]) & (kmt[None] > 0)).to(dt)

        names = self.bio_names
        b_all = t_tm1.index_select(0, self.bio_idx)   # (pool, km, j, i)
        zero2 = torch.zeros_like(swr0)

        swr, phin, caco3in = swr0, zero2, zero2
        expo = expo_phos = expofe = expocaco3 = expoopl = zero2
        rc13expo = rcaco3c13expo = rn15expo = zero2
        outs = dict(snpzd=[], dissl=[], calpro=[], expocaco3=[],
                    expoopl=[], nfix=[], dic_sms=[], bdeni=[])
        for k in range(km):
            bstack = b_all[:, k]
            bk = dict(zip(names, bstack.unbind(0)))
            maskk, botk, o2k = in_col[k], is_bot[k], o2um[k]
            dzk = self.dzt[k]
            # light attenuation by the column above (mobi_driver:768)
            swr = swr * torch.exp(-self.kc * phin - self.kc_c * caco3in)
            phin = torch.clamp(bk["phyt"], min=TRCMIN) * dzk
            if self.nitrogen:
                phin = phin + torch.clamp(bk["diaz"], min=TRCMIN) * dzk
            if self.silicon:
                phin = phin + torch.clamp(bk["diat"], min=TRCMIN) * dzk
            if self.caco3:
                caco3in = caco3in + bk["caco3"] * dzk
            gl = swr * torch.exp(self.ztt[k] * rctheta)
            rdz = self.dztr[k]
            imp = dict(expo=expo * rdz, expo_phos=expo_phos * rdz,
                       expofe=expofe * rdz, expocaco3=expocaco3 * rdz,
                       expoopl=expoopl * rdz, rc13=rc13expo * rdz,
                       rcaco3c13=rcaco3c13expo * rdz, rn15=rn15expo)

            delta, acc = self._mobi_src(
                bstack, gl, bct[k], bctz[k], nud[k], o2k, dissk1[k],
                capr[k], ac13b[k], self.wd[k], self.wc[k], self.wo[k],
                dzk, dayfrac, imp, dtbio)

            snpzd = dict(zip(names, (delta * rdtts * maskk).unbind(0)))
            rn = self.rnbio
            expo_r = acc["expo"] * rn
            expo_phos_r = acc["expo_phos"] * rn
            expofe_r = acc["expofe"] * rn if self.iron else zero2
            expocaco3_r = acc["expocaco3"] * rn if self.caco3 \
                else zero2
            expoopl_r = acc["expoopl"] * rn if self.silicon else zero2
            rc13_r = acc["rc13expo"] * rn if self.c13 else zero2
            rcaco3c13_r = acc["rcaco3c13expo"] * rn \
                if (self.c13 and self.caco3) else zero2
            rn15_r = acc["rn15expo"] * rn if self.n15 else zero2
            calpro_r = acc["calpro"] * rn
            dissl_r = acc["dissl"] * rn if self.caco3 else zero2
            nfix_r = acc["nfix"] * rn if self.nitrogen else zero2

            # ---- bottom fluxes (sgb = bottom-cell indicator;
            # mobi_driver:985-1100, no subgrid bathymetry) ----------
            sgb = botk
            if self.nitrogen:
                no3k = bk["no3"]
                no3flag = _flag(no3k - TRCMIN)
                d15flag = _flag(bk["din15"] - TRCMIN) if self.n15 \
                    else 1.0
                lno3 = 0.5 * torch.tanh(no3k * 10.0 - 5.0)
                sg_bdeni = (0.06 + 0.19 * 0.99
                            ** (torch.clamp(o2k, min=TRCMIN)
                                - torch.clamp(no3k, min=TRCMIN))) \
                    * torch.clamp(expo_r * sgb, min=TRCMIN) \
                    * self.redctn * 1.0e3
                sg_bdeni = torch.minimum(sg_bdeni, sgb * expo_r)
                sg_bdeni = _pos(sg_bdeni) * p.sgbdfac
                sg_bdeni = sg_bdeni * (0.5 + lno3) * no3flag \
                    * d15flag * maskk
                snpzd["no3"] = snpzd["no3"] + sgb * expo_r - sg_bdeni
                if self.n15:
                    floor = TRCMIN * RN15STD / (1 + RN15STD)
                    rno3b = torch.clamp(
                        torch.clamp(bk["din15"], min=floor)
                        / torch.clamp(no3k - bk["din15"], min=floor),
                        RN15STD / 2.0, 2.0 * RN15STD)
                    eps_bd = p.eps_bdeni0 \
                        * math.exp(-2.5e-6 * self.zt_m[k] * 100.0)
                    bbdeni = rno3b - eps_bd * rno3b / 1000.0
                    snpzd["din15"] = snpzd["din15"] \
                        + rn15_r * sgb * expo_r \
                        - bbdeni / (1 + bbdeni) * sg_bdeni
            else:
                sg_bdeni = zero2
            if self.iron:
                fesed = p.fetopsed * bct[k] * expo_phos_r * sgb
                anox = 1.0 - _flag(o2k - p.o2min)
                snpzd["dfe"] = snpzd["dfe"] + fesed \
                    + expofe_r * sgb * anox
                expofe_r = expofe_r - sgb * expofe_r * anox
            snpzd["po4"] = snpzd["po4"] + sgb * expo_phos_r
            if self.carbon:
                snpzd["dic"] = snpzd["dic"] \
                    + sgb * expo_r * self.redctn
            if self.c13:
                snpzd["dic13"] = snpzd["dic13"] \
                    + rc13_r * sgb * self.redctn
                rc13_r = rc13_r - sgb * rc13_r
            expo_r = expo_r - sgb * expo_r
            expo_phos_r = expo_phos_r - sgb * expo_phos_r

            outs["snpzd"].append(torch.stack([snpzd[n] for n in names]))
            outs["dissl"].append(dissl_r * maskk)
            outs["calpro"].append(calpro_r * maskk)
            outs["expocaco3"].append(expocaco3_r * maskk)
            outs["expoopl"].append(expoopl_r * maskk)
            outs["nfix"].append(nfix_r * maskk)
            outs["dic_sms"].append(snpzd["dic"] if self.carbon
                                   else snpzd["po4"] * self.redctp)
            outs["bdeni"].append(sg_bdeni)
            # the export chain into the next level
            expo = expo_r * dzk * maskk
            expo_phos = expo_phos_r * dzk * maskk
            if self.iron:
                expofe = expofe_r * dzk * maskk
            if self.caco3:
                expocaco3 = expocaco3_r * dzk * maskk * (1.0 - sgb)
            if self.silicon:
                expoopl = expoopl_r * dzk * maskk * (1.0 - sgb)
            if self.c13:
                rc13expo = rc13_r * dzk * maskk
                if self.caco3:
                    rcaco3c13expo = rcaco3c13_r * dzk * maskk * (1.0 - sgb)
            rn15expo = rn15_r

        snpzd_all = torch.stack(outs["snpzd"], dim=1)  # (pool, km, j, i)
        rdissl, rcalpro, rexpocaco3, rexpoopl, rnfix, dic_sms, rbdeni = (
            torch.stack(outs[n]) for n in ("dissl", "calpro", "expocaco3",
                                           "expoopl", "nfix", "dic_sms",
                                           "bdeni"))
        src = torch.zeros_like(t_tm1)
        src.index_copy_(0, self.bio_idx, snpzd_all)

        # ---- alkalinity base (mobi_driver:1249-1258) ----------------
        if self.alk:
            alk_src = -dic_sms * self.redntc * 1.0e-3 \
                if self.carbon else torch.zeros_like(dic_sms)

        # ---- O2 / water-column denitrification (mobi_driver:
        # 1283-1345, "2222" loop) -------------------------------------
        if self.o2:
            fo2 = 0.5 * torch.tanh(o2um - 2.5)
            so2 = dic_sms * self.redotc
            if self.nitrogen:
                ino3 = idx["no3"]
                so2 = so2 + rnfix * 1.25e-3
                no3f = _flag(t_tm1[ino3] - TRCMIN)
                d15f = _flag(t_tm1[idx["din15"]] - TRCMIN) \
                    if self.n15 else 1.0
                lno3 = 0.5 * torch.tanh(t_tm1[ino3] - 2.5)
                wcdeni = 800.0 * no3f * so2 * (0.5 - fo2) \
                    * (0.5 + lno3) * d15f
                wcdeni = _pos(wcdeni) * in_col
                src[ino3] = src[ino3] - wcdeni
                if self.n15:
                    no3v = t_tm1[ino3]
                    di15 = t_tm1[idx["din15"]]
                    floor = TRCMIN * RN15STD / (1 + RN15STD)
                    uno3 = torch.clamp(wcdeni * c2dtts
                                       / torch.clamp(no3v, min=TRCMIN),
                                       TRCMIN, 0.999)
                    rno3 = torch.clamp(
                        torch.clamp(di15, min=floor)
                        / torch.clamp(no3v - di15, min=floor),
                        RN15STD / 2.0, 2.0 * RN15STD)
                    bwc = rno3 + p.eps_wcdeni * (1 - uno3) / uno3 \
                        * torch.log1p(-uno3) * rno3 / 1000.0
                    src[idx["din15"]] = src[idx["din15"]] \
                        - (bwc / (1 + bwc)) * wcdeni
                if self.alk:
                    # ALK stoichiometry corrections for denitrification
                    # and N2 fixation (mobi_driver:1327-1334)
                    alk_src = alk_src + wcdeni * 1.0e-3 \
                        + rbdeni * 1.0e-3 - rnfix * 1.0e-3
            src[idx.io2] = -so2 * (0.5 + fo2) * in_col

        # ---- calcite / opal remineralization (mobi_driver "3333") --
        if self.carbon:
            idic = idx.idic
            if self.caco3:
                dic_adj = (rdissl - rcalpro) * 1.0e-3 \
                    + is_bot * rexpocaco3 * 1.0e-3
                src[idic] = src[idic] + dic_adj * in_col
                if self.alk:
                    alk_src = alk_src + 2.0 * dic_adj
                if self.c13:
                    rtdic13 = _ratio(t_tm1[idx["dic13"]], t_tm1[idic],
                                     RC13STD)
                    rtca13 = _ratio(t_tm1[idx["caco3c13"]],
                                    t_tm1[idx["caco3"]], RC13STD)
                    i13 = idx["dic13"]
                    src[i13] = src[i13] + (
                        rdissl * 1e-3 * rtca13
                        - rcalpro * 1e-3 * rtdic13
                        + is_bot * rexpocaco3 * 1e-3 * rtca13) * in_col
            else:
                prca = torch.sum(rcalpro * 1.0e-3 * self.dzt3 * in_col,
                                 dim=0)
                not_bot = in_col * (1.0 - is_bot)
                remin = prca[None] * (self.rcak3 * not_bot
                                      + self.rcab3 * is_bot)
                src[idic] = src[idic] + ((-rcalpro * 1.0e-3) * in_col
                                         + remin)
                if self.alk:
                    alk_src = alk_src - 2.0 * rcalpro * 1e-3 * in_col \
                        + 2.0 * remin
        if self.silicon:
            isil = idx["sil"]
            src[isil] = src[isil] + is_bot * rexpoopl * in_col
        if self.alk:
            src[idx.ialk] = alk_src * in_col

        # ---- DIC-14 (tracer.F:630-645): decay + source slaved to the
        # total DIC source, in the reference's normalized c14 units
        if self.c14 and self.carbon:
            src[idx["c14"]] = (-C14_LAMBDA * t_tm1[idx["c14"]]
                               + src[idx.idic]) * in_col

        # ---- Pa/Th reversible scavenging (protac_thor.F) ------------
        if self.pa_th:
            self._pa_th(src, t_tm1, in_col, c2dtts)
        return src

    # ------------------------------------------------------------------
    def _pa_th(self, src, t_tm1, in_col, twodt):
        """protac_thor_driver (protac_thor.F:355-554): writes the
        pa231/th230 rows of ``src``.

        The per-column flux chain F_in(k) = F_out(k-1) is a shift (the
        partition is local in k), so each of the ntpath=2 substeps is
        one sweep over the whole volume.  Tracers are carried in dpm/m^3.
        """
        idx = self.idx
        detr = torch.clamp(t_tm1[idx["detr"]], min=TRCMIN)
        # mmolN * redctn[molC/mmolN] = molC; * MW_C[kg/mol] -> kg C;
        # * 2.199 -> kg POM (protac_thor.F:189-192)
        pom = detr * self.redctn * MW_C * ORG_TO_C_MASS
        caco3_kg = (torch.clamp(t_tm1[idx["caco3"]], min=TRCMIN) * 1e-3
                    * MW_CACO3) if self.caco3 else 0.0
        opal_kg = (torch.clamp(t_tm1[idx["opl"]], min=TRCMIN)
                   * MW_OPAL) if self.silicon else 0.0
        ctot = pom + caco3_kg + opal_kg
        spm = 1.0e9 * ctot / RHOSW          # ug/kg
        kref = (torch.clamp(spm, min=1e-12) ** PATH_SPM_EXP) * 1.0e7

        ntpath = 2
        dtp = twodt / ntpath
        pa0 = t_tm1[idx["pa231"]]
        th0 = t_tm1[idx["th230"]]

        def partition_flux(x, kfac, beta, lam):
            s_pom = kref * kfac["pom"] * pom / RHOSW
            s_ca = kref * kfac["caco3"] * caco3_kg / RHOSW
            s_op = kref * kfac["opal"] * opal_kg / RHOSW
            s_tot = s_pom + s_ca + s_op
            xd = x / (1.0 + s_tot)
            f_out = (self.w_pom3 * s_pom + self.w_ca3 * s_ca
                     + self.w_op3 * s_op) * xd
            f_out = f_out * in_col
            f_in = torch.cat([torch.zeros_like(f_out[:1]), f_out[:-1]],
                             dim=0)
            return beta - lam * torch.clamp(x, min=TRCMIN) \
                + (f_in - f_out) * self.dzm_r3

        pa, th = pa0, th0
        for _ in range(ntpath):
            pa = pa + dtp * partition_flux(torch.clamp(pa, min=TRCMIN),
                                           KPA_FAC, BETA_PA, LAMBDA_PA)
            th = th + dtp * partition_flux(torch.clamp(th, min=TRCMIN),
                                           KTH_FAC, BETA_TH, LAMBDA_TH)
        src[idx["pa231"]] = (pa - pa0) / twodt * in_col
        src[idx["th230"]] = (th - th0) / twodt * in_col
