"""The TOA diagnostic against the heat reservoirs, term by term.

    python3 -m uvic_tpu_torch.probes.toa_decompose [SEGMENTS]
        [--restart P] [--device D]

The port of ``scripts/probe_toa_decompose.py``: segments of
``earth_config()`` from a restart (default
``earth_spinup/restart.npz``), each taken phase by phase
(``debug.segment_phases``), with every energy pathway of its atmosphere
substeps summed (the expected atmosphere source, the land surface
residual, the TOA, the ocean heat flux, the fusion of snowfall) and set
against the measured changes of the atmosphere's heat, the ice and snow
mass, the soil moisture and the ocean's heat; one JSON line a segment
[W/m^2 of the globe].  The state advances by the manual segments (the
land and sediments stay as they are, as in the script).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from . import RHOCP, YEAR_DAYS, add_device, earth_model
from .energy import FLICE, atm_heat_j

STEP_KEYS = ("toa_sw", "olr", "swr", "uplwr", "upsens", "upltnt", "evap",
             "psno", "precip", "heat", "time")


class SegmentSources:
    """The segment's pathway integrals [erg], summed substep by substep."""

    def __init__(self, area, lmsk):
        self.area, self.lmsk = area, lmsk
        self.s = dict(atm_src=0.0, land_res=0.0, toa=0.0, ocn_heat=0.0,
                      snow_fus=0.0, time=0.0)

    def add(self, a):
        from ..diag.climate import host
        from ..models.embm import constants as C
        f = {k: host(a[k]) for k in STEP_KEYS}
        area, s = self.area, self.s
        src = (f["toa_sw"] - f["swr"] - f["olr"] + f["uplwr"] + f["upsens"]
               + C.VLOCN * f["evap"] + (C.SLICE - C.VLOCN) * f["psno"])
        s["atm_src"] += float((src * area).sum())
        s["land_res"] += float(((f["swr"] - f["uplwr"] - f["upltnt"]
                                 - f["upsens"]) * self.lmsk * area).sum())
        s["toa"] += float(((f["toa_sw"] - f["olr"]) * area).sum())
        s["ocn_heat"] += float((f["heat"] * area).sum())
        s["snow_fus"] += float(((C.SLICE - C.VLOCN) * f["psno"]
                                 * area).sum())
        s["time"] += float(f["time"])


def ice_mass(ice, area) -> float:
    from ..diag.climate import host
    from ..models.embm import constants as C
    return float(((host(ice.hice) * host(ice.aice) * C.RHOICE
                   + host(ice.hsno) * C.RHOSNO) * area).sum())


def soil_water(atm, lmsk, area) -> float:
    from ..diag.climate import host
    return float((host(atm.soilm) * lmsk * area).sum())


def ocean_heat(t, dvol) -> float:
    from ..diag.climate import host
    return float((host(t[0]) * host(dvol)).sum()) * RHOCP


def segment_row(seg, src, phys_t, earth_area, d_atm, d_ice, d_soilm,
                d_ocn) -> dict:
    """The segment's line from its pathway sums ``src`` and the changes
    of the atmosphere's heat, the ice + snow mass, the soil water and
    the ocean's heat."""
    s = src.s
    r = phys_t / s["time"]

    def wm2(x):
        return round(x / phys_t / earth_area * 1e-3, 3)

    return dict(
        seg=seg,
        toa_wm2=wm2(s["toa"] * r),
        d_atm_wm2=wm2(d_atm),
        exp_atm_wm2=wm2(s["atm_src"] * r),
        atm_transport_loss_wm2=wm2(d_atm - s["atm_src"] * r),
        d_ocn_wm2=wm2(d_ocn * 1.0),
        exp_ocn_wm2=wm2(s["ocn_heat"] * r),
        land_res_wm2=wm2(s["land_res"] * r),
        d_ice_lat_wm2=wm2(-FLICE * d_ice),
        d_soilm_kg=round(d_soilm * 1e-3, 3),
        snow_fus_wm2=wm2(s["snow_fus"] * r))


def decompose(m, state, nseg):
    """``nseg`` manual segments from ``state``, a JSON line each; returns
    the end state."""
    from ..debug import segment_phases
    from ..diag.climate import host
    from ..diag.conservation import FullAudit
    audit = FullAudit(m)
    area = host(audit.area)
    earth_area = float(area.sum())
    lmsk = host(m.embm.lmsk)
    phys_t = m.ntspas * m.cfg.embm.dtatm
    for seg in range(nseg):
        src = SegmentSources(area, lmsk)
        e_atm0 = atm_heat_j(state.atm.at, area) * 1e7
        m_ice0 = ice_mass(state.ice, area)
        soil0 = soil_water(state.atm, lmsk, area)
        o0 = ocean_heat(state.ocean.t, audit.dvol)
        for phase in segment_phases(m, state):
            if phase[0] == "atm_ice":
                _, _, atm, ice, a = phase
                src.add(a)
            elif phase[0] == "ocean":
                ocean = phase[2]
        row = segment_row(
            seg, src, phys_t, earth_area,
            atm_heat_j(atm.at, area) * 1e7 - e_atm0,
            ice_mass(ice, area) - m_ice0,
            soil_water(atm, lmsk, area) - soil0,
            ocean_heat(ocean.t, audit.dvol) - o0)
        state = dataclasses.replace(state, atm=atm, ice=ice, ocean=ocean)
        m.relyr += m.cfg.time.segtim_days / YEAR_DAYS
        print(json.dumps(row), flush=True)
    return state


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m uvic_tpu_torch.probes.toa_decompose")
    p.add_argument("segments", type=int, nargs="?", default=6)
    p.add_argument("--restart", default="earth_spinup/restart.npz")
    add_device(p)
    a = p.parse_args(argv)
    from ..config import earth_config
    from ..io.restart import load_restart
    m = earth_model(a.device, earth_config())
    state = load_restart(a.restart, m.init_state())
    meta = os.path.join(os.path.dirname(a.restart), "restart_meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            m.relyr = json.load(f)["relyr"]
    decompose(m, state, a.segments)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
