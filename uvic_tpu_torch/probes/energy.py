"""Energy closure of the earth model, a year at a time.

    python3 -m uvic_tpu_torch.probes.energy [YEARS] [--earth]
        [--restart P] [--device D]

The port of ``scripts/probe_energy.py``: per model year the change dE of
the heat reservoirs (atmosphere sensible and latent + ocean heat - the
latent heat of ice and snow, ``diag.conservation.FullAudit``) against
the year's TOA integral (absorbed shortwave - OLR) and ocean surface heat
flux, and the atmosphere's change against its expected sources; one
JSON line a year.  ``--earth`` takes ``earth_config()`` instead of the
tools' model; ``--restart`` starts from a restart (and the ``relyr`` of
the ``restart_meta.json`` beside it).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import YEAR_DAYS, add_device, advance, earth_model, segments_per_year

FLICE = 3.34e9
FLUX_KEYS = ("toa_sw", "olr", "swr", "uplwr", "upsens", "upltnt", "evap",
             "psno", "heat", "time")


def total_energy(audit, state):
    """(the system's heat reservoir [J], the inventories)."""
    inv = audit.inventories(state)
    return (inv["atm_heat_J"] + inv["ocn_heat_J"]
            - FLICE * 1e-7 * inv["ice_water_kg"] * 1e3), inv


def atm_heat_j(at, area) -> float:
    """The atmosphere's sensible + latent heat [J] of ``at``."""
    from ..diag.climate import host
    from ..models.embm import constants as C
    a = host(at)
    return float(((a[0] * C.CPATM * C.RHOATM * C.SHT
                   + a[1] * C.RHOATM * C.SHQ * C.VLOCN) * area).sum()) * 1e-7


class YearIntegrals:
    """The year's area integrals [J] of the segment flux totals, each
    rescaled from the accumulated (leapfrog-weighted) time to the
    physical segment."""

    def __init__(self, area, lmsk, phys_seg):
        self.area, self.lmsk, self.phys_seg = area, lmsk, phys_seg
        self.toa = self.ohf = self.exp_atm = self.land_res = 0.0

    def add(self, acc):
        from ..diag.climate import host
        from ..models.embm import constants as C
        f = {k: host(acc[k]) for k in FLUX_KEYS}
        r = self.phys_seg / float(f["time"])
        area = self.area
        self.toa += float(((f["toa_sw"] - f["olr"]) * area).sum()) * 1e-7 * r
        self.ohf += float((f["heat"] * area).sum()) * 1e-7 * r
        exp_atm = ((f["toa_sw"] - f["swr"]) - f["olr"] + f["uplwr"]
                   + f["upsens"] + C.VLOCN * f["evap"]
                   + (C.SLICE - C.VLOCN) * f["psno"])
        self.exp_atm += float((exp_atm * area).sum()) * 1e-7 * r
        land_res = (f["swr"] - f["uplwr"] - f["upltnt"]
                    - f["upsens"]) * self.lmsk
        self.land_res += float((land_res * area).sum()) * 1e-7 * r


def year_row(yr, ints, e0, inv0, e1, inv1, e_atm0, e_atm1, earth_area,
             ocean_area, sat_gm) -> dict:
    yr_s = YEAR_DAYS * 86400.0

    def wm2(x, a=earth_area):
        return round(x / yr_s / a * 1e7 * 1e-3, 3)

    return dict(
        yr=yr,
        dE_wm2=wm2(e1 - e0),
        toa_wm2=wm2(ints.toa),
        ohf_wm2_ocean=wm2(ints.ohf, ocean_area),
        d_ocn_heat_wm2=wm2(inv1["ocn_heat_J"] - inv0["ocn_heat_J"]),
        d_atm_heat_wm2=wm2(inv1["atm_heat_J"] - inv0["atm_heat_J"]),
        d_ice_latent_wm2=round(
            -FLICE * 1e-4 * (inv1["ice_water_kg"] - inv0["ice_water_kg"])
            / yr_s / earth_area * 1e-3, 3),
        atm_transport_loss_wm2=wm2((e_atm1 - e_atm0) - ints.exp_atm),
        land_res_wm2=wm2(ints.land_res),
        sat_gm=round(sat_gm, 2))


def run_years(m, state, years):
    """The script's loop, a JSON line a year; returns the end state."""
    from ..diag.climate import host
    from ..diag.conservation import FullAudit
    audit = FullAudit(m)
    area = host(audit.area)
    earth_area = float(area.sum())
    ocean_area = float(host(audit.ocean_area).sum())
    lmsk = host(m.embm.lmsk)
    phys_seg = m.ntspas * m.cfg.embm.dtatm
    e0, inv0 = total_energy(audit, state)
    t0 = time.time()
    for yr in range(years):
        ints = YearIntegrals(area, lmsk, phys_seg)
        e_atm0 = atm_heat_j(state.atm.at, area)
        for _ in range(segments_per_year(m)):
            state = advance(m, state)
            ints.add(m.last_acc)
        e1, inv1 = total_energy(audit, state)
        row = year_row(yr + 1, ints, e0, inv0, e1, inv1, e_atm0,
                       atm_heat_j(state.atm.at, area), earth_area,
                       ocean_area, float(host(state.atm.at[0]).mean()))
        row["wall"] = round(time.time() - t0, 1)
        print(json.dumps(row), flush=True)
        e0, inv0 = e1, inv1
    return state


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch.probes.energy")
    p.add_argument("years", type=int, nargs="?", default=2)
    p.add_argument("--earth", action="store_true")
    p.add_argument("--restart", default=None)
    add_device(p)
    a = p.parse_args(argv)
    from ..config import earth_config
    from ..io.restart import load_restart
    m = earth_model(a.device, earth_config() if a.earth else None)
    state = m.init_state()
    if a.restart:
        state = load_restart(a.restart, state)
        meta = os.path.join(os.path.dirname(a.restart), "restart_meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                m.relyr = json.load(f)["relyr"]
    run_years(m, state, a.years)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
