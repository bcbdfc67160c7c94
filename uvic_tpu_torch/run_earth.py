"""Coupled earth acceptance run: N model years, their climate
diagnostics, and the final year's sea-ice cycle.

    python3 -m uvic_tpu_torch.run_earth [YEARS] [OUT.json]
        [--device cuda|cpu]

The port of ``scripts/run_earth.py``: the earth model of the repo's tools
(``config.tools_earth_config``, float32) from ``init_state()``, YEARS
years of 72 segments (replayed on the card); after each year one JSON
line of ``diag.climate.acceptance_row`` with ``year`` and ``wall_s``;
every 6th segment of the final year the NH and SH sea-ice area; then
``{"years", "yearly", "final_year_ice", "wall_s"}`` into OUT.json
(default ``earth_run.json``).  A non-finite SST ends the run with a
``RuntimeError``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

ICE_EVERY = 6    # segments between two samples of the final year's ice


def run_years(m, state, years, seg_per_year=None):
    """The script's year loop, a JSON line a year; returns (yearly rows,
    the final year's ice samples, the end state)."""
    from .diag.climate import ClimateWeights, acceptance_row
    cfg = m.cfg
    seg_days = cfg.time.segtim_days
    yrlen = 360.0 if cfg.time.eqyear else 365.0
    if seg_per_year is None:
        seg_per_year = int(round(yrlen / seg_days))
    w = ClimateWeights(m)
    t0 = time.time()
    yearly, final_year = [], []
    for yr in range(years):
        for s in range(seg_per_year):
            state = m.run(state, 1)
            if yr == years - 1 and s % ICE_EVERY == 0:
                d = acceptance_row(m, state, w)
                final_year.append(dict(
                    doy=round((s + 1) * seg_days, 1),
                    ice_nh=d["ice_area_nh_1e6km2"],
                    ice_sh=d["ice_area_sh_1e6km2"]))
        d = acceptance_row(m, state, w)
        d["year"] = yr + 1
        d["wall_s"] = round(time.time() - t0, 1)
        yearly.append(d)
        print(json.dumps(d), flush=True)
        if not np.isfinite(d["sst_mean"]):
            raise RuntimeError("non-finite state")
    return yearly, final_year, state


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch.run_earth")
    p.add_argument("years", type=int, nargs="?", default=10)
    p.add_argument("out", nargs="?", default="earth_run.json")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    from .config import tools_earth_config
    from .coupler.driver import CoupledModel
    m = CoupledModel(tools_earth_config(), topo_kind="earth",
                     device=a.device)
    t0 = time.time()
    yearly, final_year, _ = run_years(m, m.init_state(), a.years)
    summary = dict(years=a.years, yearly=yearly, final_year_ice=final_year,
                   wall_s=round(time.time() - t0, 1))
    with open(a.out, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
