"""Earth climate tuning harness: N model years, one line of climate
indicators a year.

    python3 -m uvic_tpu_torch.tune_earth [YEARS] [--device cuda|cpu]

The port of ``scripts/tune_earth.py``: the earth model of the repo's
tools (``config.tools_earth_config``, float32) from ``init_state()``,
YEARS years of 72 segments (replayed on the card), and after each year
the script's report (``report``: ``diag.climate.tuning_row`` rounded as
the script rounds it, with ``yr`` and ``wall``).  A non-finite global
SAT ends the run with ``SystemExit``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

DIGITS = dict(sat_gm=2, sat_max=1, sat_land_max=1, sst_gm=2, sst_max=1,
              sst_min=1, sst_z=1, sat_z=1, ice_nh=1, ice_sh=1, psi_sv=1,
              moc_max=1, moc_min=1, toa_gm=2, olr_gm=1, ohf_gm=2, toa_z=1)


def report(m, state, w, yr, t0) -> dict:
    """The script's yearly line: the indicators rounded to its digits."""
    from .diag.climate import tuning_row
    d = {"yr": yr}
    for k, v in tuning_row(m, state, w).items():
        n = DIGITS[k]
        d[k] = [round(x, n) for x in v] if isinstance(v, list) \
            else round(v, n)
    d["wall"] = round(time.time() - t0, 1)
    return d


def run_years(m, state, years, seg_per_year=None):
    """The script's year loop, its report a year; returns the end
    state."""
    from .diag.climate import ClimateWeights
    cfg = m.cfg
    if seg_per_year is None:
        yrlen = 360.0 if cfg.time.eqyear else 365.0
        seg_per_year = int(round(yrlen / cfg.time.segtim_days))
    w = ClimateWeights(m)
    t0 = time.time()
    for yr in range(years):
        state = m.run(state, seg_per_year)
        d = report(m, state, w, yr + 1, t0)
        print(json.dumps(d), flush=True)
        if not np.isfinite(d["sat_gm"]):
            raise SystemExit("non-finite")
    return state


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch.tune_earth")
    p.add_argument("years", type=int, nargs="?", default=5)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    from .config import tools_earth_config
    from .coupler.driver import CoupledModel
    m = CoupledModel(tools_earth_config(), topo_kind="earth",
                     device=a.device)
    run_years(m, m.init_state(), a.years)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
