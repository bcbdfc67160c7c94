"""Per-segment ocean heat closure over full years of the coupled earth
run: which segments leak.

    python3 -m uvic_tpu_torch.probes.year_closure [YEARS] [--device D]

The port of ``scripts/probe_year_closure.py``: for every segment the
change of the ocean heat inventory less the heat flux the coupler applied
(``last_acc["heat"]``) and the geothermal heat, in W/m^2 over the ocean;
the inventory is summed on the host in float64 from the device's
per-column partials (``diag.tsi.column_sum``).  One JSON line a year:
the mean, extremes and worst segment of its residuals.  The heat total
carries the atmosphere's leapfrog weights (``last_acc["time"]`` is twice
the segment), so the applied heat is the total over its accumulated time
times the segment, as gosbc applies it; the script takes the total as it
stands, which puts the whole applied flux into its residual.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import (CAL_PER_ERG, RHOCP, add_device, advance, earth_model,
               segments_per_year)


def heat_inventory(t, dvol) -> float:
    """The ocean heat inventory [K cm^3] of the tracers ``t``: column
    partials on the device, their float64 sum on the host."""
    from ..diag.tsi import column_sum, host_sum
    return host_sum(column_sum(t[0] * dvol))


def bhf_rate(m, area64) -> float:
    """The geothermal heat input [K cm^3/s] over the ocean area."""
    from ..diag.climate import host
    if m.ocean.bhf is None:
        return 0.0
    return float((host(m.ocean.bhf) * area64).sum())


def segment_residual_wm2(h0, h1, acc, bhf, area64, seg_s) -> float:
    """The segment's closure residual [W/m^2 of ocean]: the inventory's
    change less the applied heat flux (the flux totals ``acc``: heat in
    erg/cm^2 over the accumulated time) and the geothermal heat (``bhf``
    [K cm^3/s]) over ``seg_s``."""
    from ..diag.climate import host
    applied = float((host(acc["heat"]) * area64).sum()) * CAL_PER_ERG \
        * seg_s / float(host(acc["time"]))
    resid = h1 - h0 - applied - bhf * seg_s
    return resid * RHOCP / seg_s / float(area64.sum()) * 1e-3


def year_row(yr, resids) -> dict:
    r = np.asarray(resids)
    iworst = int(np.abs(r).argmax())
    return dict(yr=yr, resid_mean_wm2=round(float(r.mean()), 3),
                resid_min=round(float(r.min()), 3),
                resid_max=round(float(r.max()), 3),
                worst_seg=iworst, worst=round(float(r[iworst]), 3))


def run_years(m, state, years, seg_per_year=None):
    """The script's loop, a JSON line a year; returns the end state."""
    from ..diag.climate import host
    from ..diag.conservation import FullAudit
    audit = FullAudit(m)
    area64 = host(audit.ocean_area)
    bhf = bhf_rate(m, area64)
    seg_per_year = seg_per_year or segments_per_year(m)
    seg_s = m.cfg.time.segtim_days * 86400.0
    h0 = heat_inventory(state.ocean.t, audit.dvol)
    for yr in range(years):
        resids = []
        for _ in range(seg_per_year):
            state = advance(m, state)
            h1 = heat_inventory(state.ocean.t, audit.dvol)
            resids.append(segment_residual_wm2(
                h0, h1, m.last_acc, bhf, area64, seg_s))
            h0 = h1
        print(json.dumps(year_row(yr + 1, resids)), flush=True)
    return state


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m uvic_tpu_torch.probes.year_closure")
    p.add_argument("years", type=int, nargs="?", default=1)
    add_device(p)
    a = p.parse_args(argv)
    m = earth_model(a.device)
    run_years(m, m.init_state(), a.years)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
