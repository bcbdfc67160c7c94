"""The earth model's circulation, a year at a time: annual-mean
overturning, streamfunction and velocity extrema, and the annual TOA.

    python3 -m uvic_tpu_torch.probes.moc [YEARS] [--device D]

The port of ``scripts/probe_moc.py``: the year's means of the segment-mean
v and psi and its sums of the TOA fluxes (a segment alone aliases the
seasons), one JSON line a year with the global overturning's extrema and
where they sit, the largest |v| of the annual mean and |u| of the
end-of-year state, psi's extremum and the annual TOA by latitude; after
the final year the overturning's profile at six latitudes.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import add_device, advance, earth_model, segments_per_year

TOA_LATS = (-85, -60, -30, 0, 30, 60, 85)
PROFILE_LATS = (-60, -30, 0, 30, 50, 65)
ACC_KEYS = ("toa_sw", "olr", "heat", "time")


def year_row(m, w, yr, v_ann, psi_ann, acc_sum, u_full) -> dict:
    """The year's line (without ``wall``) and the overturning [Sv]."""
    from ..diag import climate
    g = m.grid
    latu = np.asarray(g.yu)
    zt_km = np.asarray(g.zt) / 1e5
    moc = climate.overturning_sv(m, v_ann)
    toa2d = climate.toa_net(acc_sum)
    kmax, jmax = np.unravel_index(np.argmax(moc), moc.shape)
    kmin, jmin = np.unravel_index(np.argmin(moc), moc.shape)
    vab = np.abs(climate.host(v_ann))
    kv, jv, iv = np.unravel_index(np.argmax(vab), vab.shape)
    uab = np.abs(climate.host(u_full))
    cu, ku, ju, iu = np.unravel_index(np.argmax(uab), uab.shape)
    psiab = np.abs(climate.host(psi_ann))
    jp, ip = np.unravel_index(np.argmax(psiab), psiab.shape)
    toa_z = climate.pick(climate.zonal(toa2d, w.area, empty=0.0), w.lat,
                         TOA_LATS)
    row = dict(
        yr=yr,
        toa_gm_ann=round(climate.area_mean(toa2d, w.area), 2),
        toa_z_ann=[round(x, 1) for x in toa_z],
        moc_max=round(float(moc.max()), 1),
        moc_max_at=dict(z_km=round(zt_km[kmax], 2),
                        lat=round(latu[jmax], 1)),
        moc_min=round(float(moc.min()), 1),
        moc_min_at=dict(z_km=round(zt_km[kmin], 2),
                        lat=round(latu[jmin], 1)),
        vmax_cm_s=round(float(vab.max()), 1),
        vmax_at=dict(z_km=round(zt_km[kv], 2), lat=round(latu[jv], 1),
                     i=int(iv)),
        umax_inst=round(float(uab.max()), 1),
        umax_at=dict(c=int(cu), z_km=round(zt_km[ku], 2),
                     lat=round(latu[ju], 1), i=int(iu)),
        psi_max_sv=round(float(psiab.max()) / 1e12, 1),
        psi_max_at=dict(lat=round(latu[jp], 1), i=int(ip)),
    )
    return row, moc


def profiles(m, moc) -> list:
    """The overturning at every third level at PROFILE_LATS."""
    latu = np.asarray(m.grid.yu)
    out = []
    for L in PROFILE_LATS:
        j = int(np.argmin(np.abs(latu - L)))
        out.append(dict(lat=L, moc_profile=[
            round(float(moc[k, j]), 1) for k in range(0, m.grid.km, 3)]))
    return out


def run_years(m, state, years):
    """The script's loop, a JSON line a year; returns the end state."""
    from ..diag.climate import ClimateWeights
    w = ClimateWeights(m)
    seg_per_year = segments_per_year(m)
    t0 = time.time()
    for yr in range(years):
        sums = {}
        for _ in range(seg_per_year):
            state = advance(m, state)
            for k, x in [("v", m.last_tavg["v"]), ("psi", m.last_tavg["psi"])] \
                    + [(k, m.last_acc[k]) for k in ACC_KEYS]:
                x = x.double()
                sums[k] = x if k not in sums else sums[k] + x
        host = {k: v.cpu().numpy() for k, v in sums.items()}
        u_full = m.ocean.full_velocity(state.ocean.u, state.ocean.psi0)
        row, moc = year_row(m, w, yr + 1, host["v"] / seg_per_year,
                            host["psi"] / seg_per_year,
                            {k: host[k] for k in ACC_KEYS}, u_full)
        row["wall"] = round(time.time() - t0, 1)
        print(json.dumps(row), flush=True)
        if yr == years - 1:
            for prof in profiles(m, moc):
                print(json.dumps(prof), flush=True)
    return state


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch.probes.moc")
    p.add_argument("years", type=int, nargs="?", default=2)
    add_device(p)
    a = p.parse_args(argv)
    m = earth_model(a.device)
    run_years(m, m.init_state(), a.years)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
