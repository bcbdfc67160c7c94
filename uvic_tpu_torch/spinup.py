"""Long coupled spin-up of the earth configuration, in PyTorch.

    python3 -m uvic_tpu_torch.spinup YEARS [--accel F] [--out DIR]
        [--resume] [--log FILE] [--save-every N] [--run-id ID]
        [--device cuda|cpu]

The port of ``scripts/spinup_earth.py``, the model's core use case
(source/common/UVic_ESCM.F:296-416, the segment loop over decades): N
model years of ``CoupledModel(earth_config(accel=F), topo_kind="earth")``
logging one JSONL row of ANNUAL-mean climate diagnostics a year (the
script's keys, rounding and order: ``yearly_diags`` and the energy
audit), with ``restart.npz`` and ``restart_meta.json`` (year, relyr,
accel) every ``--save-every`` years and at the end.  ``--resume`` starts
from ``DIR/restart.npz`` with the year and relyr of its meta, as
``earth_accept/`` holds them.  ``--accel`` > 1 is the accel.h deep
tracer acceleration (Bryan 1984 asynchronous stepping).  On the card each
segment is the replay of the coupler's stage graphs (``CoupledModel.run``,
which advances ``relyr`` itself); the year's sums (the flux totals, the
segment means of v, psi and the GM bolus velocity, the sea-ice area
samples of every 6th segment) stay on the device in float64 and are read
once a year.  A non-finite global SAT ends the run with ``SystemExit``.

``run_years`` is the year loop (any configuration, any year length) and
``main`` parses the flags and does the files.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .diag import climate

FLICE = 3.34e9        # latent heat of fusion [erg/g], the audit's ice term
ICE_SAMPLE_EVERY = 6  # segments between two sea-ice area samples
ACC_KEYS = ("toa_sw", "olr", "heat", "time")


def _psi_loc(psi_ann, m):
    """(lat, lon) of the |psi| maximum: separates the ACC from the
    transient SO deep-convection barotropic vortices."""
    p = np.abs(np.asarray(psi_ann))
    jj, ii = np.unravel_index(p.argmax(), p.shape)
    return [round(float(np.asarray(m.grid.yu)[jj]), 1),
            round(float(np.asarray(m.grid.xu)[ii]) % 360.0, 1)]


def _drake_transport(psi_ann, m):
    """ACC transport [Sv]: the psi range along a meridional section
    through Drake Passage (what the ~130-170 Sv estimates measure)."""
    yu = np.asarray(m.grid.yu)
    xu = np.asarray(m.grid.xu) % 360.0
    i = int(np.argmin(np.abs(xu - 292.0)))
    jsel = (yu > -66.0) & (yu < -54.0)
    sec = np.asarray(psi_ann)[jsel, i]
    return round(float(sec.max() - sec.min()) / 1e12, 1)


def yearly_diags(m, state, acc_sum, v_ann, psi_ann, ice_samples, area,
                 oarea, lat, vgm_ann=None, amask=None):
    """The year's row from its sums (host float64 arrays, as the script
    keeps them) and the end-of-year state: global means, sea-ice extremes,
    the barotropic and overturning circulations (Eulerian, and the
    residual with the GM bolus part and its Atlantic max when ``vgm_ann``
    is given), zonal means of the TOA balance and the SAT."""
    from .diag.energy import gm_overturning, meridional_overturning

    dt = state.ocean.t.dtype
    dev = state.ocean.t.device

    def dev_t(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    g = m.ocean.g
    sst = state.ocean.t[0, 0].detach().cpu().numpy()
    sat = state.atm.at[0].detach().cpu().numpy()
    toa2d = climate.toa_net(acc_sum)
    heat2d = climate.flux_wm2(acc_sum, "heat")
    moc = host(meridional_overturning(dev_t(v_ann), g, m.ocean.umask)) \
        / 1e12
    moc_res = amoc = None
    if vgm_ann is not None:
        # residual (Eulerian + GM bolus) overturning (diago.F O_gm_diag)
        psi_gm = host(gm_overturning(dev_t(vgm_ann), g)) / 1e12
        moc_res = moc + psi_gm
        if amask is not None:
            moc_a = host(meridional_overturning(
                dev_t(v_ann), g, m.ocean.umask * dev_t(amask)[None])) / 1e12
            moc_a += host(gm_overturning(dev_t(vgm_ann), g,
                                         xmask2d=dev_t(amask))) / 1e12
            # AMOC headline: the residual Atlantic deep cell's max north
            # of 30S below 500 m
            zt = np.asarray(m.grid.zt)
            deep = zt >= 500.0e2
            jn_ = np.asarray(m.grid.yu) > -30.0
            amoc = float(moc_a[np.ix_(deep, jn_)].max())
    # the Eulerian zonal-mean MOC at the equator is dominated by the
    # surface Ekman rolls: the headline masks |lat| <= 5
    yu = np.asarray(m.grid.yu)
    exeq = np.abs(yu) > 5.0
    moc_x = moc[:, exeq]
    ice_nh = np.asarray([s[0] for s in ice_samples])
    ice_sh = np.asarray([s[1] for s in ice_samples])

    def zavg(f, lats):
        return [round(x, 1) for x in climate.pick(
            climate.zonal(f, area, empty=0.0), lat, lats)]

    extra = {}
    if moc_res is not None:
        zt_m = np.asarray(m.grid.zt) / 1e2
        mr = moc_res[:, exeq]
        jmap = np.where(exeq)[0]

        def loc(flat_arg):
            kk, jj = np.unravel_index(flat_arg, mr.shape)
            return [round(float(yu[jmap[jj]]), 1),
                    round(float(zt_m[kk]), 0)]

        extra = dict(moc_res_max=round(float(mr.max()), 1),
                     moc_res_min=round(float(mr.min()), 1),
                     # (lat_deg, depth_m) of the extrema
                     moc_res_max_loc=loc(mr.argmax()),
                     moc_res_min_loc=loc(mr.argmin()))
        if amoc is not None:
            extra["amoc_sv"] = round(amoc, 1)
    return dict(
        **extra,
        sat_gm=round(climate.area_mean(sat, area), 3),
        sst_gm=round(climate.area_mean(sst, oarea), 3),
        toa_gm=round(climate.area_mean(toa2d, area), 3),
        ohf_gm=round(climate.area_mean(heat2d, oarea), 3),
        ice_nh_min=round(float(ice_nh.min()), 2),
        ice_nh_max=round(float(ice_nh.max()), 2),
        ice_sh_min=round(float(ice_sh.min()), 2),
        ice_sh_max=round(float(ice_sh.max()), 2),
        psi_max=round(climate.psi_max(psi_ann), 1),
        psi_max_loc=_psi_loc(psi_ann, m),
        acc_drake_sv=_drake_transport(psi_ann, m),
        moc_max=round(float(moc.max()), 1),
        moc_min=round(float(moc.min()), 1),
        moc_max_exeq=round(float(moc_x.max()), 1),
        moc_min_exeq=round(float(moc_x.min()), 1),
        toa_z=zavg(toa2d, [-85, -60, -30, 0, 30, 60, 85]),
        sat_z=zavg(sat, [-85, -60, -30, 0, 30, 60, 85]),
    )


def run_year(m, state, seg_per_year, w: climate.ClimateWeights):
    """``seg_per_year`` segments (``m.run``: replayed on the card), their
    sums kept on the device in float64.  Returns the
    state and, read to the host once, the flux totals, the means of v,
    psi and vntiso (None without GM) and the (NH, SH) ice-area samples
    [1e12 m^2] of every ICE_SAMPLE_EVERY-th segment."""
    sums, ice = {}, []
    for s in range(seg_per_year):
        state = m.run(state, 1)
        for k in ACC_KEYS:
            x = m.last_acc[k].double()
            sums[k] = x if k not in sums else sums[k] + x
        for k in ("v", "psi", "vntiso"):
            if k in m.last_tavg:
                x = m.last_tavg[k].double()
                sums[k] = x if k not in sums else sums[k] + x
        if s % ICE_SAMPLE_EVERY == 0:
            aice = state.ice.aice.double()
            ice.append(torch.stack([(aice * w.nh).sum() / 1e16,
                                    (aice * w.sh).sum() / 1e16]))
    host = {k: v.cpu().numpy() for k, v in sums.items()}
    acc_sum = {k: host[k] for k in ACC_KEYS}
    mean = {k: host[k] / seg_per_year for k in ("v", "psi", "vntiso")
            if k in host}
    samples = [tuple(float(x) for x in row)
               for row in torch.stack(ice).cpu().numpy()]
    return state, acc_sum, mean["v"], mean["psi"], mean.get("vntiso"), \
        samples


def run_years(m, state, years, year0=0, accel=1.0, run_id="",
              seg_per_year=None, on_year=None):
    """The spin-up loop: ``years`` years from year ``year0`` (a year of
    ``seg_per_year`` segments, by default the calendar's), each one's row
    with the energy audit (the drift of atmosphere + ocean heat - ice
    latent heat against the TOA balance), handed to ``on_year(row,
    state)``.  Returns the end state."""
    from .diag.conservation import FullAudit
    cfg = m.cfg
    yrlen = 360.0 if cfg.time.eqyear else 365.0
    if seg_per_year is None:
        seg_per_year = int(round(yrlen / cfg.time.segtim_days))
    w = climate.ClimateWeights(m)
    audit = FullAudit(m)
    earth_area = float(audit.area.double().sum())
    yr_s = yrlen * 86400.0

    def total_E(state):
        # the inventories as host floats, as the reference's audit
        # returns them
        inv = {k: float(v) for k, v in audit.inventories(state).items()}
        return (inv["atm_heat_J"] + inv["ocn_heat_J"]
                - FLICE * 1e-4 * inv["ice_water_kg"])    # J

    t0 = time.time()
    E_prev = total_E(state)
    for yr in range(year0, year0 + years):
        state, acc_sum, v_ann, psi_ann, vgm_ann, ice = run_year(
            m, state, seg_per_year, w)
        d = yearly_diags(m, state, acc_sum, v_ann, psi_ann, ice, w.area,
                         w.oarea, w.lat, vgm_ann=vgm_ann, amask=w.amask)
        d["year"] = yr + 1
        d["wall_s"] = round(time.time() - t0, 1)
        d["run_id"] = run_id
        d["accel"] = accel
        E_now = total_E(state)
        d["dE_wm2"] = round((E_now - E_prev) / yr_s / earth_area * 1e4, 3)
        d["toa_audit_resid_wm2"] = round(d["toa_gm"] - d["dE_wm2"], 3)
        E_prev = E_now
        if not np.isfinite(d["sat_gm"]):
            raise SystemExit("non-finite state at year %d" % (yr + 1))
        if on_year is not None:
            on_year(d, state)
    return state


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch.spinup")
    p.add_argument("years", type=int)
    p.add_argument("--accel", type=float, default=1.0)
    p.add_argument("--out", default="earth_spinup")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log", default=None)
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--run-id", default=None,
                   help="branch tag written to every log row "
                        "(default: PID+start time)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    run_id = args.run_id or "r%d-%d" % (os.getpid(), int(time.time()))

    from .config import earth_config
    from .coupler.driver import CoupledModel
    from .io.restart import load_restart, save_restart

    os.makedirs(args.out, exist_ok=True)
    logpath = args.log or os.path.join(args.out, "spinup_log.jsonl")
    m = CoupledModel(earth_config(accel=args.accel), topo_kind="earth",
                     device=args.device)
    state = m.init_state()
    year0 = 0
    ckpt = os.path.join(args.out, "restart.npz")
    meta = os.path.join(args.out, "restart_meta.json")
    if args.resume and os.path.exists(ckpt):
        state = load_restart(ckpt, state)
        with open(meta) as f:
            md = json.load(f)
        year0 = md["year"]
        m.relyr = md["relyr"]
        print(f"resumed at year {year0}", flush=True)

    def on_year(d, state):
        with open(logpath, "a") as f:
            f.write(json.dumps(d) + "\n")
        print(json.dumps(d), flush=True)
        if (d["year"] - year0) % args.save_every == 0 \
                or d["year"] == year0 + args.years:
            save_restart(ckpt, state)
            with open(meta, "w") as f:
                json.dump(dict(year=d["year"], relyr=m.relyr,
                               accel=args.accel), f)

    run_years(m, state, args.years, year0, accel=args.accel, run_id=run_id,
              on_year=on_year)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
