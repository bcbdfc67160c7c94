#!/usr/bin/env python3
"""The reference month of the earth carbon cycle: ``bgc_earth_month.json``.

    python3 golden/regression/bgc_earth_month.py

runs the JAX package on the CPU, twice, each in a process of its own:
``CoupledModel(earth_config(dtype).replace(bgc=mobi_full(),
sed=SedConfig(enabled=True, porewater=True), time=... year0=1990),
topo_kind="earth")`` from ``init_state()`` with
``set_transient_forcing()``, SEGMENTS segments of 5 days, in float64
(``jax_enable_x64``) and in float32 (without it: a float32 run with
transient forcing fails under x64, the EMBM's ``fori_loop`` carry turning
float64).  After each segment it takes ``chip_smoke.bgc_row`` of the
state and of the forcing the segment's ocean steps took (the output of
the reference's ``gosbc``, passed out of its jitted segment): each
tracer's volume and surface mean, the area integral of each tracer's
surface flux and of the bottom flux of dic and alk, the sediments' mean
calgg, orggg and zrct, nconv.

The JSON holds the float64 rows (the reference the card is held to), the
float32 rows, and each quantity's tolerance: 5x the largest gap between
the two over the month (``chip_smoke.bgc_gap``: relative to the value,
for a flux integral relative to the integral of the flux's magnitude),
and no less than FLOOR; nconv must be equal.  ``chip_smoke.py`` holds
the port's float32 month on the card to these rows.

    python3 golden/regression/bgc_earth_month.py --dtype float32 --out F

runs one precision and writes its rows to F (the parent's children).

    python3 golden/regression/bgc_earth_month.py --port float32 [--device D]

runs the PyTorch port's month (``chip_smoke.earth_bgc_model``, on the
CPU by default) and prints, against the JSON's float64 rows, each
kind's quantity nearest its limit and the rows out of limits: the
card's check of ``chip_smoke.py`` phase 8 without the card.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "bgc_earth_month.json")
SEGMENTS = 6
YEAR0 = 1990
FACTOR = 5.0
# the least tolerance of any quantity: ~8 float32 roundings, for the
# quantities where the two runs happened to agree closer than that
FLOOR = 1e-6
COMMAND = "python3 golden/regression/bgc_earth_month.py"


def month(dtype):
    """The rows of SEGMENTS segments of the JAX package in ``dtype``."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    import numpy as np

    sys.path.insert(0, ROOT)
    from chip_smoke import bgc_row, bgc_weights
    from uvic_tpu.config import SedConfig, earth_config, mobi_full
    from uvic_tpu.coupler.driver import CoupledModel

    cfg = earth_config(dtype=dtype)
    cfg = cfg.replace(bgc=mobi_full(),
                      sed=SedConfig(enabled=True, porewater=True),
                      time=dataclasses.replace(cfg.time, year0=YEAR0))
    m = CoupledModel(cfg, topo_kind="earth")
    m.set_transient_forcing()
    state = m.init_state()

    rec = {}
    gosbc, core = m.gosbc, m._segment_core

    def gosbc_rec(*a, **k):
        f = gosbc(*a, **k)
        rec["traced"] = (f.stf, f.btf)
        return f

    def core_rec(st, sc):
        new, diag = core(st, sc)
        diag["forcing"] = rec.pop("traced")
        return new, diag

    jitted = jax.jit(core_rec)

    def segment(st, sc):
        new, diag = jitted(st, sc)
        rec["stf"], rec["btf"] = (np.asarray(x) for x in diag.pop("forcing"))
        return new, diag

    m.gosbc = gosbc_rec
    m._segment_jit = segment
    names = [tr.name for tr in m.ocean.tracer_index.tracers]
    weights = bgc_weights(m.grid, m.ocean.tmask, m.area2d)
    rows, seconds = [], []
    for n in range(SEGMENTS):
        t0 = time.perf_counter()
        state = m.run(state, 1)
        jax.block_until_ready(state.ocean.t)
        seconds.append(time.perf_counter() - t0)
        sed = {k: np.asarray(getattr(state.sed, k))
               for k in ("calgg", "orggg", "zrct")}
        row = bgc_row(weights, names, state.ocean.t, rec["stf"], rec["btf"],
                      sed, state.ocean.nconv)
        row["days"] = 5.0 * (n + 1)
        rows.append(row)
        print(f"{dtype} segment {n + 1}: {seconds[-1]:.1f} s, cfc11 "
              f"(N, S) {m.cfcccn[0]:.1f} {m.cfcccn[1]:.1f} pptv",
              flush=True)
        if not all(np.isfinite(v) for v in row.values()):
            raise AssertionError(f"{dtype}: non-finite row {n + 1}")
    return dict(rows=rows, names=names, segment_s=seconds)


def port_gaps(dtype, device):
    """The port's month against the JSON: the quantity of each kind
    nearest its limit and the rows out of limits."""
    sys.path.insert(0, ROOT)
    from chip_smoke import (bgc_month_gaps, bgc_weights, earth_bgc_model,
                            port_bgc_row)
    from uvic_tpu_torch.coupler.driver import CHEM_DTYPE
    with open(OUT) as f:
        golden = json.load(f)
    m, state = earth_bgc_model(device=device, dtype=dtype)
    names = [tr.name for tr in m.ocean.tracer_index.tracers]
    weights = bgc_weights(m.grid, m.ocean.tmask.cpu().numpy(),
                          m.area2d.cpu().numpy())
    rows = []
    for n in range(len(golden["rows"])):
        state = m.run(state, 1)
        rows.append(port_bgc_row(m, weights, names, state))
        print(f"port {dtype} segment {n + 1} on {m.device}", flush=True)
    worst, failed = bgc_month_gaps(rows, golden)
    print(json.dumps({"port": dtype, "device": str(m.device),
                      "chem_dtype": str(CHEM_DTYPE), "nearest_limit": worst,
                      "out_of_limits": failed}))
    return 1 if failed else 0


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=["float32", "float64"])
    ap.add_argument("--out")
    ap.add_argument("--port", choices=["float32", "float64"])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    if args.port:
        return port_gaps(args.port, args.device)
    if args.dtype:
        with open(args.out, "w") as f:
            json.dump(month(args.dtype), f)
        return 0

    sys.path.insert(0, ROOT)
    from chip_smoke import bgc_gap
    runs = {}
    for dtype in ("float64", "float32"):
        path = os.path.join(HERE, f".bgc_month_{dtype}.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--dtype", dtype, "--out", path], check=True,
                       env=env, cwd=ROOT)
        with open(path) as f:
            runs[dtype] = json.load(f)
        os.remove(path)
    ref, f32 = runs["float64"]["rows"], runs["float32"]["rows"]
    gaps = {}
    for r64, r32 in zip(ref, f32):
        if r64["nconv"] != r32["nconv"]:
            raise AssertionError(f"nconv differs at day {r64['days']}")
        for key in r64:
            if key.split("/")[0] in ("vol", "surf", "stf", "btf", "sed"):
                gap = bgc_gap(key, r32[key], r64)
                gaps[key] = max(gaps.get(key, 0.0), gap)
    tol = {k: max(FACTOR * g, FLOOR) for k, g in gaps.items()}
    out = dict(
        command=COMMAND,
        configuration=(
            "CoupledModel(earth_config(dtype).replace(bgc=mobi_full(), "
            "sed=SedConfig(enabled=True, porewater=True), time=year0 "
            f"{YEAR0}), topo_kind='earth'), init_state(), "
            f"set_transient_forcing(); {SEGMENTS} segments of 5 days"),
        gap=("chip_smoke.bgc_gap: relative to the value; for stf/ and btf/ "
             "relative to the integral of the flux's magnitude "
             "(stf_abs/, btf_abs/)"),
        tolerance_rule=(f"{FACTOR:g} x the largest float32-float64 gap of "
                        f"the month, at least {FLOOR:g}; nconv equal"),
        names=runs["float64"]["names"],
        gap_float32=gaps, tolerance=tol, rows=ref, rows_float32=f32,
        segment_s={k: v["segment_s"] for k, v in runs.items()})
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:8]
    print(f"wrote {OUT}; largest float32 gaps {worst}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
