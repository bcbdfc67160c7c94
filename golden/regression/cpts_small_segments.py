#!/usr/bin/env python3
"""The JAX package's own float32 gap on the multi-category sea-ice run:
``cpts_small_segments.json``.

    python3 golden/regression/cpts_small_segments.py

runs the configuration of ``tests/test_cpts.py::test_coupled_cpts_segments``
(``chip_smoke.cpts_small_config``: ``small_config`` with ``ice.cpts =
3``, ``nlay = 4``, no isopycnal mixing, dtts 12 h; its cold-pole initial
temperature, ``chip_smoke.cpts_small_initial_t``) for SEGMENTS
segments of 5 days with the JAX package on the CPU, twice, each in a
process of its own: in float64 (``jax_enable_x64``) and in float32.  For
every field of the coupled state (the restart's keys) it stores the gap
between the two, max |f32 - f64| over max |f64|
(``chip_smoke.field_gap``), and the limit ``chip_smoke.py`` holds the
port's float32 run on the card to against its float64 run on the CPU:
LIMIT_FACTOR x that gap, and no less than FLOOR; the integer fields
(counters) must be equal.

    python3 golden/regression/cpts_small_segments.py --dtype float32 --out F

runs one precision and writes its state to F (an .npz; the parent's
children).

    python3 golden/regression/cpts_small_segments.py --trips

prints, for the JAX package's and the port's runs on the CPU in both
precisions (a process each), the barotropic CG's trips at each ocean
step and each solve's first-trip step over tolrsf (one trip ends the
solve where it is below 1), and the port's float32 barotropic gaps over
their limits.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "cpts_small_segments.json")
SEGMENTS = 4
LIMIT_FACTOR = 5.0
# the least limit of any field: ~8 float32 roundings
FLOOR = 1e-6
COMMAND = "python3 golden/regression/cpts_small_segments.py"


def run(dtype):
    """The JAX package's state after SEGMENTS segments, under the
    restart's keys, and the seconds it took."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    sys.path.insert(0, ROOT)
    from chip_smoke import cpts_small_config, cpts_small_initial_t
    from uvic_tpu.config import small_config
    from uvic_tpu.coupler.driver import CoupledModel
    from uvic_tpu.io.restart import _flatten_state

    m = CoupledModel(cpts_small_config(small_config()).replace(dtype=dtype))
    t0 = time.perf_counter()
    state = m.run(m.init_state(cpts_small_initial_t(m.grid, m.topo.tmask)),
                  SEGMENTS)
    jax.block_until_ready(state.ocean.t)
    return _flatten_state(state), time.perf_counter() - t0


def jax_trips(dtype):
    """The barotropic CG's trips of each ocean step of the JAX package's
    run in ``dtype``, and each solve's first-trip step over tolrsf (the
    solve stops after one trip where it is below 1)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    sys.path.insert(0, ROOT)
    import uvic_tpu.models.ocean.model as ocean_model
    import uvic_tpu.models.ocean.tropic as tropic
    from chip_smoke import cpts_small_config, cpts_small_initial_t
    from uvic_tpu.config import small_config
    from uvic_tpu.coupler.driver import CoupledModel

    step, solve = ocean_model.tropic_step, tropic.congrad
    trips, first = [], []

    def counted(*args, **kw):
        out = step(*args, **kw)
        jax.debug.callback(lambda n: trips.append(int(n)), out[4],
                           ordered=True)
        return out

    def first_trip(cf, guess, forc, isl, tol, max_iter, cyclic=True):
        est = solve(cf, guess, forc, isl, tol, 1, cyclic)[2]
        jax.debug.callback(lambda e: first.append(float(e) / tol), est,
                           ordered=True)
        return solve(cf, guess, forc, isl, tol, max_iter, cyclic)

    ocean_model.tropic_step, tropic.congrad = counted, first_trip
    m = CoupledModel(cpts_small_config(small_config()).replace(dtype=dtype))
    state = m.run(m.init_state(cpts_small_initial_t(m.grid, m.topo.tmask)),
                  SEGMENTS)
    jax.block_until_ready(state.ocean.t)
    jax.effects_barrier()
    return trips, first


def port_trips(dtype):
    """The same for the PyTorch port's run on the CPU, with the port's
    state (the restart's keys)."""
    import torch
    sys.path.insert(0, ROOT)
    import uvic_tpu_torch.ops.cg_kernel as cg_kernel
    from chip_smoke import (cpts_small_config, cpts_small_initial_t,
                            port_cg_trips)
    from uvic_tpu_torch.config import small_config
    from uvic_tpu_torch.convert import coupled_state_to_numpy
    from uvic_tpu_torch.coupler.driver import CoupledModel
    torch.set_num_threads(1)
    solve, first = cg_kernel.congrad, []

    def first_trip(cf, guess, forc, isl, tol, max_iter, cyclic=True):
        first.append(solve(cf, guess, forc, isl, tol, 1, cyclic)[2] / tol)
        return solve(cf, guess, forc, isl, tol, max_iter, cyclic)

    cg_kernel.congrad = first_trip
    m = CoupledModel(cpts_small_config(small_config()).replace(
        dtype=dtype), device="cpu")
    t0 = cpts_small_initial_t(m.grid, m.topo.tmask)
    state, trips = port_cg_trips(m, m.init_state(t0), SEGMENTS)
    return trips, first, coupled_state_to_numpy(state)


def trips_table():
    """Each run's CG trips by ocean step and first-trip step over
    tolrsf, the JAX package's and the port's (on the CPU) in both
    precisions, and the port's float32 barotropic gaps over their
    limits."""
    sys.path.insert(0, ROOT)
    from chip_smoke import CPTS_BAROTROPIC, field_gap
    with open(OUT) as f:
        golden = json.load(f)
    runs = {}
    for pkg in ("jax", "port"):
        for dtype in ("float64", "float32"):
            path = os.path.join(tempfile.gettempdir(), f"cpts_trips_{pkg}_"
                                f"{dtype}_{os.getpid()}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--trips", pkg, "--dtype", dtype, "--out",
                            path], check=True, cwd=ROOT,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
            with np.load(path) as d:
                runs[pkg, dtype] = {k: d[k] for k in d.files}
            os.remove(path)
    out = {}
    for (pkg, dtype), r in runs.items():
        out[f"{pkg} {dtype} trips"] = r.pop("__trips").tolist()
        out[f"{pkg} {dtype} first-trip step / tolrsf"] = [
            round(float(x), 3) for x in r.pop("__first")]
    s64, s32 = runs["port", "float64"], runs["port", "float32"]
    out["port float32 barotropic gap / limit"] = {
        k: field_gap(s32[k], s64[k]) / golden["limit"][k]
        for k in CPTS_BAROTROPIC}
    print(json.dumps(out))
    return 0


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=["float32", "float64"])
    ap.add_argument("--out")
    ap.add_argument("--trips", nargs="?", const="all",
                    choices=["all", "jax", "port"])
    args = ap.parse_args(argv)
    if args.trips == "all":
        return trips_table()
    if args.trips == "jax":
        trips, first = jax_trips(args.dtype)
        np.savez(args.out, __trips=np.asarray(trips),
                 __first=np.asarray(first))
        return 0
    if args.trips == "port":
        trips, first, state = port_trips(args.dtype)
        np.savez(args.out, __trips=np.asarray(trips),
                 __first=np.asarray(first), **state)
        return 0
    if args.dtype:
        state, seconds = run(args.dtype)
        np.savez(args.out, __seconds=np.asarray(seconds), **state)
        return 0

    sys.path.insert(0, ROOT)
    from chip_smoke import field_gap
    runs = {}
    for dtype in ("float64", "float32"):
        path = os.path.join(tempfile.gettempdir(),
                            f"cpts_small_{dtype}_{os.getpid()}.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--dtype", dtype, "--out", path], check=True,
                       env=env, cwd=ROOT)
        with np.load(path) as d:
            runs[dtype] = {k: d[k] for k in d.files}
        os.remove(path)
    r64, r32 = runs["float64"], runs["float32"]
    seconds = {k: float(v.pop("__seconds")) for k, v in runs.items()}
    if set(r64) != set(r32):
        raise AssertionError(f"keys differ: {set(r64) ^ set(r32)}")
    equal, gaps = [], {}
    for k in sorted(r64):
        if r64[k].dtype.kind == "i":
            if not np.array_equal(r64[k], r32[k]):
                raise AssertionError(f"{k} differs: {r64[k]} {r32[k]}")
            equal.append(k)
        else:
            gaps[k] = field_gap(r32[k], r64[k])
    limits = {k: max(LIMIT_FACTOR * g, FLOOR) for k, g in gaps.items()}
    out = dict(
        command=COMMAND,
        configuration=(
            "tests/test_cpts.py::test_coupled_cpts_segments: "
            "small_config(), ice.cpts 3, nlay 4, isopycmix off, dtts 12 h, "
            f"the cold-pole initial temperature; {SEGMENTS} segments of 5 "
            "days; JAX package on the CPU"),
        gap_rule="max |float32 - float64| / max |float64| of each field",
        limit_rule=(f"{LIMIT_FACTOR:g} x the JAX package's float32 gap, at "
                    f"least {FLOOR:g}; the integer fields equal"),
        segments=SEGMENTS, equal=equal, gap_float32=gaps, limit=limits,
        seconds=seconds)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {OUT}: gaps {json.dumps(gaps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
