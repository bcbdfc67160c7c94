#!/usr/bin/env python3
"""The reference spin-up year of the earth model: ``spinup_earth_year.json``.

    python3 golden/regression/spinup_earth_year.py

runs the JAX package's spin-up driver, ``scripts/spinup_earth.py 1
--accel ACCEL --resume``, on the CPU from a copy of ``earth_accept/``
(the year-1060 restart and its ``restart_meta.json``), each run in a
process of its own (WORKERS at a time): in float64 (``jax_enable_x64``,
``earth_config`` given ``dtype="float64"``) once with the script's
rounding (the row the port's year is held to) and once without it, and
in float32 (the script's own configuration) without it, MEMBERS + 1
times: from the restart as it is and, for member k = 1..MEMBERS, from
the restart with each ocean temperature (``ocean/t`` and ``ocean/tm1``)
moved by one float32 unit in the last place up, down or not at all,
drawn from seed k.  The script logs the year's row (``yearly_diags``
with the energy audit): year 1061.

The float32 members measure how far round-off alone moves a year of
the accelerated model (its convection and sea ice amplify a difference
of one unit in the last place to the size of the float32-float64 gap),
so one float32 run is one sample of that spread, not its size.  Each
numeric key's limit is LIMIT_FACTOR x the float32-float64 gap, the
largest over the members, and never below one unit of the key's
rounding in the row (``ROUNDING``); a list is held element by element.
The gap is taken before the script's rounding (the script's ``round``
the identity): the rounding to one unit would make the gap of a key 0
or 1 unit where the two precisions differ by a fraction of one.
``year`` and ``accel`` must be equal; ``wall_s`` and ``run_id`` are not
held.  ``chip_smoke.spinup_out_of_limits`` applies the limits to the
port's year on the card (``chip_smoke.py`` phase 9).

    python3 golden/regression/spinup_earth_year.py --dtype float32 \
        --member K --out F [--unrounded]

runs one year and writes its row to F (the parent's children).

    python3 golden/regression/spinup_earth_year.py --port float32 \
        [--device cpu|cuda]

runs the PyTorch port's year (``uvic_tpu_torch.spinup.main``, the
script's ``round`` the identity) and prints each key's gap from the
JSON's unrounded float64 row beside its limit and beside the float32
members' gaps: a witness of the port's float32 arithmetic without the
card.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "spinup_earth_year.json")
SCRIPT = os.path.join(ROOT, "scripts", "spinup_earth.py")
START = os.path.join(ROOT, "earth_accept")
ACCEL = 4.0
LIMIT_FACTOR = 5.0
MEMBERS = 4          # float32 runs from a restart moved by round-off
WORKERS = 3          # runs at a time (each ~3-5 GB)
COMMAND = "python3 golden/regression/spinup_earth_year.py"
# digits each key of the row is rounded to (scripts/spinup_earth.py
# yearly_diags and main); a list key gives one entry per element
ROUNDING = dict(
    moc_res_max=1, moc_res_min=1, moc_res_max_loc=[1, 0],
    moc_res_min_loc=[1, 0], amoc_sv=1, sat_gm=3, sst_gm=3, toa_gm=3,
    ohf_gm=3, ice_nh_min=2, ice_nh_max=2, ice_sh_min=2, ice_sh_max=2,
    psi_max=1, psi_max_loc=[1, 1], acc_drake_sv=1, moc_max=1, moc_min=1,
    moc_max_exeq=1, moc_min_exeq=1, toa_z=[1] * 7, sat_z=[1] * 7,
    dE_wm2=3, toa_audit_resid_wm2=3)
EQUAL = ("year", "accel")
NOT_HELD = ("wall_s", "run_id")


def start_copy(dest, member=0):
    """Copy the restart and its meta (not the window log) into ``dest``;
    for ``member`` > 0 move each ocean temperature by one float32 unit
    in the last place up, down or not at all (seed ``member``)."""
    os.makedirs(dest, exist_ok=True)
    for name in ("restart.npz", "restart_meta.json"):
        shutil.copy(os.path.join(START, name), dest)
    if member:
        import numpy as np
        path = os.path.join(dest, "restart.npz")
        with np.load(path) as d:
            fields = {k: d[k] for k in d.files}
        t = fields["ocean/t"]
        step = np.random.default_rng(member).integers(-1, 2, t[0].shape)
        step = np.where(t[0] != 0, step, 0)
        for key in ("ocean/t", "ocean/tm1"):
            x = fields[key].astype(np.float32)
            x[0] = np.where(step > 0, np.nextafter(x[0], np.float32(np.inf)),
                            np.where(step < 0, np.nextafter(
                                x[0], np.float32(-np.inf)), x[0]))
            fields[key] = x.astype(fields[key].dtype)
        np.savez(path, **fields)


def load_script():
    """scripts/spinup_earth.py as a module, with its persistent
    compilation cache left off (it would write into the repo)."""
    import importlib.util

    import uvic_tpu
    uvic_tpu.enable_compile_cache = lambda *a, **k: None
    spec = importlib.util.spec_from_file_location("spinup_earth", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def year_row(dtype, unrounded=False, member=0):
    """The script's row of one accelerated year from the copy, in
    ``dtype``, and the seconds the year took; with ``unrounded`` the
    script's ``round`` is the identity, so that the row holds the
    quantities as computed."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import uvic_tpu.config as config

    script = load_script()
    if unrounded:
        script.round = lambda x, ndigits=None: x
    base = config.earth_config
    config.earth_config = lambda **kw: base(dtype=dtype, **kw)
    work = tempfile.mkdtemp(prefix="spinup_year_")
    try:
        start_copy(work, member)
        sys.argv = [SCRIPT, "1", "--accel", str(ACCEL), "--resume",
                    "--out", work, "--run-id", f"golden-{dtype}"]
        t0 = time.perf_counter()
        script.main()
        seconds = time.perf_counter() - t0
        with open(os.path.join(work, "spinup_log.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(work)
    if len(rows) != 1 or rows[0]["year"] != 1061:
        raise AssertionError(f"{dtype}: rows {rows}")
    return dict(row=rows[0], seconds=seconds)


def gap_of(a, b):
    """|a - b|, element by element for a list."""
    if isinstance(a, list):
        return [gap_of(x, y) for x, y in zip(a, b)]
    return abs(a - b)


def largest(gaps):
    """The element-wise largest of several gaps of one key."""
    if isinstance(gaps[0], list):
        return [largest(list(g)) for g in zip(*gaps)]
    return max(gaps)


def limit_of(gap, ndigits):
    if isinstance(ndigits, list):
        return [limit_of(g, n) for g, n in zip(gap, ndigits)]
    return max(LIMIT_FACTOR * gap, 10.0 ** -ndigits)


def share_of(gap, limit):
    """The largest share of a limit, over the elements of a list."""
    if isinstance(limit, list):
        return max(share_of(g, c) for g, c in zip(gap, limit))
    return gap / limit


def child(dtype, unrounded, member):
    """One year in a process of its own."""
    path = os.path.join(tempfile.gettempdir(), f"spinup_year_{dtype}_"
                        f"{int(unrounded)}_{member}_{os.getpid()}.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.abspath(__file__), "--dtype",
                    dtype, "--member", str(member), "--out", path]
                   + (["--unrounded"] if unrounded else []),
                   check=True, env=env, cwd=ROOT)
    with open(path) as f:
        out = json.load(f)
    os.remove(path)
    return out


def port_gaps(dtype, device):
    """The port's unrounded year against the JSON: each key's gap from
    the float64 row, its share of the limit and the members' largest
    share."""
    import torch
    sys.path.insert(0, ROOT)

    import uvic_tpu_torch.spinup as spinup
    if device == "cpu" and dtype == "float64":
        raise SystemExit("the port's float64 year is the tests' business")
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    spinup.round = lambda x, ndigits=None: x
    work = tempfile.mkdtemp(prefix="spinup_port_")
    try:
        start_copy(work)
        t0 = time.perf_counter()
        spinup.main(["1", "--accel", f"{ACCEL:g}", "--resume", "--out",
                     work, "--run-id", f"port-{dtype}", "--device", device])
        seconds = time.perf_counter() - t0
        with open(os.path.join(work, "spinup_log.jsonl")) as f:
            row = json.loads(f.readlines()[-1])
    finally:
        shutil.rmtree(work)
    with open(OUT) as f:
        golden = json.load(f)
    u64 = golden["unrounded_float64"]
    report = {}
    for key, lim in golden["limit"].items():
        gap = gap_of(row[key], u64[key])
        report[key] = dict(
            value=row[key], gap=gap, share=share_of(gap, lim),
            members_share=share_of(golden["gap_float32"][key], lim))
    print(json.dumps({"port": dtype, "device": device, "seconds": seconds,
                      "row": row, "keys": report}))
    return 0


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=["float32", "float64"])
    ap.add_argument("--unrounded", action="store_true")
    ap.add_argument("--member", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--port", choices=["float32", "float64"])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    if args.port:
        return port_gaps(args.port, args.device)
    if args.dtype:
        result = year_row(args.dtype, args.unrounded, args.member)
        with open(args.out, "w") as f:
            json.dump(result, f)
        return 0

    jobs = [("float64", False, 0), ("float64", True, 0)] + [
        ("float32", True, k) for k in range(MEMBERS + 1)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(WORKERS) as pool:
        runs = dict(zip(jobs, pool.map(lambda j: child(*j), jobs)))
    wall = time.perf_counter() - t0
    r64 = runs["float64", False, 0]["row"]
    u64 = runs["float64", True, 0]["row"]
    u32 = [runs["float32", True, k]["row"] for k in range(MEMBERS + 1)]
    for r in [u64] + u32:
        if list(r) != list(r64):
            raise AssertionError(f"keys differ: {list(r64)} {list(r)}")
        for key in EQUAL:
            if r[key] != r64[key]:
                raise AssertionError(f"{key} differs: {r64[key]} {r[key]}")
    held = [k for k in r64 if k not in EQUAL + NOT_HELD]
    if sorted(held) != sorted(ROUNDING):
        raise AssertionError(f"keys {held} against {sorted(ROUNDING)}")
    members = [{k: gap_of(r[k], u64[k]) for k in held} for r in u32]
    gaps = {k: largest([g[k] for g in members]) for k in held}
    limits = {k: limit_of(gaps[k], ROUNDING[k]) for k in held}
    out = dict(
        command=COMMAND,
        configuration=(
            f"scripts/spinup_earth.py 1 --accel {ACCEL:g} --resume from a "
            "copy of earth_accept/ (restart.npz, restart_meta.json: year "
            "1060); CoupledModel(earth_config(dtype, accel), "
            "topo_kind='earth'), 72 segments of 5 days; JAX package on "
            "the CPU"),
        members=(f"{MEMBERS + 1} float32 runs: the restart as it is, and "
                 f"{MEMBERS} with each ocean temperature moved by one "
                 "float32 unit in the last place up, down or not (seeds "
                 f"1-{MEMBERS})"),
        limit_rule=(f"{LIMIT_FACTOR:g} x |float32 - float64| of the key "
                    "as computed, before the script's rounding (of each "
                    "element of a list), the largest over the float32 "
                    "members, at least one unit of its rounding; "
                    f"{' and '.join(EQUAL)} equal; "
                    f"{' and '.join(NOT_HELD)} not held"),
        keys=list(r64), equal=list(EQUAL), rounding=ROUNDING, row=r64,
        unrounded_float64=u64, unrounded_float32=u32,
        gap_float32_members=members, gap_float32=gaps, limit=limits,
        year_s={d: runs[d, True, 0]["seconds"]
                for d in ("float64", "float32")},
        wall_s=wall)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT} in {wall:.0f} s: float64 row {json.dumps(r64)}; "
          f"float32 gaps {json.dumps(gaps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
