#!/usr/bin/env python3
"""The reference restoring year of the flagship ocean: ``restoring_year.json``.

    python3 golden/regression/restoring_year.py

runs the JAX package's ocean-only restoring driver,
``OceanModel.run_restoring``, on the CPU: the flagship of
``__graft_entry__._flagship`` (102x102x19, two tracers, primed with one
forward step) restored toward the seasonal climatology of
``io/timeforce.default_surface_climatology`` under the flagship's wind
stress, SEGMENTS segments of SEG_DAYS days (24 ocean steps each), one
call a segment with ``relyr0`` accumulated as ``run_restoring``
accumulates it.  After each segment it takes ``chip_smoke.restoring_row``
of the state (the CG iterations of the segment's steps are read by a
``jax.debug.callback`` around the model's ``tropic_step``; nothing of the
JAX package changes).  Each run is a process of its own (WORKERS at a
time): in float64 (``jax_enable_x64``) once, the rows the port is held
to, and in float32 MEMBERS + 1 times: from the primed state as it is
and, for member k = 1..MEMBERS, with each ocean temperature (``t`` and
``tm1``) moved by one float32 unit in the last place up, down or not at
all, drawn from seed k.

The float32 members measure how far round-off alone moves the year, so
one float32 run is one sample of that spread, not its size.  Each
segment's limit of each key is LIMIT_FACTOR x that segment's
float32-float64 gap, the largest over the members, and never below the
key's FLOOR; the mean CG iterations' limit is that segment's largest
gap plus FLOOR["cg_iters"], the iterations by which the card's CG may
differ from its plain version on one solve; nconv must be equal.  Each
member is also held to the limits built from the other members alone
(``leave_one_out`` in the JSON: each key's largest share of its limit).
``chip_smoke.restoring_gaps`` applies the limits to the port's year on
the card (``chip_smoke.py`` phase 10).

    python3 golden/regression/restoring_year.py --dtype float32 \\
        --member K --out F

runs one year and writes its rows to F (the parent's children).

    python3 golden/regression/restoring_year.py --port float32 \
        [--device cpu|cuda]

runs the PyTorch port's year the same way (``uvic_tpu_torch.entry.
_flagship``) and prints, as one JSON line, each segment's gap from the
float64 row beside the float32 members' largest gap, each key's largest
share of its limit and the rows out of limits: a witness of the port's
float32 arithmetic with the card's kernels or, on the CPU, their plain
versions.

    python3 golden/regression/restoring_year.py --steps N

steps the first segment's restoring forcing N times in the port's
float32 on the CPU and, from each state of that trajectory, takes one
float32 step of the port, of the port with its implicit vertical
diffusion and its convection applied to the tracer's whole value (the
forms before their increment forms), and of the JAX package, each
against the port's float64 step from the same state: one JSON line a
step with the error of the mean SST and of the volume-mean T [K] and
the CG iterations of each.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "restoring_year.json")
LIMIT_FACTOR = 5.0
MEMBERS = 8          # float32 runs from a state moved by round-off
WORKERS = 3          # runs at a time
COMMAND = "python3 golden/regression/restoring_year.py"
# the least limit of each key: ~10 float32 units of the quantity for the
# surface means and psi [degC, psu, Sv]; for the volume means, which
# average ~1.6e5 cells, ~10 units of the mean itself (3.3 degC; 1e-7 psu),
# so that the members' spread, not the floor, sets their limits; for the
# mean CG iterations a step, the 3 iterations by which the card's CG may
# differ from its plain version on one solve (chip_smoke.check_cg)
FLOOR = dict(sst=1e-5, sss=1e-6, sst_gap=1e-5, sss_gap=1e-6, tbar=2e-6,
             sbar=1e-7, psi_max=1e-3, psi_min=1e-3, cg_iters=3.0)


def moved(x, member):
    """The float32 temperatures x[0] (t or tm1) moved by one unit in the
    last place up, down or not at all on ocean cells (seed ``member``)."""
    import numpy as np
    x = np.array(x, np.float32)
    step = np.random.default_rng(member).integers(-1, 2, x[0].shape)
    step = np.where(x[0] != 0, step, 0)
    x[0] = np.where(step > 0, np.nextafter(x[0], np.float32(np.inf)),
                    np.where(step < 0, np.nextafter(x[0], np.float32(-np.inf)),
                             x[0]))
    return x


def year_rows(dtype, member=0):
    """The rows of one restoring year in ``dtype`` and the seconds the
    year took."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import jax.numpy as jnp

    import __graft_entry__ as entry
    import uvic_tpu.models.ocean.model as model_mod
    from chip_smoke import (restoring_row, restoring_weights,
                            restoring_year_rows)
    from uvic_tpu.io.timeforce import default_surface_climatology

    iters = []
    tropic = model_mod.tropic_step

    def counted(*a, **k):
        out = tropic(*a, **k)
        jax.debug.callback(lambda it: iters.append(int(it)), out[4])
        return out

    model_mod.tropic_step = counted
    m, state, forcing = entry._flagship(dtype=dtype)
    if member:
        state = state.replace(t=jnp.asarray(moved(state.t, member)),
                              tm1=jnp.asarray(moved(state.tm1, member)))
    sst, sss = default_surface_climatology(m.params.grid,
                                           dtype=m.cfg.np_dtype)
    weights = restoring_weights(m.params.grid, m.tmask)

    def sync(state):
        if state is None:
            jax.effects_barrier()
            iters.clear()
        else:
            jax.block_until_ready(state)
            jax.effects_barrier()

    def row(state, mid):
        return restoring_row(weights, state.t, state.psi0, sst(mid),
                             sss(mid), list(iters), state.nconv)

    rows, seg_s, _, _ = restoring_year_rows(m, state, forcing.smf, sst, sss,
                                            row, sync)
    return dict(rows=rows, seconds=sum(seg_s))


def port_gaps(dtype, device):
    """The port's year (``uvic_tpu_torch``, float32) against the JSON:
    each segment's gap from the float64 row beside the members' largest
    gap and the limit, and each key's largest share of its limit."""
    import torch
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from chip_smoke import (port_restoring_row, restoring_gaps,
                            restoring_weights, restoring_year_rows)
    from uvic_tpu_torch.entry import _flagship
    from uvic_tpu_torch.io.timeforce import default_surface_climatology
    if dtype != "float32":
        raise SystemExit("the port's float64 year is the tests' business")
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    with open(OUT) as f:
        golden = json.load(f)
    m, state, forcing = _flagship(device=device, dtype=dtype)
    sst, sss = default_surface_climatology(m.params.grid,
                                           dtype=m.cfg.np_dtype,
                                           device=m.device)
    weights = restoring_weights(m.params.grid, m.tmask.cpu().numpy())

    def row(state, mid):
        return port_restoring_row(m, weights, state, sst, sss, mid)

    def sync(state):
        if m.device.type == "cuda":
            torch.cuda.synchronize()

    rows, seg_s, _, _ = restoring_year_rows(m, state, forcing.smf, sst, sss,
                                            row, sync)
    seconds = sum(seg_s)
    gaps = [{k: [abs(row[k] - ref[k]), golden["gap_float32"][n][k]]
             for k in golden["limit"][n]}
            for n, (row, ref) in enumerate(zip(rows, golden["rows"]))]
    worst, failed = restoring_gaps(rows, golden)
    print(json.dumps({"port": dtype, "device": device, "seconds": seconds,
                      "rows": rows, "gap_and_members_gap": gaps,
                      "worst_share": worst, "out_of_limits": failed}))
    return 0


def member_gaps(r64, r32, held):
    """Each segment's largest |float32 - float64| of each key over the
    float32 members ``r32``."""
    return [{k: max(abs(rows[n][k] - r64[n][k]) for rows in r32)
             for k in held} for n in range(len(r64))]


def limits_of(gaps):
    """Each segment's limits from its members' gaps (the limit rule)."""
    return [{k: (g + FLOOR[k] if k == "cg_iters"
                 else max(LIMIT_FACTOR * g, FLOOR[k]))
             for k, g in seg.items()} for seg in gaps]


def step_errors(nsteps):
    """``--steps``: one float32 step of the port, of the port with the
    whole-value forms, and of the JAX package from each state of the
    port's float32 trajectory, against the port's float64 step."""
    import jax
    import numpy as np
    import torch
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import jax.numpy as jnp

    import __graft_entry__ as entry
    import uvic_tpu.models.ocean.model as j_model_mod
    import uvic_tpu_torch.ops.convection as convection
    import uvic_tpu_torch.ops.tracer_kernel as tracer_kernel
    from chip_smoke import (RESTORING_SEG_DAYS, RESTORING_YRLEN,
                            restoring_weights)
    from uvic_tpu_torch.convert import (ocean_state_from_numpy,
                                        ocean_state_to_numpy)
    from uvic_tpu_torch.entry import _flagship
    from uvic_tpu_torch.io.timeforce import default_surface_climatology
    from uvic_tpu_torch.models.ocean.model import make_forcing
    from uvic_tpu_torch.ops.tridiag import solve_tridiag_masked

    def invtri_whole(z, topbc, botbc, dcb, tdt, kmz, mask, dztr, dztur,
                     dztlr, aidif):
        """invtri.F solved for z itself, column by column."""
        n, km = z.shape[:2]
        out = []
        for q in range(n):
            t = tdt.reshape(km, 1, 1)
            a = -torch.cat([dcb[:1], dcb[:-1]]) * (dztur.reshape(km, 1, 1)
                                                   * t * aidif) * mask
            c = -dcb * (dztlr.reshape(km, 1, 1) * t * aidif) \
                * torch.cat([mask[1:], mask[-1:]])
            a[0], c[-1] = 0.0, 0.0
            f = z[q] * mask
            f[0] = f[0] + topbc[q] * t[0] * dztr[0] * aidif * mask[0]
            lev = torch.arange(km).reshape(km, 1, 1)
            bot = lev == torch.clamp(kmz - 1, min=1)[None]
            f = f - torch.where(bot, botbc[q][None] * t
                                * dztr.reshape(km, 1, 1) * aidif * mask,
                                torch.zeros_like(f))
            out.append(solve_tridiag_masked(a, 1.0 - a - c, c, f, mask))
        return torch.stack(out)

    def apply_whole(ts, mnorm, ocean):
        """sum_l M[k, l] ts[n, l] on ocean cells."""
        out = mnorm[:, 0][None] * ts[:, 0][:, None]
        for q in range(1, ts.shape[1]):
            out = out + mnorm[:, q][None] * ts[:, q][:, None]
        return torch.where(ocean[None] > 0, out, ts)

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    m64 = _flagship(device="cpu", dtype="float64")[0]
    m32, s32, f32 = _flagship(device="cpu", dtype="float32")
    jm, js, _ = entry._flagship(dtype="float32")
    g = m32.params.grid
    dvol, area = restoring_weights(g, m32.tmask.numpy())
    sst, sss = default_surface_climatology(g, dtype=np.float32,
                                           device="cpu")
    mid = 0.5 * RESTORING_SEG_DAYS / RESTORING_YRLEN
    forcing = m32.apply_restoring(
        make_forcing(f32.smf, torch.zeros_like(f32.stf), relyr=mid), s32,
        sst, sss, relyr=mid)
    f64 = make_forcing(forcing.smf.double(), forcing.stf.double(),
                       relyr=mid)
    jf = j_model_mod.make_forcing(jnp.asarray(forcing.smf.numpy()),
                                  jnp.asarray(forcing.stf.numpy()),
                                  relyr=jnp.asarray(mid, jnp.float32))

    def errors(t, ref):
        d = np.asarray(t, np.float64) - ref
        return [float((d[0, 0] * area).sum() / area.sum()),
                float((d[0] * dvol).sum() / dvol.sum())]

    state = s32
    for n in range(nsteps):
        d = ocean_state_to_numpy(state)
        ref = m64.run_scan(ocean_state_from_numpy(d, "cpu", torch.float64),
                           f64, 1).t.numpy()
        row = {"step": n + 1}
        for name, solve, apply in (
                ("port", tracer_kernel.invtri_columns,
                 convection.apply_region_means),
                ("port_whole_value", invtri_whole, apply_whole)):
            saved = tracer_kernel.invtri_columns, convection.apply_region_means
            tracer_kernel.invtri_columns = solve
            convection.apply_region_means = apply
            try:
                out = m32.run_scan(ocean_state_from_numpy(d, "cpu",
                                                          torch.float32),
                                   forcing, 1)
            finally:
                (tracer_kernel.invtri_columns,
                 convection.apply_region_means) = saved
            row[name] = errors(out.t.numpy(), ref) + [
                int(m32.scan_cg_iters[0])]
        jstate = js.replace(
            **{k: jnp.asarray(d[k]) for k in ("tm1", "t", "um1", "u", "psi0",
                                             "psi1", "ptd", "ptdb", "ubar",
                                             "ubarm1")},
            itt=jnp.asarray(d["itt"]), nconv=jnp.asarray(d["nconv"]))
        row["jax"] = errors(jm.run_scan(jstate, jf, 1).t, ref)
        print(json.dumps(row), flush=True)
        state = m32.run_scan(state, forcing, 1)
    return 0


def child(dtype, member):
    """One year in a process of its own."""
    path = os.path.join(tempfile.gettempdir(), f"restoring_year_{dtype}_"
                        f"{member}_{os.getpid()}.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.abspath(__file__), "--dtype",
                    dtype, "--member", str(member), "--out", path],
                   check=True, env=env, cwd=ROOT)
    with open(path) as f:
        out = json.load(f)
    os.remove(path)
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=["float32", "float64"])
    ap.add_argument("--member", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--port", choices=["float32", "float64"])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--steps", type=int)
    args = ap.parse_args(argv)
    if args.steps:
        return step_errors(args.steps)
    if args.port:
        return port_gaps(args.port, args.device)
    if args.dtype:
        result = year_rows(args.dtype, args.member)
        with open(args.out, "w") as f:
            json.dump(result, f)
        return 0

    jobs = [("float64", 0)] + [("float32", k) for k in range(MEMBERS + 1)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(WORKERS) as pool:
        runs = dict(zip(jobs, pool.map(lambda j: child(*j), jobs)))
    wall = time.perf_counter() - t0
    r64 = runs["float64", 0]["rows"]
    r32 = [runs["float32", k]["rows"] for k in range(MEMBERS + 1)]
    keys = list(r64[0])
    held = [k for k in keys if k != "nconv"]
    if sorted(held) != sorted(FLOOR):
        raise AssertionError(f"keys {held} against {sorted(FLOOR)}")
    for rows in r32:
        for n, (row, ref) in enumerate(zip(rows, r64)):
            if list(row) != keys or row["nconv"] != ref["nconv"]:
                raise AssertionError(f"segment {n + 1}: {row} against {ref}")
    gaps = member_gaps(r64, r32, held)
    limits = limits_of(gaps)
    loo = {}
    for i in range(len(r32)):
        others = limits_of(member_gaps(r64, r32[:i] + r32[i + 1:], held))
        for n, (row, ref) in enumerate(zip(r32[i], r64)):
            for k in held:
                share = abs(row[k] - ref[k]) / others[n][k]
                loo[k] = max(loo.get(k, 0.0), share)
    sys.path.insert(0, ROOT)
    from chip_smoke import RESTORING_SEG_DAYS, RESTORING_SEGMENTS
    out = dict(
        command=COMMAND,
        configuration=(
            "__graft_entry__._flagship(dtype) (102x102x19, nt=2, primed with "
            "one forward step), OceanModel.run_restoring(state, smf, sst, "
            "sss, nseg=1, relyr0) once a segment, relyr0 += seg_days / 365; "
            f"{RESTORING_SEGMENTS} segments of {RESTORING_SEG_DAYS:g} days "
            "(24 steps at dtts 108000 s), the seasonal climatology of "
            "io.timeforce.default_surface_climatology, smf of "
            "__graft_entry__._wind; JAX package on the CPU"),
        members=(f"{MEMBERS + 1} float32 runs: the primed state as it is, "
                 f"and {MEMBERS} with each ocean temperature (t, tm1) moved "
                 "by one float32 unit in the last place up, down or not "
                 f"(seeds 1-{MEMBERS})"),
        limit_rule=(f"each segment and key: {LIMIT_FACTOR:g} x |float32 - "
                    "float64|, the largest over the float32 members in that "
                    "segment, at least the key's floor; cg_iters: that "
                    "largest gap plus its floor; nconv equal"),
        keys=keys, floor=FLOOR, rows=r64, rows_float32=r32,
        gap_float32=gaps, limit=limits, leave_one_out=loo,
        year_s={"float64": runs["float64", 0]["seconds"],
                "float32": runs["float32", 0]["seconds"]},
        wall_s=wall)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT} in {wall:.0f} s; float64 year "
          f"{out['year_s']['float64']:.1f} s, float32 "
          f"{out['year_s']['float32']:.1f} s; last row "
          f"{json.dumps(r64[-1])}; each member against the others' limits, "
          f"the largest share {json.dumps(loo)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
