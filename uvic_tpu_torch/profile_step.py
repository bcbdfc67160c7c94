"""Where the flagship ocean step's, or the earth segment's, time goes on
the card.

    python3 -m uvic_tpu_torch.profile_step [--steps N] [--mobi] [--graph]
    python3 -m uvic_tpu_torch.profile_step --earth [--steps N] [--graph]

Builds the flagship ocean (102x102x19, float32) on the card: nt=2, or
with ``--mobi`` the full-MOBI suite (nt=41).  Takes a few warm leapfrog
steps, times N more without the profiler, then profiles N more with
``torch.profiler`` (CPU and CUDA activities).  The steps are eager
``m.step`` calls, or with ``--graph`` one ``m.run_scan`` call of N steps
(CUDA-graph replays; the graphs are captured during the warm-up).
Prints the card's ``name, power.limit``, the host wall time per step
with and without the profiler, the summed device kernel time per step
(busy), the idle share ``1 - busy / wall`` against the wall time without
the profiler (the profiler's own host overhead lengthens the profiled
steps), the number of kernel launches per step, the top device-time
entries and the profiler's table.

With ``--earth`` a "step" is a segment of the coupled earth model
(``entry._earth`` from ``--restart``, float32): eager ``m.run(...,
eager=True)`` segments, or with ``--graph`` replayed ones; eager, the
device kernels and their time are also split by the profiler ranges the
segment names (the EMBM solves, the EVP dynamics, and each stage).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .entry import _earth, _flagship

EARTH_RANGES = ("embm_solve", "evp_dynamics", "stage_head", "stage_atm",
                "stage_mid", "stage_ocean", "stage_tail")


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def by_range(events, names=EARTH_RANGES):
    """{range: [device kernels, device us]}: each launch counted under
    the innermost of ``names`` that encloses the operation launching it
    ("other" outside them all)."""
    out = {}
    for e in events:
        ks = getattr(e, "kernels", None)
        if not ks:
            continue
        p, name = e, "other"
        while p is not None:
            if p.name in names:
                name = p.name
                break
            p = p.cpu_parent
        c = out.setdefault(name, [0, 0.0])
        c[0] += len(ks)
        c[1] += sum(k.duration for k in ks)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--mobi", action="store_true",
                    help="the full-MOBI flagship (nt=41)")
    ap.add_argument("--graph", action="store_true",
                    help="replayed steps (run_scan) instead of eager ones")
    ap.add_argument("--earth", action="store_true",
                    help="segments of the coupled earth model")
    ap.add_argument("--restart", default="earth_accept/restart.npz",
                    help="the earth model's restart (with --earth)")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    n = args.steps
    if args.earth:
        m, state = _earth(args.restart)

        def steps(state):
            """n segments and the last one's CG iterations."""
            state = m.run(state, n, eager=not args.graph)
            return state, m.seg_cg_iters.tolist()
    else:
        m, state, forcing = _flagship(small=False, mobi=args.mobi)

    def flagship_steps(state):
        """n leapfrog steps (the schedule's first mixing step is at
        itt = nmix), and each step's CG iterations."""
        if args.graph:
            state = m.run_scan(state, forcing, n)
            return state, m.scan_cg_iters.tolist()
        iters = []
        for _ in range(n):
            state = m.step(state, forcing, leapfrog=True)
            iters.append(int(m.last_cg_iters))
        return state, iters

    if not args.earth:
        steps = flagship_steps
        if state.itt + 3 * n > m.cfg.ocean.nmix:
            raise ValueError(f"--steps {n}: the run would reach a mixing "
                             "step")
    t0 = time.perf_counter()
    state, _ = steps(state)                    # warm-up (and the capture)
    torch.cuda.synchronize()
    print(f"warm-up {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    state, _ = steps(state)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / n

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, iters = steps(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n

    events = prof.events()
    # device activities, without the named ranges' own spans
    kernels = [e for e in events
               if getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type)
               and not getattr(e, "is_user_annotation", False)
               and e.name not in EARTH_RANGES]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / n
    kind = "replayed" if args.graph else "eager"
    what = ("earth segments" if args.earth
            else f"nt={m.nt} leapfrog steps")
    print(f"profiled {n} {kind} {what}, CG iterations {iters}")
    print(f"wall per step: profiler off {plain_wall_ms:.3f} ms, "
          f"profiler on {wall_ms:.3f} ms")
    print(f"device kernel time per step {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / plain_wall_ms:.3f} (profiler off; "
          f"{1.0 - busy_ms / wall_ms:.3f} against the profiled steps)")
    print(f"device kernels per step {len(kernels) / n:.1f}")
    if args.earth and not args.graph:
        print("device kernels and ms per segment by range:")
        for name, (count, us) in sorted(by_range(events).items()):
            print(f"  {name:14s} {count / n:10.1f} {us / 1e3 / n:10.3f}")
    avg = sorted(prof.key_averages(), key=_device_us, reverse=True)
    print("top device time per step (ms):")
    for e in avg[:15]:
        us = _device_us(e)
        if us <= 0:
            break
        print(f"  {us / 1e3 / n:8.4f}  x{e.count // n:6d}  {e.key[:90]}")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25, max_name_column_width=60))
    print(card)


if __name__ == "__main__":
    main()
