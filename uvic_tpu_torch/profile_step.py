"""Where the flagship ocean step's time goes on the card.

    python3 -m uvic_tpu_torch.profile_step [--steps N]

Builds the flagship ocean (102x102x19, nt=2, float32) on the card, takes
a few warm leapfrog steps, times N more without the profiler, then
profiles N more with ``torch.profiler`` (CPU and CUDA activities).
Prints the card's ``name, power.limit``, the host wall time per step
with and without the profiler, the summed device kernel time per step
(busy), the idle share ``1 - busy / wall`` against the wall time without
the profiler (the profiler's own host overhead lengthens the profiled
steps), the number of kernel launches per step, the top device-time
entries and the profiler's table.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .entry import _flagship


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    m, state, forcing = _flagship(small=False)
    for _ in range(3):
        state = m.step(state, forcing, leapfrog=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state = m.step(state, forcing, leapfrog=True)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iters = []
        for _ in range(args.steps):
            state = m.step(state, forcing, leapfrog=True)
            iters.append(m.last_cg_iters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    events = prof.events()
    kernels = [e for e in events
               if getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type)]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.steps
    print(f"profiled {args.steps} leapfrog steps, CG iterations "
          f"{[int(i) for i in iters]}")
    print(f"wall per step: profiler off {plain_wall_ms:.3f} ms, "
          f"profiler on {wall_ms:.3f} ms")
    print(f"device kernel time per step {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / plain_wall_ms:.3f} (profiler off; "
          f"{1.0 - busy_ms / wall_ms:.3f} against the profiled steps)")
    print(f"device kernels per step {len(kernels) / args.steps:.1f}")
    avg = sorted(prof.key_averages(), key=_device_us, reverse=True)
    print("top device time per step (ms):")
    for e in avg[:15]:
        us = _device_us(e)
        if us <= 0:
            break
        print(f"  {us / 1e3 / args.steps:8.4f}  x{e.count // args.steps:4d}"
              f"  {e.key[:90]}")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25, max_name_column_width=60))
    print(card)


if __name__ == "__main__":
    main()
