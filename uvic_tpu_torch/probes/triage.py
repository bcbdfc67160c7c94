"""Triage of a non-finite blow-up of the coupled earth run.

    python3 -m uvic_tpu_torch.probes.triage [MAX_SEGMENTS] [--out F.npz]
        [--device D]

The port of ``scripts/triage_earth.py``: the tools' earth model from
``init_state()`` segment by segment, one line a segment (T max, the
largest |u| and where, psi max, SAT max, wall time).  At the first
segment that leaves a non-finite field: every field's report
(``field_report``), ``debug.bisect_segment`` of the segment from the
state before it (the first phase that goes non-finite), and both
states' fields saved into ``--out``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from . import add_device, advance, earth_model


def field_report(name, arr) -> str:
    from ..diag.climate import host
    a = host(arr)
    bad = ~np.isfinite(a)
    if bad.any():
        idx = np.argwhere(bad)[0]
        return (f"{name}: NONFINITE at {tuple(int(i) for i in idx)} "
                f"(n={bad.sum()})")
    return f"{name}: max|.|={np.abs(a).max():.4g}"


def fields(state) -> dict:
    """Every floating tensor of ``state`` by its path."""
    from ..debug import _leaves
    return {".".join(p): v for p, v in _leaves(state)
            if v.is_floating_point()}


def segment_line(m, s, state, wall) -> str:
    from ..diag.climate import host
    g = m.grid
    seg_days = m.cfg.time.segtim_days
    tmax = float(np.abs(host(state.ocean.t[0])).max())
    uarr = np.abs(host(m.ocean.full_velocity(state.ocean.u,
                                             state.ocean.psi0)))
    c, k, j, i = np.unravel_index(uarr.argmax(), uarr.shape)
    loc = (f"{'uv'[c]}k{k}({np.asarray(g.yu)[j]:.0f}N,"
           f"{np.asarray(g.xu)[i]:.0f}E)")
    psi = float(np.abs(host(state.ocean.psi0)).max()) / 1e12
    atmax = float(np.abs(host(state.atm.at[0])).max())
    return (f"seg {s:3d} day {(s + 1) * seg_days:7.1f} "
            f"Tmax {tmax:9.4g} umax {float(uarr.max()):9.4g} @{loc:22s} "
            f"psi {psi:8.2f}Sv atmax {atmax:8.4g} wall {wall:6.1f}s")


def triage(m, state, max_segments, out):
    """Segments until one goes non-finite; returns its number or None."""
    from ..debug import bisect_segment
    t0 = time.time()
    for s in range(max_segments):
        prev, relyr = state, m.relyr
        state = advance(m, state)
        print(segment_line(m, s, state, time.time() - t0), flush=True)
        reports = {k: field_report(k, v) for k, v in fields(state).items()}
        if not any("NONFINITE" in r for r in reports.values()):
            continue
        print(f"FIRST NON-FINITE SEGMENT {s}", flush=True)
        for r in reports.values():
            print("   " + r, flush=True)
        m.relyr = relyr
        print(f"bisect: {bisect_segment(m, prev)}", flush=True)
        np.savez(out, **{f"prev_{k}": v.detach().cpu().numpy()
                         for k, v in fields(prev).items()},
                 **{f"bad_{k}": v.detach().cpu().numpy()
                    for k, v in fields(state).items()})
        print(f"saved {out}", flush=True)
        return s
    print(f"stable for {max_segments} segments", flush=True)
    return None


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch.probes.triage")
    p.add_argument("max_segments", type=int, nargs="?", default=80)
    p.add_argument("--out", default="earth_blowup.npz")
    add_device(p)
    a = p.parse_args(argv)
    m = earth_model(a.device)
    triage(m, m.init_state(), a.max_segments, a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
