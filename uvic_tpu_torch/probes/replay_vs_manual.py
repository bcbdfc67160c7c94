"""The replayed segment against the same segment taken phase by phase,
from one state.

    python3 -m uvic_tpu_torch.probes.replay_vs_manual [SPINUP_SEGMENTS]
        [--device D]

The port of ``scripts/probe_fused_vs_manual.py`` (the JAX package's
"fused" segment is one jitted program; the port's is the replay of the
coupler's stage graphs, eager on the CPU): after SPINUP_SEGMENTS
segments from ``init_state()``, one JSON line with the largest and mean
|difference| of the temperature after the two segments and of their
heat, freshwater and shortwave totals.  The manual segment steps the
ocean with ``OceanModel.step`` (Euler-backward mixing steps where the
configuration asks for them), the replayed one with ``run_scan``'s step,
as in the JAX package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import add_device, advance, earth_model

ACC_KEYS = ("heat", "freshwater", "swr")


def compare_row(t_replay, t_manual, acc_replay, acc_manual) -> dict:
    from ..diag.climate import host
    d_sst = np.abs(host(t_replay[0]) - host(t_manual[0]))
    return dict(
        max_dT=float(d_sst.max()),
        mean_dT=float(d_sst.mean()),
        acc_absdiff={k: float(np.abs(host(acc_replay[k])
                                     - host(acc_manual[k])).max())
                     for k in ACC_KEYS},
        acc_heat_scale=float(np.abs(host(acc_replay["heat"])).max()))


def replay_vs_manual(m, state) -> dict:
    """The row of one segment from ``state`` (``relyr`` left as it was)."""
    from .segment_closure import manual_segment
    relyr = m.relyr
    replayed = m.run(state, 1)
    m.relyr = relyr
    acc_r = {k: v.clone() for k, v in m.last_acc.items()}
    ocean, _, acc_m = manual_segment(m, state)
    return compare_row(replayed.ocean.t, ocean.t, acc_r, acc_m)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m uvic_tpu_torch.probes.replay_vs_manual")
    p.add_argument("spinup", type=int, nargs="?", default=30)
    add_device(p)
    a = p.parse_args(argv)
    m = earth_model(a.device)
    state = advance(m, m.init_state(), a.spinup) if a.spinup \
        else m.init_state()
    print(json.dumps(replay_vs_manual(m, state)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
