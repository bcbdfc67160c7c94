"""The ocean heat budget of ONE coupled earth segment, closed with its
forcing in hand.

    python3 -m uvic_tpu_torch.probes.segment_closure [SPINUP_SEGMENTS]
        [--device D]

The port of ``scripts/probe_segment_closure.py``: after SPINUP_SEGMENTS
segments from ``init_state()``, one segment taken phase by phase
(``debug.segment_phases``: the atmosphere/ice substeps, gosbc's forcing,
the ocean steps), and the check d(ocean heat inventory) == (stf + the
geothermal heat) x area x time: the audit's relative closure of T and S
and the four terms in W/m^2 of ocean.  Then the replayed segment from the
same state (the script's "fused" one): its inventory change against its
accumulated heat flux.  The script masks the geothermal term with
``tmask[0][0]``, the first row of the surface mask, which is land, so
its ``bhf_wm2`` reads 0; here the surface mask ``tmask[0]``, as the ocean
step applies it (``OceanModel._step``).

In float32 the closure residual of a segment stays within
``RESID_LIMIT_WM2`` (``chip_smoke.py`` holds the card to it).
"""

from __future__ import annotations

import argparse
import json

from . import RHOCP, CAL_PER_ERG, add_device, advance, earth_model

# the float32 limit of |resid_wm2| and of the replayed segment's residual:
# the 0.1 W/m^2 that the acceptance window allows the TOA audit's
# residual (VERDICT.md:20-22), which a segment's ocean budget, a part of
# it, must not exceed alone
RESID_LIMIT_WM2 = 0.1


def heat_change(after_t, before_t, dvol) -> float:
    """d(ocean heat inventory) [K cm^3], in float64."""
    return float(((after_t[0].double() - before_t[0].double())
                  * dvol.double()).sum())


def closure_row(m, audit, before_t, after_t, forcing) -> dict:
    """The manual segment's row from the tracers before and after it and
    its forcing."""
    from ..diag.climate import host
    nsteps, dtts = m.ntspos, m.cfg.ocean.dtts
    seg_s = nsteps * dtts
    errs = audit.ocean_closure(before_t, after_t, forcing, nsteps, dtts)
    area64 = host(audit.ocean_area)
    oa = float(area64.sum())
    d_heat = heat_change(after_t, before_t, audit.dvol)
    applied = float((host(forcing.stf[0]) * area64).sum()) * seg_s
    bhf_int = 0.0
    if m.ocean.bhf is not None:
        bhf_int = float((host(m.ocean.bhf) * host(m.ocean.tmask[0])
                         * area64).sum()) * seg_s

    def wm2(x):
        return x / seg_s / oa * RHOCP * 1e-3

    return dict(
        closure_rel=dict(temp=round(errs["temp"], 5),
                         salt=round(errs["salt"], 5)),
        d_heat_wm2=round(wm2(d_heat), 3),
        applied_wm2=round(wm2(applied), 3),
        bhf_wm2=round(wm2(bhf_int), 3),
        resid_wm2=round(wm2(d_heat - applied - bhf_int), 3))


def replay_row(m, audit, before_t, after_t, acc_replay, acc_manual) -> dict:
    """The replayed segment's inventory change and accumulated heat flux,
    and the manual segment's accumulated heat flux [W/m^2 of ocean]."""
    from ..diag.climate import host
    seg_s = m.ntspos * m.cfg.ocean.dtts
    area64 = host(audit.ocean_area)
    oa = float(area64.sum())

    def acc_heat_wm2(acc):
        return float((host(acc["heat"]) * area64).sum()) * CAL_PER_ERG \
            / float(host(acc["time"])) * 1e-3 * RHOCP / oa

    return dict(
        fused_d_heat_wm2=round(heat_change(after_t, before_t, audit.dvol)
                               / seg_s / oa * RHOCP * 1e-3, 3),
        fused_acc_heat_wm2=round(acc_heat_wm2(acc_replay), 3),
        manual_acc_heat_wm2=round(acc_heat_wm2(acc_manual), 3))


def manual_segment(m, state):
    """One segment phase by phase: (the ocean state after it, its forcing,
    its flux totals)."""
    from ..debug import segment_phases
    for phase in segment_phases(m, state):
        if phase[0] == "gosbc":
            forcing, acc = phase[1], phase[2]
        elif phase[0] == "ocean":
            ocean = phase[2]
    return ocean, forcing, acc


def closure_rows(m, state):
    """(the manual segment's row, the replayed segment's row, the state
    after the replayed segment) from ``state``."""
    from ..diag.conservation import FullAudit
    audit = FullAudit(m)
    before_t = state.ocean.t.clone()
    ocean, forcing, acc = manual_segment(m, state)
    manual = closure_row(m, audit, before_t, ocean.t, forcing)
    relyr = m.relyr
    after = m.run(state, 1)
    m.relyr = relyr
    return manual, replay_row(m, audit, before_t, after.ocean.t,
                              m.last_acc, acc), after


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m uvic_tpu_torch.probes.segment_closure")
    p.add_argument("spinup", type=int, nargs="?", default=30)
    add_device(p)
    a = p.parse_args(argv)
    m = earth_model(a.device)
    state = advance(m, m.init_state(), a.spinup) if a.spinup \
        else m.init_state()
    manual, replay, _ = closure_rows(m, state)
    print(json.dumps(manual), flush=True)
    print(json.dumps(replay), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
