"""Production run of the coupled model: N model years through ``Run``
(tsi stream, tavg netCDF, restarts with the calendar, audits).

    python3 -m uvic_tpu_torch.run_production [--years N] [--outdir DIR]
        [--dtype float32|float64] [--restart] [--tsiint D]
        [--timavgint D] [--restint D] [--earth] [--from-restart NPZ]
        [--device cuda|cpu]

The flags of ``scripts/run_production.py``.  ``--earth`` runs the earth
configuration (``earth_config()`` on the real-Earth topography);
``--from-restart`` seeds the state from a restart and takes the
fractional year (``relyr``, and the calendar's days with it) from the
``restart_meta.json`` beside it; ``--restart`` resumes from
``OUTDIR/restart.npz`` with its calendar.  ``--bgc mobi`` adds the full
MOBI suite (``mobi_full()``, 41 tracers) and ``--bgc npzd`` the NPZD
suite with carbon, alkalinity, O2 and nitrogen, as the reference's
script builds them; their gas exchange with the atmosphere runs in the
coupler, and the ocean sediments with them where the configuration
enables ``sed``.  Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m uvic_tpu_torch.run_production")
    ap.add_argument("--years", type=float, default=1.0)
    ap.add_argument("--outdir", default="run_out")
    ap.add_argument("--bgc", default="none",
                    choices=["none", "npzd", "mobi"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--restart", action="store_true",
                    help="resume from OUTDIR/restart.npz")
    ap.add_argument("--tsiint", type=float, default=10.0)
    ap.add_argument("--timavgint", type=float, default=360.0)
    ap.add_argument("--restint", type=float, default=360.0)
    ap.add_argument("--earth", action="store_true",
                    help="the earth configuration (earth_config on the "
                         "real-Earth topography)")
    ap.add_argument("--from-restart", default=None,
                    help="seed the initial state from this .npz")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from .config import BgcConfig, ModelConfig, earth_config, mobi_full
    from .coupler.driver import CoupledModel
    from .coupler.run import Run
    from .io.restart import load_restart

    if args.earth:
        cfg = earth_config(dtype=args.dtype)
    else:
        cfg = ModelConfig().replace(dtype=args.dtype)
    cfg = cfg.replace(time=dataclasses.replace(
        cfg.time, tsiint=args.tsiint, timavgint=args.timavgint,
        restint=args.restint))
    if args.bgc == "mobi":
        cfg = cfg.replace(bgc=mobi_full())
    elif args.bgc == "npzd":
        cfg = cfg.replace(bgc=BgcConfig(
            suite="npzd", carbon=True, alk=True, o2=True, nitrogen=True))

    model = CoupledModel(cfg, topo_kind="earth" if args.earth else "world",
                         device=args.device)
    run = Run(model, args.outdir, log=lambda m: print(m, flush=True))
    state = model.init_state()
    if args.restart:
        state = run.load(state)
        print(f"resumed at {run.tm.stamp()}")
    elif args.from_restart:
        state = load_restart(args.from_restart, state)
        # the seasonal phase too: a mid-season checkpoint restarted at
        # the start of a year would see a season/state mismatch
        metap = os.path.join(os.path.dirname(args.from_restart),
                             "restart_meta.json")
        if os.path.exists(metap):
            with open(metap) as f:
                relyr = json.load(f).get("relyr")
            if relyr is not None:
                model.relyr = relyr
                run.tm.days = relyr * run.tm.yrlen
        print(f"seeded from {args.from_restart}")

    yrlen = 360.0 if cfg.time.eqyear else 365.0
    t0 = time.perf_counter()
    state = run.run(state, days=args.years * yrlen)
    wall = time.perf_counter() - t0
    print(f"done: {args.years} model years in {wall:.1f}s wall "
          f"({args.years / (wall / 86400.0):.1f} model-years/day) on "
          f"{model.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
