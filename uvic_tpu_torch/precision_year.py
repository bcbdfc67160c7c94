"""One model year of the coupled earth configuration at one dtype, and
the divergence of two such years (the float32-vs-float64 precision
contract, ``golden/precision/``).

    python3 -m uvic_tpu_torch.precision_year run DTYPE OUT.json [YEARS]
        [--device cuda|cpu]
    python3 -m uvic_tpu_torch.precision_year compare A.json B.json

The port of ``scripts/precision_year.py``: ``run`` takes
``CoupledModel(earth_config(dtype), topo_kind="earth")`` from
``init_state()`` through YEARS x 73 segments (``relyr`` advancing by 5 of
365 days a segment, as the script's loop does) and writes the
per-segment rows ``seg``, ``sat_gm``, ``sst_gm``, ``heat``, ``psi_max``
and ``ice`` (``diag.climate.precision_row``) as ``{"dtype", "rows"}``;
``compare`` prints the script's divergence JSON of two row files (each
key's largest and final absolute gap, and both relative to the second
file's largest |value|).  On the card a segment is the replay of the
coupler's stage graphs, so the tracer step, the convection apply and the
barotropic CG run as the hand-written kernels at every ocean step; the
kernels take float32 only, so a float64 year runs with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

KEYS = ("sat_gm", "sst_gm", "heat", "psi_max", "ice")
YEAR_DAYS = 365.0


def run(dtype, out, years=1.0, device=None):
    """The script's ``run``: ``years`` of the earth model at ``dtype``
    from ``init_state()``, the rows written to ``out``."""
    from .config import earth_config
    from .coupler.driver import CoupledModel
    from .diag.climate import ClimateWeights, precision_row
    cfg = earth_config(dtype=dtype)
    m = CoupledModel(cfg, topo_kind="earth", device=device)
    w = ClimateWeights(m)
    state = m.init_state()
    rows = []
    for s in range(int(round(years * YEAR_DAYS / cfg.time.segtim_days))):
        state = m.run(state, 1, yrlen=YEAR_DAYS)
        rows.append(dict(seg=s + 1, **precision_row(state, w)))
        if not np.isfinite(rows[-1]["sst_gm"]):
            raise SystemExit(f"non-finite at segment {s + 1}")
    with open(out, "w") as f:
        json.dump(dict(dtype=dtype, rows=rows), f)
    print("wrote", out, flush=True)
    return rows


def divergence(a, b) -> dict:
    """The script's ``compare`` of two ``{"dtype", "rows"}`` records."""
    out = {}
    n = min(len(a["rows"]), len(b["rows"]))
    for k in KEYS:
        va = np.array([r[k] for r in a["rows"][:n]])
        vb = np.array([r[k] for r in b["rows"][:n]])
        scale = max(np.abs(vb).max(), 1e-30)
        d = np.abs(va - vb)
        out[k] = dict(max_abs=float(d.max()),
                      final_abs=float(d[-1]),
                      max_rel=float(d.max() / scale),
                      final_rel=float(d[-1] / scale))
    return dict(segments=n, a=a["dtype"], b=b["dtype"], divergence=out)


def compare(a_path, b_path) -> dict:
    with open(a_path) as fa, open(b_path) as fb:
        res = divergence(json.load(fa), json.load(fb))
    print(json.dumps(res, indent=1))
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch."
                                "precision_year")
    p.add_argument("mode", choices=("run", "compare"))
    p.add_argument("args", nargs="+")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    if a.mode == "compare":
        if len(a.args) != 2:
            p.error("compare takes two row files")
        compare(*a.args)
        return 0
    if len(a.args) not in (2, 3):
        p.error("run takes DTYPE OUT [YEARS]")
    run(a.args[0], a.args[1],
        float(a.args[2]) if len(a.args) > 2 else 1.0, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
