"""Float32-vs-float64 drift of the ocean, by subsystem.

    python3 -m uvic_tpu_torch.precision_study [NSTEPS] [--mobi]
        [--device32 cuda|cpu] [--device64 cpu|cuda] [--device D]

The port of ``scripts/precision_study.py``: the 34x40x8 ocean with
isopycnal/GM mixing (and the full MOBI suite with ``--mobi``), from the
same initial state and under the same wind, stepped NSTEPS leapfrog steps
in float64 and in float32; one JSON object with the drift of T, S, the
baroclinic velocity, the streamfunction and (with MOBI) dic, o2, po4 and
no3 at a quarter, half and all of the steps.  The float32 side runs on
``--device32`` (by default the card: the hand-written tracer step,
convection apply and CG), the float64 side on ``--device64`` (by default
the CPU: the kernels' plain versions; the kernels take float32 only);
``--device`` sets both.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

BGC_KEYS = ("dic", "o2", "po4", "no3")


def build(dtype, mobi, nj=34, ni=40, km=8, device=None):
    """(model, initial state, forcing): the script's ``build``."""
    from .config import mobi_full, small_config
    from .models.ocean.model import make_forcing, make_ocean
    cfg = small_config(imt=ni, jmt=nj, km=km)
    cfg = cfg.replace(dtype=dtype, ocean=dataclasses.replace(
        cfg.ocean, isopycmix=True, gent_mcwilliams=True,
        dtts=43200.0, dtuv=1800.0, dtsf=1800.0, tolrsf=1e2,
        mxscan=2000))
    if mobi:
        cfg = cfg.replace(bgc=mobi_full())
    m = make_ocean(cfg, device=device)
    g = m.params.grid
    t0 = np.zeros((m.nt, g.km, g.jmt, g.imt))
    vals = np.array([t.init for t in m.tracer_index.tracers])
    t0[:] = vals[:, None, None, None]
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None]
    t0 *= np.asarray(m.params.topo.tmask)[None]
    yu = np.asarray(g.yu)
    taux = np.sin(np.deg2rad(yu * 3))[:, None] * np.ones((1, g.imt))
    smf = np.stack([taux / 1.035, np.zeros_like(taux)]).astype(dtype)
    stf = np.zeros((m.nt, g.jmt, g.imt), dtype)

    def tn(x):
        return torch.as_tensor(x, device=m.device)

    f = make_forcing(tn(smf), tn(stf))
    return m, m.init_state(t0.astype(dtype)), f


def run(dtype, nsteps, mobi, device=None):
    """The script's ``run``: a forward step and ``nsteps`` leapfrog steps;
    (model, {step: host float64 t, u, psi} at nsteps/4, /2 and nsteps).
    On the card the leapfrog steps are replays of the captured step
    (``run_scan`` with no mixing step in the stretch): the same
    ``_step`` as ``step(leapfrog=True)``, at ~1e5 fewer host launches a
    MOBI step."""
    m, s, f = build(dtype, mobi, device=device)
    s = m.step(s, f, leapfrog=False)
    snaps = {}
    done = 0
    for n in sorted({nsteps // 4, nsteps // 2, nsteps} - {0}):
        if m.device.type == "cpu":
            for _ in range(n - done):
                s = m.step(s, f, leapfrog=True)
        else:
            s = m.run_scan(s, f, n - done, nmix=s.itt + n - done)
        done = n
        snaps[n] = {k: getattr(s, name).detach().cpu().numpy()
                    .astype(np.float64)
                    for k, name in (("t", "t"), ("u", "u"), ("psi", "psi0"))}
    return m, snaps


def snapshots(dtype, nsteps, mobi, device=None) -> dict:
    """``run``'s snapshots alone: what a worker process hands back."""
    return run(dtype, nsteps, mobi, device)[1]


def drift_rows(m64, snap64, snap32, mobi) -> list:
    """The script's rows: each snapshot's drift of float32 from float64."""
    wet = np.asarray(m64.params.topo.tmask) > 0
    idx = m64.tracer_index
    rows = []
    for n in sorted(snap64):
        a, b = snap64[n], snap32[n]
        dt_ = np.abs(a["t"] - b["t"])
        scale_T = max(np.abs(a["t"][0][wet]).max(), 1e-12)
        du = np.abs(a["u"] - b["u"]).max()
        uscale = max(np.abs(a["u"]).max(), 1e-12)
        dpsi = np.abs(a["psi"] - b["psi"])
        psis = max(np.abs(a["psi"]).std(), 1e-12)
        row = dict(
            step=int(n),
            temp_max_err=float(dt_[0][wet].max()),
            temp_rel=float(dt_[0][wet].max() / scale_T),
            salt_max_err=float(dt_[1][wet].max()),
            u_rel=float(du / uscale),
            psi_rel=float(dpsi.max() / psis),
        )
        if mobi and "dic" in idx:
            for nme in BGC_KEYS:
                if nme in idx:
                    k = idx[nme]
                    sc = max(np.abs(a["t"][k][wet]).max(), 1e-12)
                    row[nme + "_rel"] = float(dt_[k][wet].max() / sc)
        rows.append(row)
    return rows


def study(nsteps, mobi, device32=None, device64="cpu") -> dict:
    """The script's ``main`` as a dict: float64 on ``device64`` against
    float32 on ``device32``."""
    m64, snap64 = run("float64", nsteps, mobi, device64)
    _, snap32 = run("float32", nsteps, mobi, device32)
    return {"nsteps": nsteps, "mobi": mobi,
            "rows": drift_rows(m64, snap64, snap32, mobi)}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch."
                                "precision_study")
    p.add_argument("nsteps", type=int, nargs="?", default=40)
    p.add_argument("--mobi", action="store_true")
    p.add_argument("--device32", default=None,
                   help="the float32 side: cuda (the default) or cpu")
    p.add_argument("--device64", default="cpu",
                   help="the float64 side: cpu (the default) or cuda")
    p.add_argument("--device", default=None, help="both sides")
    a = p.parse_args(argv)
    d32 = a.device or a.device32
    d64 = a.device or a.device64
    print(json.dumps(study(a.nsteps, a.mobi, d32, d64), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
