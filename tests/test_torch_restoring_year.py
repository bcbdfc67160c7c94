"""The restoring year of ``chip_smoke.py`` phase 10 on the CPU, and the
reference rows it is held to on the card.

- A "year" of the small ocean (``small_config``, isopycnal mixing off,
  dtts 5 days so that a 30-day segment is 6 steps) in float64, run the
  way the card runs it: twelve calls of ``run_restoring`` with one
  segment each and ``relyr0`` accumulated as ``run_restoring``
  accumulates it, in both packages.  After each segment the state agrees
  to 1e-9 of each field's largest magnitude, and each key of
  ``chip_smoke.restoring_row`` (the reference's CG iterations read
  through a ``jax.debug.callback`` around its ``tropic_step``) to 1e-9
  of its value, the mean CG iterations and nconv exactly; the port's
  twelve calls equal one call with ``nseg=12``, bitwise.
- ``golden/regression/restoring_year.json`` holds a row for each segment
  with every key ``chip_smoke.restoring_row`` writes, and for each
  segment a positive limit of every key but nconv, no smaller than the
  key's floor;
  ``chip_smoke.restoring_gaps`` passes the reference's own rows and
  fails a row moved past a limit.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvic_tpu.models.ocean.model as j_model_mod
from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.io.timeforce import \
    default_surface_climatology as j_climatology
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import ocean_state_to_numpy
from uvic_tpu_torch.io.timeforce import \
    default_surface_climatology as t_climatology
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean

from chip_smoke import (RESTORING_GOLDEN, RESTORING_SEG_DAYS,
                        RESTORING_SEGMENTS, RESTORING_YRLEN, restoring_gaps,
                        restoring_row, restoring_weights,
                        restoring_year_rows)
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
OCEAN = dict(isopycmix=False, gent_mcwilliams=False, dtts=432000.0,
             dtuv=1800.0, dtsf=1800.0, tolrsf=1e8)
FIELDS = ("t", "tm1", "u", "um1", "psi0", "psi1", "ptd", "ptdb")
RTOL = 1e-9


@pytest.fixture(scope="module")
def years():
    iters = []
    tropic = j_model_mod.tropic_step

    def counted(*a, **k):
        out = tropic(*a, **k)
        jax.debug.callback(lambda it: iters.append(int(it)), out[4])
        return out

    jc, tc = j_small_config(), t_small_config()
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **OCEAN))
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **OCEAN))
    j_model_mod.tropic_step = counted
    try:
        jm = j_make_ocean(jc)
        tm = t_make_ocean(tc, device="cpu")
        g = jm.params.grid
        t0 = np.zeros((2, g.km, g.jmt, g.imt))
        t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None]
        t0 *= np.asarray(jm.params.topo.tmask)
        taux = np.sin(np.deg2rad(np.asarray(g.yu) * 3))[:, None] \
            * np.ones((1, g.imt))
        smf = np.stack([taux / 1.035, np.zeros_like(taux)])
        jsst, jsss = j_climatology(g)
        tsst, tsss = t_climatology(tm.params.grid, device="cpu")
        weights = restoring_weights(g, np.asarray(jm.tmask))
        jd, td = [], []

        def jsync(state):
            if state is None:
                jax.effects_barrier()
                iters.clear()
            else:
                jax.block_until_ready(state)
                jax.effects_barrier()

        def jrow(state, mid):
            jd.append({k: np.asarray(getattr(state, k)) for k in FIELDS})
            return restoring_row(weights, state.t, state.psi0, jsst(mid),
                                 jsss(mid), list(iters), state.nconv)

        def trow(state, mid):
            td.append(ocean_state_to_numpy(state))
            return restoring_row(weights, state.t, state.psi0, tsst(mid),
                                 tsss(mid), tm.scan_cg_iters, state.nconv)

        jrows = restoring_year_rows(jm, jm.init_state(t0), jnp.asarray(smf),
                                    jsst, jsss, jrow, jsync)[0]
        trows = restoring_year_rows(tm, tm.init_state(t0),
                                    torch.as_tensor(smf), tsst, tsss,
                                    trow)[0]
        out = [dict(jd=a, td=b, jrow=c, trow=d)
               for a, b, c, d in zip(jd, td, jrows, trows)]
    finally:
        j_model_mod.tropic_step = tropic
    whole = tm.run_restoring(tm.init_state(t0), torch.as_tensor(smf), tsst,
                             tsss, nseg=RESTORING_SEGMENTS,
                             seg_days=RESTORING_SEG_DAYS,
                             yrlen=RESTORING_YRLEN)
    return dict(segments=out, whole=ocean_state_to_numpy(whole))


def test_restoring_year_matches_jax(years):
    segments = years["segments"]
    assert len(segments) == RESTORING_SEGMENTS
    for n, seg in enumerate(segments):
        for name in FIELDS:
            ref, got = seg["jd"][name], seg["td"][name]
            scale = np.abs(ref).max()
            assert np.abs(got - ref).max() <= RTOL * scale, (n, name)
        jrow, trow = seg["jrow"], seg["trow"]
        assert list(trow) == list(jrow)
        for key, ref in jrow.items():
            if key in ("cg_iters", "nconv"):
                assert trow[key] == ref, (n, key)
            else:
                assert abs(trow[key] - ref) <= RTOL * abs(ref), (n, key)
    last = segments[-1]["trow"]
    assert last["sst_gap"] < segments[0]["trow"]["sst_gap"]
    assert np.isfinite(list(last.values())).all()


def test_one_call_a_segment_equals_one_call_of_the_year(years):
    """The card's year takes one call a segment; one call of
    ``nseg=12`` gives the same state, bitwise."""
    last = years["segments"][-1]["td"]
    for name, value in years["whole"].items():
        np.testing.assert_array_equal(last[name], value, err_msg=name)


def test_golden_rows_hold_every_key_the_card_reads():
    golden = json.loads((ROOT / RESTORING_GOLDEN).read_text())
    keys = list(restoring_row(
        (np.ones((1, 2, 3)), np.ones((2, 3))), np.ones((2, 1, 2, 3)),
        np.ones((2, 3)), np.ones((2, 3)), np.ones((2, 3)), [1], 0))
    assert golden["keys"] == keys
    assert len(golden["rows"]) == RESTORING_SEGMENTS
    held = [k for k in keys if k != "nconv"]
    assert len(golden["limit"]) == RESTORING_SEGMENTS
    for limits in golden["limit"]:
        assert sorted(limits) == sorted(held)
        for k in held:
            assert limits[k] >= golden["floor"][k] > 0.0
    for row in golden["rows"]:
        assert list(row) == keys
        assert np.isfinite([row[k] for k in held]).all()
    for key in ("limit_rule", "configuration", "year_s"):
        assert golden[key]
    worst, failed = restoring_gaps(golden["rows"], golden)
    assert failed == [] and sorted(worst) == sorted(held)
    moved = [dict(r) for r in golden["rows"]]
    moved[3]["psi_max"] += 1.01 * golden["limit"][3]["psi_max"]
    moved[5]["nconv"] += 1
    _, failed = restoring_gaps(moved, golden)
    assert [(n, k) for n, k, _, _ in failed] == [(4, "psi_max"),
                                                 (6, "nconv")]
