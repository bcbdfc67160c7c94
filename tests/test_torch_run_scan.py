"""The port's full-MOBI ocean step, ``run`` and ``run_scan`` against
``uvic_tpu`` on the CPU, in float64.

The 34x40x8 flagship-physics grid with ``mobi_full()`` (41 tracers) at
the default dtts (nbio 8 on a leapfrog step, 4 on a forward step), with
``nmix = 3`` so that a mixing step falls inside 4 steps.  From the same
2-tracer initial condition (extended to 41 by ``init_state``):

- a forward priming step and 2 leapfrog steps agree with the reference
  to 1e-9 of each field's largest value;
- ``run_scan`` over 4 steps agrees with the reference's ``run_scan``,
  and ``run`` with its ``run``, to the same tolerance, while the two
  drivers differ from each other in both packages by design: the
  reference's ``run_scan`` takes the leapfrog source instance on a
  mixing step (``uvic_tpu/models/ocean/model.py:564-567``);
- ``run_scan`` returns a new state and leaves its argument as it was;
- an nt=41 state carried through ``convert.py`` comes back bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import mobi_full as j_mobi_full
from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

from uvic_tpu_torch.config import mobi_full as t_mobi_full
from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import (ocean_state_from_numpy,
                                    ocean_state_to_numpy)
from uvic_tpu_torch.models.ocean.model import make_forcing as t_make_forcing
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean

FLAGSHIP = dict(isopycmix=True, gent_mcwilliams=True, tidal_kv=True,
                gthflx=True, aniso_visc=True, aniso_zonal=True, nmix=3)
FIELDS = ("t", "tm1", "u", "um1", "psi0", "psi1", "ptd", "ptdb")
N_SCAN = 4


def _j_state_dict(s):
    d = {name: np.asarray(getattr(s, name)) for name in FIELDS}
    d.update(ubar=np.asarray(s.ubar), ubarm1=np.asarray(s.ubarm1),
             itt=np.asarray(s.itt), nconv=np.asarray(s.nconv))
    return d


def _copy(state):
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state)


def _assert_close(got, ref, what):
    """Each field within 1e-9 of its largest value; the tracer fields
    tracer by tracer."""
    for name in FIELDS:
        a, b = got[name], ref[name]
        rows = zip(a, b) if name in ("t", "tm1") else [(a, b)]
        for n, (x, y) in enumerate(rows):
            scale = np.abs(y).max()
            err = np.abs(x - y).max()
            assert err <= 1e-9 * scale, \
                f"{what} {name}[{n}]: err {err:.3e} vs scale {scale:.3e}"
    assert int(got["itt"]) == int(ref["itt"])
    assert int(got["nconv"]) == int(ref["nconv"])


@pytest.fixture(scope="module")
def runs():
    jc = j_small_config(imt=40, jmt=34, km=8)
    tc = t_small_config(imt=40, jmt=34, km=8)
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **FLAGSHIP),
                    bgc=j_mobi_full())
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **FLAGSHIP),
                    bgc=t_mobi_full())
    jm, tm = j_make_ocean(jc), t_make_ocean(tc, device="cpu")
    g = jm.params.grid
    rng = np.random.default_rng(3)
    shape = (g.km, g.jmt, g.imt)
    t0 = np.zeros((2,) + shape)
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None] \
        + 0.5 * rng.standard_normal(shape)
    t0[1] = 1e-4 * rng.standard_normal(shape)
    t0 *= np.asarray(jm.params.topo.tmask)
    taux = np.sin(np.deg2rad(np.asarray(g.yu) * 3))[:, None] \
        * np.ones((1, g.imt))
    smf = np.stack([taux / 1.035, np.zeros_like(taux)])
    stf = np.zeros((jm.nt, g.jmt, g.imt))
    stf[0] = 1e-4 * rng.standard_normal((g.jmt, g.imt))
    swr = 2.0e5 * (1.0 + 0.2 * rng.standard_normal((g.jmt, g.imt)))
    relyr = 0.3
    jf = j_make_forcing(jnp.asarray(smf), jnp.asarray(stf),
                        swr=jnp.asarray(swr), relyr=relyr)
    tf = t_make_forcing(torch.as_tensor(smf), torch.as_tensor(stf),
                        swr=torch.as_tensor(swr), relyr=relyr)

    # the reference's steps may donate their state argument: each use
    # takes a copy
    js1 = jm.step(jm.init_state(t0), jf, leapfrog=False)
    t_hist = [tm.step(tm.init_state(t0), tf, leapfrog=False)]
    j_hist, js = [_j_state_dict(js1)], _copy(js1)
    for _ in range(2):
        js = jm.step(js, jf, leapfrog=True)
        j_hist.append(_j_state_dict(js))
        t_hist.append(tm.step(t_hist[-1], tf, leapfrog=True))

    # both drivers from the primed state (itt = 1): steps at itt 1..4,
    # the mixing step at itt = 3
    j_scan = _j_state_dict(jm.run_scan(_copy(js1), jf, N_SCAN))
    j_run = _j_state_dict(jm.run(_copy(js1), jf, N_SCAN))
    ts1 = t_hist[0]
    before = ocean_state_to_numpy(ts1)
    t_scan = tm.run_scan(ts1, tf, N_SCAN)
    after = ocean_state_to_numpy(ts1)
    t_run = tm.run(ts1, tf, N_SCAN)
    return dict(jm=jm, tm=tm, j_hist=j_hist, t_hist=t_hist, j_scan=j_scan,
                j_run=j_run, t_scan=t_scan, t_run=t_run, before=before,
                after=after)


def test_initial_state_extended_to_41_tracers(runs):
    tm = runs["tm"]
    s = runs["t_hist"][0]
    assert tm.nt == 41 and tuple(s.t.shape[:2]) == (41, 8)
    assert tm.npzd[True].nbio == 8 and tm.npzd[False].nbio == 4


def test_mobi_steps_match_jax(runs):
    for n, (jd, ts) in enumerate(zip(runs["j_hist"], runs["t_hist"])):
        _assert_close(ocean_state_to_numpy(ts), jd, f"step {n}")
    final = runs["t_hist"][-1]
    assert bool(torch.isfinite(final.t).all())


def test_run_scan_matches_jax_run_scan(runs):
    _assert_close(ocean_state_to_numpy(runs["t_scan"]), runs["j_scan"],
                  "run_scan")
    assert runs["t_scan"].itt == 1 + N_SCAN
    assert tuple(runs["tm"].scan_cg_iters.shape) == (N_SCAN,)


def test_run_matches_jax_run(runs):
    _assert_close(ocean_state_to_numpy(runs["t_run"]), runs["j_run"], "run")


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_run_and_run_scan_differ_on_the_mixing_step(runs, side):
    """By design of the reference, not of the port: the mixing step's
    sources differ (nbio 8 of dtts/8 against 4 of dtts/4), far beyond
    the 1e-9 the two packages agree to."""
    if side == "jax":
        a, b = runs["j_scan"]["t"], runs["j_run"]["t"]
    else:
        a = ocean_state_to_numpy(runs["t_scan"])["t"]
        b = ocean_state_to_numpy(runs["t_run"])["t"]
    idx = runs["tm"].tracer_index
    po4 = idx["po4"]
    diff = np.abs(a[po4] - b[po4]).max()
    assert diff > 1e-6 * np.abs(b[po4]).max()


def test_run_scan_leaves_its_argument(runs):
    for name, value in runs["before"].items():
        np.testing.assert_array_equal(runs["after"][name], value,
                                      err_msg=name)


def test_nt41_state_round_trip_is_bitwise(runs):
    s = runs["t_hist"][-1]
    d = ocean_state_to_numpy(s)
    back = ocean_state_to_numpy(ocean_state_from_numpy(d, "cpu"))
    assert d["t"].shape[0] == 41
    for name, value in d.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    jd = runs["j_hist"][-1]
    from_jax = ocean_state_to_numpy(ocean_state_from_numpy(jd, "cpu"))
    for name in FIELDS + ("ubar", "ubarm1"):
        np.testing.assert_array_equal(from_jax[name], jd[name],
                                      err_msg=name)
