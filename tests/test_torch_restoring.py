"""The port's ocean-only restoring run (``OceanModel.apply_restoring`` and
``run_restoring``) against ``uvic_tpu``, on the CPU in float64.

The small grid of ``small_config`` (34x34x8) with the tracer step of the
reference restoring test (dtts 43,200 s), from a noisy stratified state
under the flagship's zonal wind stress:

- ``apply_restoring`` at several fractional years, with both
  climatologies and with one row left out: the surface fluxes to 1e-12;
- ``run_restoring`` over two 5-day segments (10 steps each) under the
  seasonal climatology and under ``"bcest"``, without and with
  isopycnal/GM mixing: every field of the state to 1e-9 of its largest
  magnitude, nconv and itt equal;
- the reference test's own property (``tests/test_forcing_checks.py``):
  30 days of strong restoring from 10 C take the surface error below 0.7
  of its start;
- ``nseg=3`` equal to three calls of one segment each with ``relyr0``
  accumulated as ``run_restoring`` accumulates it, bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.io.timeforce import \
    default_surface_climatology as j_climatology
from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import (ocean_state_from_numpy,
                                    ocean_state_to_numpy)
from uvic_tpu_torch.io.timeforce import \
    default_surface_climatology as t_climatology
from uvic_tpu_torch.models.ocean.model import make_forcing as t_make_forcing
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean

RESTORING = dict(dtts=43200.0, dtuv=1800.0, dtsf=1800.0, tolrsf=1e8)
FIELDS = ("t", "tm1", "u", "um1", "psi0", "psi1", "ptd", "ptdb")
SEG_DAYS = 5.0
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the steps are many small operations, which a
    thread pool slows down when other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(iso=False, **kw):
    ocean = dict(RESTORING, isopycmix=iso, gent_mcwilliams=iso, **kw)
    jc, tc = j_small_config(), t_small_config()
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **ocean))
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **ocean))
    return j_make_ocean(jc), t_make_ocean(tc, device="cpu")


def _inputs(jm, seed=0):
    """(initial tracers, smf) as NumPy: a stratified noisy state and the
    flagship's wind stress."""
    g = jm.params.grid
    rng = np.random.default_rng(seed)
    shape = (g.km, g.jmt, g.imt)
    t0 = np.zeros((2,) + shape)
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None] \
        + 0.3 * rng.standard_normal(shape)
    t0[1] = 1e-4 * rng.standard_normal(shape)
    t0 *= np.asarray(jm.params.topo.tmask)
    taux = np.sin(np.deg2rad(np.asarray(g.yu) * 3))[:, None] \
        * np.ones((1, g.imt))
    return t0, np.stack([taux / 1.035, np.zeros_like(taux)])


def _state_dict(s):
    d = {name: np.asarray(getattr(s, name)) for name in FIELDS}
    d.update(ubar=np.asarray(s.ubar), ubarm1=np.asarray(s.ubarm1),
             itt=np.asarray(s.itt), nconv=np.asarray(s.nconv))
    return d


def _assert_states_close(js, ts, label):
    jd, td = _state_dict(js), ocean_state_to_numpy(ts)
    for name in FIELDS:
        scale = np.abs(jd[name]).max()
        err = np.abs(td[name] - jd[name]).max()
        assert err <= RTOL * scale, \
            f"{label} {name}: err {err:.3e} vs scale {scale:.3e}"
    assert int(td["itt"]) == int(jd["itt"])
    assert int(td["nconv"]) == int(jd["nconv"])


@pytest.fixture(scope="module")
def plain():
    jm, tm = _pair()
    t0, smf = _inputs(jm)
    return dict(jm=jm, tm=tm, t0=t0, smf=smf)


def test_apply_restoring_matches_jax(plain):
    jm, tm = plain["jm"], plain["tm"]
    g = jm.params.grid
    rng = np.random.default_rng(4)
    js, ts = jm.init_state(plain["t0"]), tm.init_state(plain["t0"])
    stf = 1e-4 * rng.standard_normal((2, g.jmt, g.imt))
    jf = j_make_forcing(jnp.asarray(plain["smf"]), jnp.asarray(stf))
    tf = t_make_forcing(torch.as_tensor(plain["smf"]), torch.as_tensor(stf))
    jsst, jsss = j_climatology(g)
    tsst, tsss = t_climatology(tm.params.grid, device="cpu")
    for relyr in (0.0, 0.04, 0.5, 0.97, 1.3):
        for fields in ((0, 0), (0, None), (None, 0)):
            jr = jm.apply_restoring(
                jf, js, None if fields[0] is None else jsst,
                None if fields[1] is None else jsss, relyr=relyr)
            tr = tm.apply_restoring(
                tf, ts, None if fields[0] is None else tsst,
                None if fields[1] is None else tsss, relyr=relyr)
            ref, got = np.asarray(jr.stf), tr.stf.numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-12,
                                       atol=1e-12 * np.abs(ref).max())
            assert tr.stf is not tf.stf
            np.testing.assert_array_equal(tr.smf.numpy(), plain["smf"])
    np.testing.assert_array_equal(tf.stf.numpy(), stf)


@pytest.mark.parametrize("climatology", ["seasonal", "bcest"])
def test_run_restoring_matches_jax(plain, climatology):
    jm, tm = plain["jm"], plain["tm"]
    js = jm.run_restoring(jm.init_state(plain["t0"]),
                          jnp.asarray(plain["smf"]), nseg=2,
                          seg_days=SEG_DAYS, relyr0=0.9,
                          climatology=climatology)
    ts = tm.run_restoring(tm.init_state(plain["t0"]),
                          torch.as_tensor(plain["smf"]), nseg=2,
                          seg_days=SEG_DAYS, relyr0=0.9,
                          climatology=climatology)
    assert ts.itt == 2 * round(SEG_DAYS * 86400.0 / RESTORING["dtts"])
    _assert_states_close(js, ts, climatology)


def test_run_restoring_with_isopycnal_mixing_matches_jax():
    jm, tm = _pair(iso=True)
    t0, smf = _inputs(jm, seed=1)
    g = jm.params.grid
    jsst, jsss = j_climatology(g)
    tsst, tsss = t_climatology(tm.params.grid, device="cpu")
    js = jm.run_restoring(jm.init_state(t0), jnp.asarray(smf), jsst, jsss,
                          nseg=2, seg_days=SEG_DAYS)
    ts = tm.run_restoring(tm.init_state(t0), torch.as_tensor(smf), tsst,
                          tsss, nseg=2, seg_days=SEG_DAYS)
    _assert_states_close(js, ts, "isopycnal")


def test_run_restoring_pulls_toward_climatology():
    """The reference's own test (tests/test_forcing_checks.py): strong
    restoring for 30 days from 10 C everywhere."""
    _, tm = _pair(dampts=(10.0, 10.0))
    g = tm.params.grid
    sstf, sssf = t_climatology(g, device="cpu")
    t0 = np.zeros((2, g.km, g.jmt, g.imt))
    t0[0] = 10.0
    t0 *= np.asarray(tm.params.topo.tmask)
    state = tm.init_state(t0)
    smf = torch.zeros((2, g.jmt, g.imt), dtype=torch.float64)
    clim0 = sstf(0.04).numpy()
    wet = tm.tmask[0].numpy() > 0
    err_before = np.abs(state.t[0, 0].numpy() - clim0)[wet].mean()
    state = tm.run_restoring(state, smf, sstf, sssf, nseg=1, seg_days=30.0)
    err_after = np.abs(state.t[0, 0].numpy() - clim0)[wet].mean()
    assert err_after < 0.7 * err_before, (err_before, err_after)
    assert bool(torch.isfinite(state.t).all())


def test_segments_one_call_each_equal_one_call(plain):
    tm = plain["tm"]
    sst, sss = t_climatology(tm.params.grid, device="cpu")
    smf = torch.as_tensor(plain["smf"])
    seg_days, yrlen = 2.0, 365.0
    whole = tm.run_restoring(tm.init_state(plain["t0"]), smf, sst, sss,
                             nseg=3, seg_days=seg_days, relyr0=0.3)
    s, relyr = tm.init_state(plain["t0"]), 0.3
    for _ in range(3):
        s = tm.run_restoring(s, smf, sst, sss, nseg=1, seg_days=seg_days,
                             relyr0=relyr)
        relyr += seg_days / yrlen
    a, b = ocean_state_to_numpy(whole), ocean_state_to_numpy(s)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # a state carried across continues bitwise too
    c = tm.run_restoring(ocean_state_from_numpy(b, "cpu"), smf, sst, sss,
                         nseg=1, seg_days=seg_days, relyr0=relyr)
    d = tm.run_restoring(s, smf, sst, sss, nseg=1, seg_days=seg_days,
                         relyr0=relyr)
    np.testing.assert_array_equal(c.t.numpy(), d.t.numpy())
