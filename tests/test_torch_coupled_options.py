"""The port's coupled options against ``uvic_tpu`` on the CPU, in float64:
the multi-category sea ice (``ice.cpts = 3``), brine convection
(``ocean.convect_brine``) and the deep tracer acceleration
(``dtxcel_deep = 4`` with isopycnal/GM mixing, the spin-up's setting).
``test_torch_coupled_ice_options.py`` takes the other ice options with
this file's helpers.

Each option runs two segments of ``small_config`` (dtts 12 h, the
reference's ``tests/test_cpts.py`` set-up) in both packages from the
same initial state: a warm-to-freezing SST, -1.93 C poleward of 60
degrees so that ice forms and rejects brine, plus seeded noise of
NOISE_K on the temperature.  The noise keeps every column's T and S off
exact equality: in an exactly homogeneous column the region means of
complete convection are equal values averaged with unequal weights under
acceleration (dzt/dtxcel), and the reference's jitted label loop breaks
those exact density ties by round-off (``ROADMAP.md`` Queue C); from the
noiseless state the accelerated case leaves the two packages 2.3e-5
apart in ocean/t after one segment, with the noise 4.5e-12.

- every field of the state agrees to TOL of its largest value, the
  counters exactly; the last segment's ocean forcing (with the brine
  fluxes ``cbf``, ``cba``) and flux totals too;
- a CPTS restart written by either package reads back through the other
  bitwise, and a restart without ``cpts/*`` keeps ``init_cpts_state``'s
  values, with a warning.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.coupler.driver import CoupledModel as JCoupled
from uvic_tpu.io.restart import _flatten_state
from uvic_tpu.io.restart import load_restart as j_load
from uvic_tpu.io.restart import save_restart as j_save

from uvic_tpu_torch.config import small_config
from uvic_tpu_torch.convert import (coupled_state_from_numpy,
                                    coupled_state_to_numpy)
from uvic_tpu_torch.coupler.driver import CoupledModel
from uvic_tpu_torch.io.restart import load_restart, save_restart

NSEG = 2
TOL = 1e-9
NOISE_K = 1e-3
CONVERGED = dict(solver_tol=1e-13, solver_maxiter=1000)


def _cpts(cfg):
    return dict(ice=dataclasses.replace(cfg.ice, cpts=3, nlay=4))


def _brine(cfg):
    return dict(ocean=dataclasses.replace(cfg.ocean, convect_brine=True))


def _accel(cfg):
    return dict(ocean=dataclasses.replace(
        cfg.ocean, dtxcel_deep=4.0, isopycmix=True, gent_mcwilliams=True))


OPTIONS = {"cpts": _cpts, "convect_brine": _brine, "accel4": _accel}


def config(small, option):
    cfg = small()
    cfg = cfg.replace(
        dtype="float64",
        ocean=dataclasses.replace(
            cfg.ocean, isopycmix=False, gent_mcwilliams=False,
            dtts=43200.0, dtuv=1800.0, dtsf=1800.0, tolrsf=1e8),
        embm=dataclasses.replace(cfg.embm, **CONVERGED))
    return cfg.replace(**option(cfg))


def initial_t(grid, tmask):
    """The cold-pole initial temperature of ``tests/test_cpts.py`` with
    seeded noise (NOISE_K); salinity 0 (the model's S - 35 psu)."""
    g = grid
    t0 = np.zeros((2, g.km, g.jmt, g.imt))
    lat = np.broadcast_to(g.yt[:, None], (g.jmt, g.imt))
    sst = np.maximum(29.0 * np.cos(np.deg2rad(lat)) ** 2 - 1.93, -1.93)
    t0[0] = np.where(np.abs(lat)[None] > 60, -1.93,
                     sst[None] * np.exp(-np.asarray(g.zt) / 800e2)
                     [:, None, None])
    t0[0] += NOISE_K * np.random.default_rng(1).standard_normal(
        t0[0].shape)
    return t0 * np.asarray(tmask)


def run_both(option):
    """Both packages' models and their states after NSEG segments from
    the same initial state, on one intra-op thread (a segment is ~10^5
    small operations, which a thread pool slows down when other test
    processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jm = JCoupled(config(j_small_config, option))
        tm = CoupledModel(config(small_config, option), device="cpu")
        t0 = initial_t(jm.grid, jm.topo.tmask)
        rec = {}
        gosbc, core = jm.gosbc, jm._segment_core

        def gosbc_rec(*a, **k):
            f = gosbc(*a, **k)
            rec["traced"] = {k: getattr(f, k) for k in tm.forcing_names}
            return f

        def core_rec(st, sc):
            new, diag = core(st, sc)
            diag["forcing"] = rec.pop("traced")
            return new, diag

        jitted = jax.jit(core_rec)

        def segment(st, sc):
            new, diag = jitted(st, sc)
            rec["forcing"] = {k: np.asarray(v)
                              for k, v in diag.pop("forcing").items()}
            return new, diag

        jm.gosbc = gosbc_rec
        jm._segment_jit = segment
        js = jm.run(jm.init_state(t0.copy()), NSEG)
        ts = tm.run(tm.init_state(t0.copy()), NSEG)
        return dict(jm=jm, js=js, tm=tm, ts=ts, forcing=rec["forcing"])
    finally:
        torch.set_num_threads(threads)


def close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


def check_state(r):
    got = coupled_state_to_numpy(r["ts"])
    ref = _flatten_state(r["js"])
    assert set(got) == set(ref)
    for k in sorted(ref):
        if got[k].dtype.kind == "i":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            close(got[k], ref[k], k)


def check_segment(r):
    tm, jm = r["tm"], r["jm"]
    assert set(r["forcing"]) == set(tm.last_forcing)
    for k, v in r["forcing"].items():
        close(tm.last_forcing[k].numpy(), v, f"forcing {k}")
    assert set(tm.last_acc) == set(jm.last_acc)
    for k, v in jm.last_acc.items():
        close(tm.last_acc[k].numpy(), v, f"acc {k}")
    assert tm.relyr == jm.relyr == NSEG * 5.0 / 360.0


_RUNS = {}


def cached_run(option):
    """run_both of an option, once per test process."""
    if option not in _RUNS:
        _RUNS[option] = run_both(OPTIONS[option])
    return _RUNS[option]


@pytest.fixture(scope="module", params=sorted(OPTIONS))
def runs(request):
    return request.param, cached_run(request.param)


@pytest.fixture(scope="module")
def cpts_run():
    return cached_run("cpts")


def test_option_segments_match_reference(runs):
    option, r = runs
    check_state(r)
    check_segment(r)
    ts = r["ts"]
    assert bool(torch.isfinite(ts.ocean.t).all())
    assert float(ts.ice.hice.max()) > 1.0            # ice formed
    if option == "cpts":
        assert ts.cpts is not None
        assert float(ts.cpts.A.max()) > 0.0
        assert float(ts.cpts.E.max()) <= 0.0
        assert float(ts.cpts.A.sum(0).max()) <= 1.0 + 1e-6
    if option == "convect_brine":
        cbf = r["tm"].last_forcing["cbf"]
        assert cbf.shape[0] == 2 and float(cbf.abs().max()) > 0.0


def test_cpts_restarts_cross_both_packages(cpts_run, tmp_path):
    """The port's CPTS restart read by ``uvic_tpu.io.restart`` and written
    back, then read by the port: bitwise, under the reference's keys."""
    r = cpts_run
    jm, tm, ts = r["jm"], r["tm"], r["ts"]
    port_file, ref_file = tmp_path / "port.npz", tmp_path / "ref.npz"
    save_restart(str(port_file), ts)
    with np.load(port_file) as d:
        keys = set(d.files)
    assert {"cpts/A", "cpts/heff", "cpts/hseff", "cpts/Ts", "cpts/E",
            "cpts/uice"} <= keys
    assert keys == set(_flatten_state(r["js"]))
    js = j_load(str(port_file), jm.init_state())
    j_save(str(ref_file), js)
    back = load_restart(str(ref_file), tm.init_state())
    want, got = coupled_state_to_numpy(ts), coupled_state_to_numpy(back)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the reference's own state through the port: bitwise
    j_save(str(ref_file), r["js"])
    ref = _flatten_state(r["js"])
    back = coupled_state_to_numpy(load_restart(str(ref_file),
                                               tm.init_state()))
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_restart_without_cpts_keeps_template(cpts_run, tmp_path):
    r = cpts_run
    tm = r["tm"]
    arrays = {k: v for k, v in coupled_state_to_numpy(r["ts"]).items()
              if not k.startswith("cpts/")}
    path = tmp_path / "no_cpts.npz"
    np.savez(path, **arrays)
    template = tm.init_state()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        state = load_restart(str(path), template)
    assert any("cpts/A" in str(w.message) for w in seen)
    for f in ("A", "heff", "hseff", "Ts", "E", "uice"):
        assert torch.equal(getattr(state.cpts, f),
                           getattr(template.cpts, f)), f
    np.testing.assert_array_equal(state.ocean.t.numpy(),
                                  arrays["ocean/t"])
    # the reference does the same with the same file
    js = j_load(str(path), r["jm"].init_state())
    np.testing.assert_array_equal(np.asarray(js.cpts.A),
                                  template.cpts.A.numpy())


def test_convert_carries_a_reference_cpts_state(cpts_run):
    r = cpts_run
    state = coupled_state_from_numpy(_flatten_state(r["js"]),
                                     r["tm"].init_state())
    for f in ("A", "heff", "hseff", "Ts", "E", "uice"):
        np.testing.assert_array_equal(getattr(state.cpts, f).numpy(),
                                      np.asarray(getattr(r["js"].cpts, f)))


@pytest.mark.parametrize("ice", [dict(cpts=3), dict(enabled=False)])
def test_brine_needs_the_zero_layer_ice(ice):
    cfg = small_config()
    cfg = cfg.replace(ocean=dataclasses.replace(cfg.ocean,
                                                convect_brine=True),
                      ice=dataclasses.replace(cfg.ice, **ice))
    with pytest.raises(ValueError):
        CoupledModel(cfg, device="cpu")


def test_accelerated_stability_report_matches_reference():
    """The stability monitor under acceleration: its local CFL limits take
    dtmax = max(dtuv, dtts*dtxcel) by level (stab.F:90-96)."""
    from uvic_tpu.diag.stability import StabilityMonitor as JStability
    from uvic_tpu_torch.diag.stability import StabilityMonitor
    r = cached_run("accel4")
    assert float(r["tm"].ocean.g.dtxcel.max()) == 4.0
    got = StabilityMonitor(r["tm"].ocean).check(r["ts"].ocean)
    ref = JStability(r["jm"].ocean).check(r["js"].ocean)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("_at"):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= TOL * max(abs(v), 1e-30), k
    assert StabilityMonitor(r["tm"].ocean).report(r["ts"].ocean) \
        == JStability(r["jm"].ocean).report(r["js"].ocean)
