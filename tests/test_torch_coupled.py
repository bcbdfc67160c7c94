"""The port's coupled earth segment against ``uvic_tpu`` on the CPU, in
float64.

From ``earth_accept/restart.npz`` (year 1060, the start of
``golden/regression/tsi_10yr_earth_r5.csv``), with ``relyr`` from its
``restart_meta.json``, both packages run two segments of
``CoupledModel(earth_config(), topo_kind="earth")`` (``run``):

- every ocean, atmosphere, ice and land field agrees to 1e-9 of its
  largest value, the counters exactly;
- the tsi row agrees to 1e-9, in both of its summation modes;
- the last segment's time means (``last_tavg``) agree to 1e-9, but for
  the means that pass the state through a threshold (named below);
- a restart written by the port reads back through
  ``uvic_tpu.io.restart`` bitwise, and the other way round;
- the ocean options off the flagship path: their constants and a mixing
  step, on a small grid.

The EMBM solves run to convergence in both packages (``solver_tol``
1e-13, 1000 trips): with the configuration's own float64 settings the
temperature solve stops unconverged at 200 trips, where two correct
implementations agree only to round-off amplified by the solver
(``test_torch_earth.py``, last test).
"""

import dataclasses
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import earth_config as j_earth_config
from uvic_tpu.coupler.driver import CoupledModel as JCoupled
from uvic_tpu.diag.tsi import TsiDiagnostics as JTsi
from uvic_tpu.io.restart import _flatten_state
from uvic_tpu.io.restart import load_restart as j_load
from uvic_tpu.io.restart import save_restart as j_save

from uvic_tpu_torch.config import ModelConfig, earth_config
from uvic_tpu_torch.convert import coupled_state_to_numpy
from uvic_tpu_torch.coupler.driver import CoupledModel
from uvic_tpu_torch.diag.tsi import TsiDiagnostics, TsiWriter
from uvic_tpu_torch.entry import _earth
from uvic_tpu_torch.io.restart import load_restart, save_restart
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RESTART = ROOT / "earth_accept" / "restart.npz"
NSEG = 2
TOL = 1e-9
CONVERGED = dict(solver_tol=1e-13, solver_maxiter=1000)
# means that pass the state through a threshold, with the largest
# difference two segments showed (relative to each field's largest
# value), and the limit held: precipitation and snowfall (condensation
# above rhmax, the 0 C snow line) 4.0e-9; the isopycnal diffusivity and
# bolus velocities (slopes of near-neutral columns) 3.9e-9
THRESHOLD_MEANS = dict(precip=1e-8, psno=1e-8, diff_cbt_eff=1e-8,
                       vetiso=1e-8, vntiso=1e-8, wbtiso=1e-8)


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


@pytest.fixture(scope="module")
def runs():
    # one intra-op thread: a segment is ~10^5 small operations, which a
    # thread pool slows down when other test processes share the cores
    return _runs()


def _runs():
    relyr = json.loads((RESTART.parent / "restart_meta.json").read_text())[
        "relyr"]
    jc = j_earth_config(dtype="float64")
    jc = jc.replace(embm=dataclasses.replace(jc.embm, **CONVERGED))
    jm = JCoupled(jc, topo_kind="earth")
    js = j_load(str(RESTART), jm.init_state())
    jm.relyr = relyr
    js = jm.run(js, NSEG)

    tc = earth_config(dtype="float64")
    tc = tc.replace(embm=dataclasses.replace(tc.embm, **CONVERGED))
    tm, ts = _earth(str(RESTART), device="cpu", cfg=tc)
    assert tm.relyr == relyr
    ts0 = coupled_state_to_numpy(ts)
    ts = tm.run(ts, NSEG)
    return dict(jm=jm, js=js, tm=tm, ts=ts, ts0=ts0, relyr=relyr)


@pytest.mark.parametrize("component", ["ocean", "atm", "ice", "land"])
def test_segments_state_matches_reference(component, runs):
    got = coupled_state_to_numpy(runs["ts"])
    ref = _flatten_state(runs["js"])
    keys = [k for k in got if k.startswith(component + "/")]
    assert keys and set(keys) == {k for k in ref
                                  if k.startswith(component + "/")}
    for k in keys:
        if got[k].dtype.kind == "i":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        elif k == "ocean/t" or k == "ocean/tm1":
            for n in range(got[k].shape[0]):
                _close(got[k][n], ref[k][n], f"{k}[{n}]")
        else:
            _close(got[k], ref[k], k)


def test_segments_advance_clock_and_counters(runs):
    jm, tm, ts = runs["jm"], runs["tm"], runs["ts"]
    assert tm.relyr == jm.relyr == runs["relyr"] + NSEG * 5.0 / 360.0
    assert ts.ocean.itt == int(runs["js"].ocean.itt) \
        == int(runs["ts0"]["ocean/itt"]) + NSEG * tm.ntspos
    assert ts.atm.nats == int(runs["js"].atm.nats)
    assert tm.seg_cg_iters.shape == (tm.ntspos,)
    assert tm.seg_trips.shape == (tm.ntspas, 2)
    assert int(tm.seg_trips.max()) < CONVERGED["solver_maxiter"]


@pytest.mark.parametrize("deterministic", [True, False])
def test_tsi_row_matches_reference(deterministic, runs):
    jm, js, tm, ts = runs["jm"], runs["js"], runs["tm"], runs["ts"]
    ref = JTsi(jm.ocean, jm.embm, deterministic=deterministic).compute(
        js.ocean, js.atm, js.ice)
    got = TsiDiagnostics(tm.ocean, tm.embm,
                         deterministic=deterministic).compute(
        ts.ocean, ts.atm, ts.ice)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= TOL * abs(ref[k]), k


def test_segment_means_match_reference(runs):
    """``last_tavg`` of the second segment.  Besides the threshold means
    above, two are held otherwise: ``tice``, where the ice fraction
    entering the thermodynamics is exactly 0 in one package and
    round-off above it in the other (the surface temperature then
    switches from the SST to the ice solution), on the cells that hold
    ice; and the convection extent of the end state, whose mixed regions
    hold exactly equal T and S, against the reference's function taken
    op by op (``test_torch_earth.py`` shows its jitted loop breaking
    such ties by round-off)."""
    jm, tm = runs["jm"], runs["tm"]
    got, ref = tm.last_tavg, jm.last_tavg
    assert set(got) == set(ref)
    held = {"tice", "convect_depth", "convect_nreg"}
    for k in ref:
        if k not in held:
            _close(got[k].numpy(), ref[k], f"tavg {k}",
                   THRESHOLD_MEANS.get(k, TOL))
    ice = (np.asarray(ref["aice"]) > 1e-6) & (got["aice"].numpy() > 1e-6)
    assert ice.sum() > 100
    _close(got["tice"].numpy()[ice], np.asarray(ref["tice"])[ice],
           "tavg tice on ice")

    from uvic_tpu.ops.convection import convection_extent
    om = jm.ocean
    with jax.disable_jit():
        depth, nreg = convection_extent(
            jnp.asarray(runs["ts"].ocean.t.numpy()), om.kmt, om.eos_c,
            om.eos_to, om.eos_so, om.dztxcl, jnp.asarray(om.g.dzt))
    np.testing.assert_array_equal(got["convect_depth"].numpy(),
                                  np.asarray(depth))
    np.testing.assert_array_equal(got["convect_nreg"].numpy(),
                                  np.asarray(nreg))


def test_restart_round_trips_through_both_packages(runs, tmp_path):
    """The port's restart read by ``uvic_tpu.io.restart`` and written
    back, then read by the port: bitwise, under the reference's keys."""
    jm, tm, ts = runs["jm"], runs["tm"], runs["ts"]
    port_file, ref_file = tmp_path / "port.npz", tmp_path / "ref.npz"
    save_restart(str(port_file), ts)
    with np.load(port_file) as d, np.load(RESTART) as e:
        assert set(d.files) == set(e.files)
    js = j_load(str(port_file), jm.init_state())
    j_save(str(ref_file), js)
    back = load_restart(str(ref_file), tm.init_state())
    want, got = coupled_state_to_numpy(ts), coupled_state_to_numpy(back)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_restart_missing_field_keeps_template(runs, tmp_path):
    tm = runs["tm"]
    with np.load(RESTART) as d:
        arrays = {k: d[k] for k in d.files if k != "land/mneg"}
    path = tmp_path / "partial.npz"
    np.savez(path, **arrays)
    template = tm.init_state()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        state = load_restart(str(path), template)
    assert any("land/mneg" in str(w.message) for w in seen)
    assert torch.equal(state.land.mneg, template.land.mneg)
    assert state.ocean.itt == int(arrays["ocean/itt"])


def test_tsi_writer_rows(runs, tmp_path):
    tm, ts = runs["tm"], runs["ts"]
    row = TsiDiagnostics(tm.ocean, tm.embm).compute(ts.ocean, ts.atm, ts.ice)
    w = TsiWriter(str(tmp_path / "tsi.csv"))
    w.write(381610.0, row)
    w.write(381620.0, row)
    lines = (tmp_path / "tsi.csv").read_text().splitlines()
    with open(ROOT / "golden" / "regression" / "tsi_10yr_earth_r5.csv") as f:
        golden_header = f.readline().strip()
    assert lines[0] == "days," + ",".join(sorted(row))
    assert set(golden_header.split(",")) - set(lines[0].split(",")) \
        == {"nconv"}
    assert len(lines) == 3 and lines[1].startswith("381610.0000,")


@pytest.mark.parametrize("option", ["shortwave", "neptune", "eb",
                                    "tracer_advection", "barotropic"])
def test_coupled_ocean_options_match_jax(option):
    """The coupled model takes every ocean option through its
    ``OceanModel`` (the coupled ice options and brine convection:
    ``test_torch_coupled_options.py``,
    ``test_torch_coupled_ice_options.py``).  On ``small_config`` in
    float64, both packages' coupled models with the option: the option's
    constants of their oceans (the shortwave profile, the Neptune
    velocity, the surface-pressure operator, its free-surface centre and
    its zu filter's rows) bitwise, and one mixing step of their oceans
    (Euler-backward with ``eb``) from the same state to 1e-9."""
    from uvic_tpu.config import small_config as j_small_config
    from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing
    from uvic_tpu_torch.config import small_config
    from uvic_tpu_torch.models.ocean.model import make_forcing
    value = dict(shortwave=True, neptune=True, eb=True,
                 tracer_advection="upstream",
                 barotropic="surface_pressure")[option]
    models = []
    for small, cls, kw in ((j_small_config, JCoupled, {}),
                           (small_config, CoupledModel,
                            dict(device="cpu"))):
        cfg = small().replace(dtype="float64")
        cfg = cfg.replace(ocean=dataclasses.replace(
            cfg.ocean, isopycmix=False, gent_mcwilliams=False,
            tolrsp=1e-12, mxscan=2000, **{option: value}))
        models.append(cls(cfg, **kw).ocean)
    jo, to = models
    consts = dict(shortwave=("divpen",), neptune=("unep",),
                  barotropic=("cf_sp", "fs_diag_unit", "sp_omask"))
    for name in consts.get(option, ()):
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    if option == "barotropic":
        np.testing.assert_array_equal(to.filt_zu.rows.numpy(),
                                      jo.filt_zu.rows)
        np.testing.assert_array_equal(to.filt_zu.mats.numpy(),
                                      np.asarray(jo.filt_zu.mats))
    g = jo.params.grid
    rng = np.random.default_rng(2)
    t0 = np.zeros((2, g.km, g.jmt, g.imt))
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None] \
        + 0.1 * rng.standard_normal(t0[0].shape)
    t0 *= np.asarray(jo.params.topo.tmask)
    smf = 0.5 * rng.standard_normal((2, g.jmt, g.imt))
    stf = np.zeros((jo.nt, g.jmt, g.imt))
    js = jo.step(jo.init_state(t0), j_make_forcing(jnp.asarray(smf),
                                                   jnp.asarray(stf)),
                 leapfrog=False)
    ts = to.step(to.init_state(t0), make_forcing(torch.as_tensor(smf),
                                                 torch.as_tensor(stf)),
                 leapfrog=False)
    for name in ("t", "u", "psi0", "ptd", "ubar"):
        _close(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
               f"{option} {name}")


def test_coupled_model_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        CoupledModel(ModelConfig())
