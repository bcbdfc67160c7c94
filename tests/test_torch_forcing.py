"""The port's transient forcing and anomalous-wind feedback against
``uvic_tpu`` on the CPU, in float64.

- Every default series, ``TransientForcing.at`` over a range of years,
  ``sulphate_pattern`` and ``landice_fields`` equal the reference's
  bitwise (NumPy code, copied).
- Two coupled segments of the small configuration under a transient
  forcing that changes from one segment to the next (CO2 rising
  steeply, a volcanic drop, the sulphate scale above 0, extra GHG
  forcing and the ice sheets crossing their 0.5 extent threshold) agree
  with the reference after each segment at 1e-9 of each field's largest
  value; so do two segments with the anomalous-wind feedback against a
  climatology.  One model runs both segments, so the second takes the
  forcing its stages read from the workspace, not the first's.
- The stages read the forcing from the workspace only: with the model's
  host-side values spoiled, stages fed the workspace give the segment
  bitwise.

The EMBM solves run to convergence in both packages (``solver_tol``
1e-13, 1000 trips), as in ``test_torch_coupled.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.core.earth import landice_fields as j_landice_fields
from uvic_tpu.coupler.driver import CoupledModel as JCoupled
from uvic_tpu.io import forcing as jf
from uvic_tpu.io.restart import _flatten_state
from uvic_tpu.models.embm.winds import slope_s as j_slope_s

from uvic_tpu_torch.config import ModelConfig, small_config
from uvic_tpu_torch.convert import coupled_state_to_numpy
from uvic_tpu_torch.core.earth import landice_fields
from uvic_tpu_torch.core.grid import make_grid
from uvic_tpu_torch.coupler.driver import CoupledModel, pack_state
from uvic_tpu_torch.io import forcing as tf
from uvic_tpu_torch.models.embm.winds import slope_s

TOL = 1e-9
NSEG = 2
CONVERGED = dict(solver_tol=1e-13, solver_maxiter=1000)
YEARS = np.linspace(900.0, 2100.0, 241)
SERIES = ["co2_series", "solar_series", "volcanic_series", "c14_series",
          "agg_series", "sealev_series", "sulphate_series",
          "landice_series"]


def _cfg(make, awind=False):
    cfg = make(dtype="float64")
    return cfg.replace(
        ocean=dataclasses.replace(
            cfg.ocean, isopycmix=False, gent_mcwilliams=False,
            dtts=43200.0, dtuv=1800.0, dtsf=1800.0, tolrsf=1e8),
        embm=dataclasses.replace(cfg.embm, awind=awind, **CONVERGED))


def _forcing(F):
    """Changes within the two segments (years 0 to 0.028 of the small
    configuration's calendar)."""
    S = F.TransientSeries
    return F.TransientForcing(
        co2=S(np.array([0.0, 0.03]), np.array([280.0, 1120.0])),
        solar=S.constant(1.368e6),
        volcanic=S(np.array([0.0, 0.01, 0.02]), np.array([0.0, 3e4, 0.0])),
        c14=S.constant(0.0),
        sulph=S(np.array([0.0, 0.03]), np.array([0.01, 0.05])),
        agg=S(np.array([0.0, 0.03]), np.array([0.0, 2e3])),
        landice=S(np.array([0.0, 0.03]), np.array([0.4, 1.0])))


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


def _close_states(ts, js, what):
    got, ref = coupled_state_to_numpy(ts), _flatten_state(js)
    assert set(got) == set(ref)
    for k in got:
        if got[k].dtype.kind == "i":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            _close(got[k], ref[k], f"{what} {k}")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", SERIES)
def test_default_series_equal_reference(name):
    got, ref = getattr(tf, name)(), getattr(jf, name)()
    np.testing.assert_array_equal(got.times, ref.times)
    np.testing.assert_array_equal(got.values, ref.values)
    assert [got.at(y) for y in YEARS] == [ref.at(y) for y in YEARS]


@pytest.mark.parametrize("which,hemisphere", [(11, "n"), (11, "s"),
                                              (12, "n"), (12, "s")])
def test_cfc_series_equal_reference(which, hemisphere):
    got = tf.cfc_series(which, hemisphere)
    ref = jf.cfc_series(which, hemisphere)
    assert [got.at(y) for y in YEARS] == [ref.at(y) for y in YEARS]


def test_transient_forcing_at_equals_reference(tmp_path):
    got, ref = tf.TransientForcing.default(), jf.TransientForcing.default()
    for y in YEARS:
        assert got.at(y) == ref.at(y), y
    # the file readers: a CSV table and a constant
    path = tmp_path / "co2.csv"
    np.savetxt(path, np.array([[1800.0, 283.0], [1900.0, 296.0]]),
               delimiter=",")
    got_csv = tf.TransientSeries.from_csv(str(path))
    ref_csv = jf.TransientSeries.from_csv(str(path))
    assert [got_csv.at(y) for y in YEARS] == [ref_csv.at(y) for y in YEARS]
    assert tf.TransientSeries.constant(3.0).at(1e4) == 3.0


def test_sulphate_pattern_and_landice_fields_bitwise():
    grid = make_grid(ModelConfig().grid)
    np.testing.assert_array_equal(
        tf.sulphate_pattern(grid.yt, imt=grid.imt),
        jf.sulphate_pattern(grid.yt, imt=grid.imt))
    for scale in (0.0, 0.3, 0.5, 0.75, 1.0):
        for got, ref in zip(landice_fields(grid, scale),
                            j_landice_fields(grid, scale)):
            np.testing.assert_array_equal(got, ref)
    aicel, hicel = landice_fields(grid, 1.0)
    assert aicel.sum() > 50 and hicel.max() == 2500.0e2
    lat = np.linspace(-89.0, 89.0, 60)
    np.testing.assert_array_equal(slope_s(lat), j_slope_s(lat))


@pytest.fixture(scope="module")
def transient(one_thread):
    jm = JCoupled(_cfg(j_small_config))
    tm = CoupledModel(_cfg(small_config), device="cpu")
    jm.set_transient_forcing(_forcing(jf))
    tm.set_transient_forcing(_forcing(tf))
    js, ts = jm.init_state(), tm.init_state()
    steps = []
    for _ in range(NSEG):
        js, ts = jm.run(js, 1), tm.run(ts, 1)
        steps.append(dict(js=js, ts=ts, inputs=tm.segment_inputs(),
                          tavg=dict(tm.last_tavg), ref_tavg=jm.last_tavg,
                          host={k: getattr(tm, k) for k in (
                              "co2ccn", "anthro", "solar_scale",
                              "dc14ccn", "sealev")},
                          ref={k: getattr(jm, k) for k in (
                              "co2ccn", "anthro", "solar_scale",
                              "dc14ccn", "sealev")}))
    return dict(jm=jm, tm=tm, steps=steps)


@pytest.mark.parametrize("seg", range(NSEG))
def test_transient_segments_match_reference(seg, transient):
    step = transient["steps"][seg]
    assert step["host"] == step["ref"]
    _close_states(step["ts"], step["js"], f"segment {seg}")


def test_transient_forcing_changes_between_segments(transient):
    first, second = transient["steps"]
    assert second["host"]["co2ccn"] > first["host"]["co2ccn"] + 100.0
    assert first["host"]["solar_scale"] != second["host"]["solar_scale"]
    tm, jm = transient["tm"], transient["jm"]
    # the ice sheets crossed their 0.5 extent threshold in the second
    # segment's forcing (the reference switches None <-> arrays; the
    # port keeps the fields, zero in the first)
    assert float(first["inputs"]["aicel"].max()) == 0.0
    assert float(second["inputs"]["aicel"].max()) == 1.0
    np.testing.assert_array_equal(tm.landice[0].numpy(),
                                  np.asarray(jm.landice[0]))
    np.testing.assert_array_equal(tm.sulph.numpy(), np.asarray(jm.sulph))
    # the segments' time means; the convection extent of the end state
    # against the reference's function taken op by op (its jitted loop
    # breaks exact density ties by round-off, test_torch_coupled.py)
    from uvic_tpu.ops.convection import convection_extent
    om = jm.ocean
    for step in (first, second):
        assert set(step["tavg"]) == set(step["ref_tavg"])
        for k, v in step["ref_tavg"].items():
            if not k.startswith("convect_"):
                _close(step["tavg"][k].numpy(), v, f"tavg {k}")
        with jax.disable_jit():
            depth, nreg = convection_extent(
                jnp.asarray(step["ts"].ocean.t.numpy()), om.kmt, om.eos_c,
                om.eos_to, om.eos_so, om.dztxcl, jnp.asarray(om.g.dzt))
        np.testing.assert_array_equal(
            step["tavg"]["convect_depth"].numpy(), np.asarray(depth))
        np.testing.assert_array_equal(
            step["tavg"]["convect_nreg"].numpy(), np.asarray(nreg))


def test_stages_read_the_forcing_from_the_workspace(transient):
    """One segment from the first's end state: taken by ``run_segment``,
    and taken stage by stage on a workspace filled before the model's
    host-side forcing is spoiled; bitwise equal."""
    tm = transient["tm"]
    start = transient["steps"][0]["ts"]
    relyr = tm.relyr
    want = tm.run_segment(start)
    ws = pack_state(start)
    ws.update(tm.segment_inputs())
    keep = {k: getattr(tm, k) for k in ("co2ccn", "anthro", "solar_scale",
                                        "relyr", "sulph", "landice")}
    try:
        for k in ("co2ccn", "anthro", "solar_scale", "relyr"):
            setattr(tm, k, math.nan)
        tm.sulph = tm.landice = None
        host = dict(itt=start.ocean.itt, nats=start.atm.nats,
                    land=start.land is not None)
        for name, flag in tm.schedule(host):
            ws.update(tm.stage(name, flag, ws, host))
    finally:
        for k, v in keep.items():
            setattr(tm, k, v)
    assert tm.relyr == relyr
    got = pack_state(want)
    for k, v in got.items():
        assert torch.equal(ws[k], v), k


@pytest.fixture(scope="module")
def awind(one_thread):
    jm = JCoupled(_cfg(j_small_config, awind=True))
    tm = CoupledModel(_cfg(small_config, awind=True), device="cpu")
    js, ts = jm.init_state(), tm.init_state()
    assert tm.awind is not None and tm.awind.t_clim is None
    assert "awind_clim" not in tm.segment_inputs()
    # a climatology 2 K colder than the start, with a zonal wave: warm
    # anomalies everywhere, pressure gradients in both directions
    sat = np.asarray(js.atm.at[0])
    clim = sat - 2.0 + 0.5 * np.sin(np.arange(sat.shape[1]))[None, :]
    jm.awind.set_climatology(clim)
    tm.awind.set_climatology(clim)
    steps = []
    for _ in range(NSEG):
        js, ts = jm.run(js, 1), tm.run(ts, 1)
        steps.append((js, ts))
    w2 = tm.awind.apply(ts.atm.at[0], tm.embm.winds, tm.taux_w, tm.tauy_w,
                        tm.embm.wspd)
    jw2 = jm.awind.apply(js.atm.at[0], jm.embm.winds, jm.taux_w, jm.tauy_w,
                         jm.embm.wspd)
    return dict(steps=steps, apply=(w2, jw2), tm=tm)


@pytest.mark.parametrize("seg", range(NSEG))
def test_awind_segments_match_reference(seg, awind):
    js, ts = awind["steps"][seg]
    _close_states(ts, js, f"awind segment {seg}")


def test_awind_feedback_matches_reference(awind):
    got, ref = awind["apply"]
    for name, g, r in zip(("winds", "taux", "tauy", "wspd"), got, ref):
        _close(g.numpy(), r, name)
    tm = awind["tm"]
    assert float(torch.abs(got[1] - tm.taux_w).max()) > 0.0
    assert "awind_clim" in tm.segment_inputs()
