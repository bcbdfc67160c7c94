"""The port's production run loop (``coupler/run.py``) against
``uvic_tpu.coupler.run`` on the CPU, in float64.

Both packages' ``Run`` drive the same small configuration over 40 days
(8 segments; tsi every 5 days, time means and restarts every 20, as in
``tests/test_run_loop.py``), with the EMBM solves run to convergence
(``solver_tol`` 1e-13, 1000 trips, as in ``test_torch_coupled.py``):

- the same ``tsi.csv`` rows (1e-9 of each value), the same ``tavg.nc``
  variables, dimensions, attributes and records (float32 values, 1e-6
  of each field's largest value), restarts with the same keys and
  calendar (``__itt``, ``__days``), and the same ``run_summary.json``;
- the conservation audits and the stability report on the end state;
- a split run (20 days, a new ``Run`` resumed from its restart, 20 more)
  equals the continuous one bitwise, and its resume appends a second
  record to ``tavg.nc``;
- a restart of either package resumes the other's ``Run`` with the same
  calendar, and one more segment of each agrees at 1e-9;
- the ``nconv`` abort saves ``restart_abort.npz`` and raises;
- the CLI runs the earth configuration from ``earth_accept/`` on the CPU.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.coupler.driver import CoupledModel as JCoupled
from uvic_tpu.coupler.run import Run as JRun
from uvic_tpu.diag.conservation import ConservationAudit as JAudit
from uvic_tpu.diag.conservation import FullAudit as JFullAudit
from uvic_tpu.diag.stability import StabilityMonitor as JStability
from uvic_tpu.io.netcdf import read_var as j_read_var
from uvic_tpu.io.restart import _flatten_state
from uvic_tpu.io.tavg import TavgAccumulator as JTavg
from uvic_tpu.io.tavg import coupled_tavg_fields as j_coupled_tavg_fields
from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing

from uvic_tpu_torch import run_production
from uvic_tpu_torch.config import small_config
from uvic_tpu_torch.convert import coupled_state_to_numpy
from uvic_tpu_torch.coupler.driver import CoupledModel
from uvic_tpu_torch.coupler.run import Run
from uvic_tpu_torch.diag.conservation import ConservationAudit, FullAudit
from uvic_tpu_torch.diag.stability import StabilityMonitor
from uvic_tpu_torch.io.netcdf import read_var
from uvic_tpu_torch.io.tavg import TavgAccumulator, coupled_tavg_fields
from uvic_tpu_torch.models.ocean.model import make_forcing as t_make_forcing

ROOT = Path(__file__).resolve().parents[1]
RESTART = ROOT / "earth_accept" / "restart.npz"
TOL = 1e-9
TOL_TAVG = 1e-6
DAYS = 40.0
CONVERGED = dict(solver_tol=1e-13, solver_maxiter=1000)
# the convection extent's time means: mixed regions hold exactly equal T
# and S, whose density ties the reference's jitted loop breaks by
# round-off; their records are held against the reference's function
# taken op by op on the port's segment ends (test_torch_coupled.py)
TIES = ("convect_depth", "convect_nreg")


def _cfg(make):
    cfg = make(dtype="float64")
    # tolrsf as loose as tests/test_run_loop.py's: a cold start's first
    # barotropic solves are slow to converge
    return cfg.replace(
        ocean=dataclasses.replace(
            cfg.ocean, isopycmix=False, gent_mcwilliams=False,
            dtts=43200.0, dtuv=1800.0, dtsf=1800.0, tolrsf=1e11),
        embm=dataclasses.replace(cfg.embm, **CONVERGED),
        time=dataclasses.replace(cfg.time, tsiint=5.0, timavgint=20.0,
                                 restint=20.0))


def _port():
    return CoupledModel(_cfg(small_config), device="cpu")


def _rows(path):
    lines = Path(path).read_text().strip().splitlines()
    return lines[0], [line.split(",") for line in lines[1:]]


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("runs")
        jm = JCoupled(_cfg(j_small_config))
        jrun = JRun(jm, str(tmp / "ref"))
        js = jrun.run(jm.init_state(), days=DAYS)
        tm = _port()
        trun = Run(tm, str(tmp / "port"))
        # each segment's end tracers, for the convection extent's records
        ends, inner = [], tm.run

        def segment(state, n, eager=False):
            state = inner(state, n, eager)
            ends.append(state.ocean.t.numpy().copy())
            return state

        tm.run = segment
        try:
            ts = trun.run(tm.init_state(), days=DAYS)
        finally:
            del tm.run

        # split: 20 days, then a new Run resumed from its restart
        m2 = _port()
        Run(m2, str(tmp / "split")).run(m2.init_state(), days=DAYS / 2)
        m3 = _port()
        run3 = Run(m3, str(tmp / "split"))
        s3 = run3.load(m3.init_state())
        split_days = run3.tm.days
        s3 = run3.run(s3, days=DAYS / 2)
        return dict(tmp=tmp, jm=jm, js=js, jrun=jrun, tm=tm, ts=ts,
                    trun=trun, s3=s3, split_days=split_days, ends=ends)
    finally:
        torch.set_num_threads(threads)


def test_tsi_rows_match_reference(runs):
    tmp = runs["tmp"]
    head, rows = _rows(tmp / "port" / "tsi.csv")
    ref_head, ref_rows = _rows(tmp / "ref" / "tsi.csv")
    assert head == ref_head and "nconv" in head
    assert len(rows) == len(ref_rows) == DAYS / 5.0
    for row, ref in zip(rows, ref_rows):
        assert row[0] == ref[0]
        got, want = np.array(row[1:], float), np.array(ref[1:], float)
        assert np.all(np.abs(got - want) <= TOL * np.abs(want)), (row, ref)


def _extent_records(runs):
    """The convection extent's tavg records rebuilt from the reference's
    ``convection_extent`` taken op by op on each of the port's segment
    ends, summed and normalized as ``TavgAccumulator`` does."""
    import jax

    from uvic_tpu.ops.convection import convection_extent
    om = runs["jm"].ocean
    per = round(runs["tm"].cfg.time.timavgint
                / runs["tm"].cfg.time.segtim_days)
    ends = runs["ends"]
    assert len(ends) == DAYS / runs["tm"].cfg.time.segtim_days
    records = {k: [] for k in TIES}
    for first in range(0, len(ends), per):
        sums = None
        for t in ends[first:first + per]:
            with jax.disable_jit():
                depth, nreg = convection_extent(
                    jnp.asarray(t), om.kmt, om.eos_c, om.eos_to,
                    om.eos_so, om.dztxcl, jnp.asarray(om.g.dzt))
            seg = dict(convect_depth=np.asarray(depth, np.float64),
                       convect_nreg=np.asarray(nreg, np.float64))
            if sums is None:
                sums = {k: v.copy() for k, v in seg.items()}
            else:
                for k in TIES:
                    sums[k] += seg[k]
        for k in TIES:
            records[k].append((sums[k] / per).astype(np.float32))
    return {k: np.stack(v) for k, v in records.items()}


def test_tavg_file_matches_reference(runs):
    tmp = runs["tmp"]
    ties = _extent_records(runs)
    assert ties["convect_depth"].max() > 0.0
    got = netcdf_file(str(tmp / "port" / "tavg.nc"), "r", mmap=False)
    ref = netcdf_file(str(tmp / "ref" / "tavg.nc"), "r", mmap=False)
    try:
        assert got.title == ref.title
        assert got.dimensions == ref.dimensions
        assert set(got.variables) == set(ref.variables)
        assert len(got.variables) > 40
        for name, v in ref.variables.items():
            g = got.variables[name]
            assert g.dimensions == v.dimensions, name
            assert g.typecode() == v.typecode(), name
            assert g._attributes == v._attributes, name
            gv, rv = np.array(g[:]), np.array(v[:])
            if name in TIES:
                assert gv.shape == rv.shape
                np.testing.assert_array_equal(gv, ties[name], err_msg=name)
            elif name in ("time", "longitude", "latitude", "depth"):
                np.testing.assert_array_equal(gv, rv, err_msg=name)
            else:
                for rec in range(rv.shape[0]):
                    _close(gv[rec], rv[rec], f"{name}[{rec}]", TOL_TAVG)
        np.testing.assert_array_equal(np.array(got.variables["time"][:]),
                                      [20.0, 40.0])
    finally:
        got.close()
        ref.close()
    # either package reads the other's stream
    np.testing.assert_array_equal(
        j_read_var(str(tmp / "port" / "tavg.nc"), "sat"),
        read_var(str(tmp / "port" / "tavg.nc"), "sat"))


def test_restarts_carry_the_calendar(runs):
    tmp = runs["tmp"]
    with np.load(tmp / "port" / "restart.npz") as d, \
            np.load(tmp / "ref" / "restart.npz") as e:
        assert set(d.files) == set(e.files)
        assert {"__itt", "__days"} <= set(d.files)
        for k in ("__itt", "__days"):
            assert d[k] == e[k] and d[k].dtype == e[k].dtype, k
    assert runs["trun"].tm.days == runs["jrun"].tm.days == DAYS


def test_run_summary_matches_reference(runs):
    tmp = runs["tmp"]
    got = json.loads((tmp / "port" / "run_summary.json").read_text())
    ref = json.loads((tmp / "ref" / "run_summary.json").read_text())
    assert set(got) == set(ref) == {"stamp", "days", "itt", "drift"}
    assert (got["stamp"], got["days"], got["itt"]) \
        == (ref["stamp"], ref["days"], ref["itt"])
    assert set(got["drift"]) == set(ref["drift"])
    for k, v in ref["drift"].items():
        assert abs(got["drift"][k] - v) <= TOL, k


@pytest.mark.parametrize("deterministic", [True, False])
def test_conservation_audit_matches_reference(deterministic, runs):
    got = ConservationAudit(runs["tm"].ocean, deterministic).inventories(
        runs["ts"].ocean)
    ref = JAudit(runs["jm"].ocean, deterministic).inventories(
        runs["js"].ocean)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= TOL * abs(ref[k]), k


def test_full_audit_matches_reference(runs):
    tm, jm = runs["tm"], runs["jm"]
    got = FullAudit(tm).inventories(runs["ts"], co2ccn=300.0)
    ref = JFullAudit(jm).inventories(runs["js"], co2ccn=300.0)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= TOL * abs(ref[k]), k
    # the ocean's closure: the end state's step against seeded fluxes
    rng = np.random.default_rng(1)
    shape = tuple(runs["ts"].ocean.t.shape[2:])
    smf = np.zeros((2,) + shape)
    stf = rng.normal(size=(2,) + shape) * np.array([1e-6, 1e-9])[:, None,
                                                                 None]
    before = runs["ts"].ocean.tm1.numpy()
    after = runs["ts"].ocean.t.numpy()
    dtts = tm.cfg.ocean.dtts
    got = FullAudit(tm).ocean_closure(
        torch.as_tensor(before), torch.as_tensor(after),
        t_make_forcing(torch.as_tensor(smf), torch.as_tensor(stf)), 1, dtts)
    ref = JFullAudit(jm).ocean_closure(
        jnp.asarray(before), jnp.asarray(after),
        j_make_forcing(jnp.asarray(smf), jnp.asarray(stf)), 1, dtts)
    assert set(got) == set(ref) == {"temp", "salt"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= TOL * abs(ref[k]), k


def test_stability_report_matches_reference(runs):
    got = StabilityMonitor(runs["tm"].ocean).check(runs["ts"].ocean)
    ref = JStability(runs["jm"].ocean).check(runs["js"].ocean)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("_at"):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= TOL * max(abs(v), 1e-30), k
    assert StabilityMonitor(runs["tm"].ocean).report(runs["ts"].ocean) \
        == JStability(runs["jm"].ocean).report(runs["js"].ocean)


def test_tavg_accumulator_matches_reference():
    rng = np.random.default_rng(0)
    snaps = [dict(a=rng.normal(size=(3, 4)), b=rng.normal(size=(2, 3, 4)))
             for _ in range(3)]
    got, ref = TavgAccumulator(), JTavg()
    for s in snaps:
        got.accumulate({k: torch.as_tensor(v) for k, v in s.items()})
        ref.accumulate({k: jnp.asarray(v) for k, v in s.items()})
    g, r = got.normalize(), ref.normalize()
    for k in r:
        np.testing.assert_array_equal(g[k], r[k])
    assert got.normalize() == {} and got.n == 0


def test_tavg_snapshot_fields_match_reference(runs):
    got = coupled_tavg_fields(runs["tm"], runs["ts"])
    ref = j_coupled_tavg_fields(runs["jm"], runs["js"])
    assert set(got) == set(ref)
    for k, v in ref.items():
        _close(got[k].numpy(), v, k)


def test_split_run_equals_continuous(runs):
    tmp = runs["tmp"]
    assert runs["split_days"] == DAYS / 2
    want, got = coupled_state_to_numpy(runs["ts"]), \
        coupled_state_to_numpy(runs["s3"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (tmp / "split" / "tsi.csv").read_text() \
        == (tmp / "port" / "tsi.csv").read_text()


def test_resume_appends_a_tavg_record(runs):
    tmp = runs["tmp"]
    np.testing.assert_array_equal(read_var(str(tmp / "split" / "tavg.nc"),
                                           "time"), [20.0, 40.0])
    np.testing.assert_array_equal(
        read_var(str(tmp / "split" / "tavg.nc"), "temp"),
        read_var(str(tmp / "port" / "tavg.nc"), "temp"))


def test_restarts_resume_across_packages(runs, tmp_path):
    """The reference's end restart resumes the port's Run, the port's
    resumes the reference's; one more segment of each agrees."""
    src = runs["tmp"]
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    shutil.copy(src / "ref" / "restart.npz", tmp_path / "port")
    shutil.copy(src / "port" / "restart.npz", tmp_path / "ref")
    tm, jm = _port(), runs["jm"]
    trun, jrun = Run(tm, str(tmp_path / "port")), \
        JRun(jm, str(tmp_path / "ref"))
    ts, js = trun.load(tm.init_state()), jrun.load(jm.init_state())
    assert (trun.tm.itt, trun.tm.days) == (jrun.tm.itt, jrun.tm.days) \
        == (int(runs["js"].ocean.itt), DAYS)
    assert tm.relyr == jm.relyr == DAYS / 360.0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ts = trun.run(ts, nseg=1)
    finally:
        torch.set_num_threads(threads)
    js = jrun.run(js, nseg=1)
    _, rows = _rows(tmp_path / "port" / "tsi.csv")
    _, ref_rows = _rows(tmp_path / "ref" / "tsi.csv")
    assert len(rows) == len(ref_rows) == 1 and rows[0][0] == "45.0000"
    got, want = np.array(rows[0][1:], float), np.array(ref_rows[0][1:], float)
    assert np.all(np.abs(got - want) <= TOL * np.abs(want))
    ref = _flatten_state(js)
    for k, v in coupled_state_to_numpy(ts).items():
        if v.dtype.kind == "i":
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        else:
            _close(v, ref[k], k)


def test_nconv_abort(tmp_path):
    """More than 50 solver failures: the state is saved and the run
    raises (tropic.F:249)."""
    m = _port()
    run = Run(m, str(tmp_path))
    state = m.init_state()
    state.ocean.nconv = torch.tensor(51, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="barotropic solver failed"):
        run.run(state, days=5.0)
    assert (tmp_path / "restart_abort.npz").exists()
    assert not (tmp_path / "restart.npz").exists()


def test_cli_runs_the_earth_configuration_on_the_cpu(tmp_path, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        code = run_production.main([
            "--earth", "--from-restart", str(RESTART), "--device", "cpu",
            "--years", str(5.0 / 360.0), "--tsiint", "5",
            "--outdir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    assert code == 0
    out = capsys.readouterr().out
    assert "seeded from" in out and "model years" in out
    relyr = json.loads((RESTART.parent / "restart_meta.json").read_text())[
        "relyr"]
    _, rows = _rows(tmp_path / "tsi.csv")
    assert len(rows) == 1
    assert rows[0][0] == f"{relyr * 360.0 + 5.0:.4f}"
    assert np.isfinite(np.array(rows[0][1:], float)).all()
    with np.load(tmp_path / "restart.npz") as d:
        assert float(d["__days"]) == relyr * 360.0 + 5.0
    assert "drift" in json.loads((tmp_path / "run_summary.json").read_text())


def test_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_production.main(["--outdir", str(tmp_path)])
