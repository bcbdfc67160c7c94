"""The port's spin-up driver (``uvic_tpu_torch.spinup``) against the JAX
package's ``scripts/spinup_earth.py`` (loaded by path), on the CPU in
float64.

The model is the earth configuration (``earth_config(accel=...)``, the
real-Earth topography) on the small grid of ``small_config``, with the
EMBM solves run to convergence in both packages (``solver_tol`` 1e-13,
1000 trips, as ``test_torch_coupled.py`` does), from each package's
``init_state()``:

- ``yearly_diags`` on the same accumulated fields (seeded random sums)
  and the same state: every key of the row, in the script's order; with
  ``round`` taken out of both modules the quantities agree to rtol 1e-9,
  and rounded they agree to within one unit of each key's rounding;
- the year loop (``run_years``) over a "year" of two segments, at accel
  1 and 4, against the script's own loop body run the same way with the
  script's ``yearly_diags``: every quantity of the row to rtol 1e-9 (the
  audit's drift to 1e-9 of the energy it differences);
- ``main`` writes ``restart.npz``, ``restart_meta.json`` and the log,
  and a ``--resume`` run continues from them: the year, relyr and accel
  of the meta, and the resumed run's end state equal to a continuous
  run's, bitwise.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from uvic_tpu.config import earth_config as j_earth_config
from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.coupler.driver import CoupledModel as JCoupled
from uvic_tpu.diag.conservation import FullAudit as JAudit
from uvic_tpu.io.restart import _flatten_state

import uvic_tpu_torch.spinup as spinup
from uvic_tpu_torch.config import earth_config, small_config
from uvic_tpu_torch.convert import (coupled_state_from_numpy,
                                    coupled_state_to_numpy)
from uvic_tpu_torch.coupler.driver import CoupledModel
from uvic_tpu_torch.io.restart import load_restart
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "spinup_earth.py"
CONVERGED = dict(solver_tol=1e-13, solver_maxiter=1000)
RTOL = 1e-9
SEGMENTS = 2
# digits of each rounded key of the row (scripts/spinup_earth.py)
DIGITS = dict(moc_res_max=1, moc_res_min=1, amoc_sv=1, sat_gm=3, sst_gm=3,
              toa_gm=3, ohf_gm=3, ice_nh_min=2, ice_nh_max=2, ice_sh_min=2,
              ice_sh_max=2, psi_max=1, acc_drake_sv=1, moc_max=1,
              moc_min=1, moc_max_exeq=1, moc_min_exeq=1, dE_wm2=3,
              toa_audit_resid_wm2=3)


def _unrounded(x, ndigits=None):
    return x


@pytest.fixture(scope="module")
def script(tmp_path_factory):
    """scripts/spinup_earth.py as a module, its compilation cache off."""
    import uvic_tpu
    saved = uvic_tpu.enable_compile_cache
    uvic_tpu.enable_compile_cache = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location("spinup_earth",
                                                      SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        uvic_tpu.enable_compile_cache = saved
    return mod


def _configs(accel):
    def build(earth, small):
        c = earth(dtype="float64", accel=accel)
        return c.replace(grid=small().grid,
                         embm=dataclasses.replace(c.embm, **CONVERGED))
    return build(j_earth_config, j_small_config), \
        build(earth_config, small_config)


def _models(accel):
    jc, tc = _configs(accel)
    return JCoupled(jc, topo_kind="earth"), \
        CoupledModel(tc, topo_kind="earth", device="cpu")


def _weights(jm):
    """The script's area weights (its ``main``)."""
    g = jm.grid
    lat = np.asarray(g.yt)
    area = (np.asarray(g.cst)[:, None] * np.asarray(g.dyt)[:, None]
            * np.asarray(g.dxt)[None, :])
    area[:, 0] = 0.0
    area[:, -1] = 0.0
    oarea = area * np.asarray(jm.embm.tmsk)
    return dict(area=area, oarea=oarea, lat=lat,
                nh=(lat > 0)[:, None] * oarea, sh=(lat < 0)[:, None] * oarea)


def _assert_rows_close(got, ref, rtol, scales=None):
    assert list(got) == list(ref)
    for k, want in ref.items():
        if k in ("wall_s", "run_id"):
            continue
        if isinstance(want, list):
            np.testing.assert_allclose(got[k], want, rtol=rtol, err_msg=k)
        elif isinstance(want, float) and scales and k in scales:
            assert abs(got[k] - want) <= rtol * scales[k], (k, got[k], want)
        else:
            np.testing.assert_allclose(got[k], want, rtol=rtol, atol=0,
                                       err_msg=k)


def test_yearly_diags_matches_script(script, monkeypatch):
    jm, tm = _models(4.0)
    js = jm.init_state()
    ts = coupled_state_from_numpy(_flatten_state(js), tm.init_state())
    g = jm.grid
    rng = np.random.default_rng(11)
    km, jmt, imt = g.km, g.jmt, g.imt
    acc_sum = dict(toa_sw=rng.uniform(1e12, 3e12, (jmt, imt)),
                   olr=rng.uniform(1e12, 3e12, (jmt, imt)),
                   heat=rng.normal(0.0, 1e11, (jmt, imt)),
                   time=np.asarray(8.64e6))
    v_ann = rng.normal(0.0, 1.0, (km, jmt, imt))
    psi_ann = rng.normal(0.0, 3e13, (jmt, imt))
    vgm_ann = rng.normal(0.0, 0.1, (km, jmt, imt))
    ice = [(float(a), float(b)) for a, b in rng.uniform(0, 20, (12, 2))]
    w = _weights(jm)
    from uvic_tpu_torch.core.earth import atlantic_mask
    amask = atlantic_mask(tm.grid)

    def rows():
        ref = script.yearly_diags(jm, js, acc_sum, v_ann, psi_ann, ice,
                                  w["area"], w["oarea"], w["lat"],
                                  vgm_ann=vgm_ann, amask=amask)
        got = spinup.yearly_diags(tm, ts, acc_sum, v_ann, psi_ann, ice,
                                  w["area"], w["oarea"], w["lat"],
                                  vgm_ann=vgm_ann, amask=amask)
        return got, ref

    got, ref = rows()
    assert "amoc_sv" in ref and "moc_res_max_loc" in ref
    assert list(got) == list(ref)
    for k, want in ref.items():
        if k in DIGITS:
            assert abs(got[k] - want) <= 1.0001 * 10.0 ** -DIGITS[k], k
        else:
            assert got[k] == want, k
    monkeypatch.setattr(script, "round", _unrounded, raising=False)
    monkeypatch.setattr(spinup, "round", _unrounded, raising=False)
    got, ref = rows()
    _assert_rows_close(got, ref, RTOL)


def _script_year(script, jm, state, seg_per_year, accel, audit, E_prev):
    """The body of the script's year loop (its ``main``), for one year of
    ``seg_per_year`` segments."""
    from uvic_tpu.core.earth import atlantic_mask
    w = _weights(jm)
    acc_sum = {}
    v_sum = psi_sum = vgm_sum = None
    ice_samples = []
    yrlen = 360.0
    for s in range(seg_per_year):
        state = jm.run_segment(state)
        jm.relyr += jm.cfg.time.segtim_days / yrlen
        for k in ("toa_sw", "olr", "heat", "time"):
            acc_sum[k] = acc_sum.get(k, 0.0) + np.asarray(
                jm.last_acc[k], np.float64)
        v = np.asarray(jm.last_tavg["v"], np.float64)
        psi = np.asarray(jm.last_tavg["psi"], np.float64)
        v_sum = v if v_sum is None else v_sum + v
        psi_sum = psi if psi_sum is None else psi_sum + psi
        vgm = np.asarray(jm.last_tavg["vntiso"], np.float64)
        vgm_sum = vgm if vgm_sum is None else vgm_sum + vgm
        if s % 6 == 0:
            aice = np.asarray(state.ice.aice)
            ice_samples.append(((aice * w["nh"]).sum() / 1e16,
                                (aice * w["sh"]).sum() / 1e16))
    d = script.yearly_diags(jm, state, acc_sum, v_sum / seg_per_year,
                            psi_sum / seg_per_year, ice_samples, w["area"],
                            w["oarea"], w["lat"],
                            vgm_ann=vgm_sum / seg_per_year,
                            amask=atlantic_mask(jm.grid))
    d["year"] = 1
    d["wall_s"] = 0.0
    d["run_id"] = "ref"
    d["accel"] = accel
    inv = audit.inventories(state)
    E_now = inv["atm_heat_J"] + inv["ocn_heat_J"] \
        - 3.34e9 * 1e-4 * inv["ice_water_kg"]
    earth_area = float(np.asarray(audit.area, np.float64).sum())
    d["dE_wm2"] = (E_now - E_prev) / (yrlen * 86400.0) / earth_area * 1e4
    d["toa_audit_resid_wm2"] = d["toa_gm"] - d["dE_wm2"]
    return d, state, abs(E_now) / (yrlen * 86400.0) / earth_area * 1e4


@pytest.mark.parametrize("accel", [1.0, 4.0])
def test_year_loop_matches_script(accel, script, monkeypatch):
    monkeypatch.setattr(script, "round", _unrounded, raising=False)
    monkeypatch.setattr(spinup, "round", _unrounded, raising=False)
    jm, tm = _models(accel)
    js = jm.init_state()
    ts = coupled_state_from_numpy(_flatten_state(js), tm.init_state())
    audit = JAudit(jm)
    inv = audit.inventories(js)
    E0 = inv["atm_heat_J"] + inv["ocn_heat_J"] \
        - 3.34e9 * 1e-4 * inv["ice_water_kg"]
    ref, js, e_scale = _script_year(script, jm, js, SEGMENTS, accel, audit,
                                    E0)
    rows = []
    ts = spinup.run_years(tm, ts, 1, accel=accel, run_id="port",
                          seg_per_year=SEGMENTS,
                          on_year=lambda d, s: rows.append(d))
    assert len(rows) == 1 and rows[0]["year"] == 1
    assert tm.relyr == jm.relyr == SEGMENTS * 5.0 / 360.0
    _assert_rows_close(rows[0], ref, RTOL,
                       scales=dict(dE_wm2=e_scale,
                                   toa_audit_resid_wm2=e_scale))
    got, want = coupled_state_to_numpy(ts), _flatten_state(js)
    for k in ("ocean/t", "atm/at", "ice/aice"):
        scale = float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= RTOL * scale, k


def test_main_writes_restarts_and_resumes(monkeypatch,
                                          tmp_path, capsys):
    """``main`` on the small earth configuration with one-segment years:
    two years in one run against one year and a ``--resume`` of one
    more."""
    _, tc = _configs(4.0)
    monkeypatch.setattr("uvic_tpu_torch.config.earth_config",
                        lambda accel=1.0: dataclasses.replace(
                            tc, ocean=dataclasses.replace(
                                tc.ocean, dtxcel_deep=float(accel))))
    loop = spinup.run_years
    monkeypatch.setattr(spinup, "run_years",
                        lambda *a, **k: loop(*a, seg_per_year=1, **k))
    args = ["--accel", "4", "--device", "cpu", "--run-id", "t",
            "--save-every", "5"]
    cont, split = tmp_path / "continuous", tmp_path / "split"
    assert spinup.main(["2", "--out", str(cont)] + args) == 0
    assert spinup.main(["1", "--out", str(split)] + args) == 0
    meta = json.loads((split / "restart_meta.json").read_text())
    assert meta == dict(year=1, relyr=5.0 / 360.0, accel=4.0)
    assert spinup.main(["1", "--resume", "--out", str(split)] + args) == 0
    assert "resumed at year 1" in capsys.readouterr().out
    meta = json.loads((split / "restart_meta.json").read_text())
    assert meta == json.loads((cont / "restart_meta.json").read_text())
    assert meta["year"] == 2 and meta["relyr"] == 2 * 5.0 / 360.0

    rows_c = [json.loads(x) for x in
              (cont / "spinup_log.jsonl").read_text().splitlines()]
    rows_s = [json.loads(x) for x in
              (split / "spinup_log.jsonl").read_text().splitlines()]
    assert [r["year"] for r in rows_c] == [r["year"] for r in rows_s] \
        == [1, 2]
    for a, b in zip(rows_c, rows_s):
        assert {k: v for k, v in a.items() if k != "wall_s"} \
            == {k: v for k, v in b.items() if k != "wall_s"}
    template = CoupledModel(tc, topo_kind="earth",
                            device="cpu").init_state()
    a = coupled_state_to_numpy(load_restart(str(cont / "restart.npz"),
                                            template))
    b = coupled_state_to_numpy(load_restart(str(split / "restart.npz"),
                                            template))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_non_finite_year_ends_the_run(monkeypatch):
    _, tc = _configs(1.0)
    tm = CoupledModel(tc, topo_kind="earth", device="cpu")
    state = tm.init_state()
    state.atm.at[0, 5, 5] = float("nan")
    monkeypatch.setattr(spinup, "run_year",
                        lambda m, s, n, w: (
                            s, dict(toa_sw=np.zeros(s.atm.at[0].shape),
                                    olr=np.zeros(s.atm.at[0].shape),
                                    heat=np.zeros(s.atm.at[0].shape),
                                    time=np.asarray(1.0)),
                            np.zeros(tuple(s.ocean.t.shape[1:])),
                            np.zeros(tuple(s.ocean.psi0.shape)),
                            np.zeros(tuple(s.ocean.t.shape[1:])),
                            [(0.0, 0.0)]))
    with pytest.raises(SystemExit, match="non-finite state at year 3"):
        spinup.run_years(tm, state, 1, year0=2)


def test_golden_year_limits_hold_the_float32_members():
    """``golden/regression/spinup_earth_year.json`` is what its generator
    says: each key's limit is 5x the largest gap of the float32 members
    from the float64 row, at least one unit of the key's rounding;
    ``chip_smoke.spinup_out_of_limits`` passes every member's row and
    the float64 row itself, and catches a row moved past one limit."""
    import sys
    sys.path.insert(0, str(ROOT))
    from chip_smoke import spinup_out_of_limits
    golden = json.loads(
        (ROOT / "golden" / "regression" / "spinup_earth_year.json")
        .read_text())
    u64 = golden["unrounded_float64"]
    members = golden["unrounded_float32"]
    assert len(members) >= 5

    def flat(x):
        return x if isinstance(x, list) else [x]

    for key, lim in golden["limit"].items():
        units = flat(golden["rounding"][key])
        gaps = np.max([[abs(a - b) for a, b in zip(flat(r[key]),
                                                   flat(u64[key]))]
                       for r in members], axis=0)
        want = [max(5.0 * g, 10.0 ** -n) for g, n in zip(gaps, units)]
        np.testing.assert_allclose(flat(lim), want, rtol=1e-12)
    for row in members + [golden["row"]]:
        assert spinup_out_of_limits(row, golden) == {}
    moved = dict(golden["row"])
    moved["toa_audit_resid_wm2"] += 1.01 * golden["limit"][
        "toa_audit_resid_wm2"]
    assert set(spinup_out_of_limits(moved, golden)) == {
        "toa_audit_resid_wm2"}
