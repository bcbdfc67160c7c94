"""The port's precision tools (``uvic_tpu_torch.precision_year``,
``uvic_tpu_torch.precision_study``) against the JAX package's
``scripts/precision_year.py`` and ``scripts/precision_study.py`` (loaded
by path), on the CPU in float64.

- ``compare`` of the committed float32 and float64 years gives the
  committed ``golden/precision/divergence.json`` to 1e-15 relative;
- ``run``: two segments of the earth configuration from
  ``init_state()``, each package's tool in float64, the rows within 1e-9
  relative.  The committed ``golden/precision/tsi_year_f64.json`` no
  longer matches the JAX package (sat_gm 2.7e-3 apart at the first
  segment: the earth configuration changed after it was written), so the
  port is held against the JAX package's own run.  Both run on the
  small grid of ``small_config`` with the EMBM solves converged
  (``solver_tol`` 1e-13, 1000 trips, as ``test_torch_spinup.py``): the
  default float64 solve stops unconverged at 200 trips, where the two
  packages' iterates agree to ~1e-8 only;
- ``precision_study``: the physics-only ocean (34x40x8, isopycnal/GM)
  after 8 leapfrog steps in float64, the snapshots of T, u and psi
  within 1e-9 of the script's ``run``, and the drift rows of two
  snapshot sets equal to the script's expressions.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from uvic_tpu_torch import precision_study, precision_year
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PRECISION = ROOT / "golden" / "precision"
CONVERGED = dict(solver_tol=1e-13, solver_maxiter=1000)
RTOL = 1e-9
SEGMENTS = 2


def _script(name):
    spec = importlib.util.spec_from_file_location(
        "script_" + name, ROOT / "scripts" / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compare_reproduces_divergence(capsys):
    got = precision_year.compare(str(PRECISION / "tsi_year_f32.json"),
                                 str(PRECISION / "tsi_year_f64.json"))
    want = json.loads((PRECISION / "divergence.json").read_text())
    assert json.loads(capsys.readouterr().out) == got
    assert {k: got[k] for k in ("segments", "a", "b")} \
        == {k: want[k] for k in ("segments", "a", "b")}
    assert set(got["divergence"]) == set(want["divergence"])
    for key, d in want["divergence"].items():
        assert set(got["divergence"][key]) == set(d)
        for stat, v in d.items():
            assert abs(got["divergence"][key][stat] - v) <= 1e-15 * abs(v), \
                (key, stat)


def _small_earth(earth_config, small_config):
    def cfg(dtype="float32", accel=1.0):
        c = earth_config(dtype=dtype, accel=accel)
        return c.replace(grid=small_config().grid,
                         embm=dataclasses.replace(c.embm, **CONVERGED))
    return cfg


def test_year_rows_match_script(monkeypatch, tmp_path, capsys):
    import uvic_tpu.config as jcfg
    import uvic_tpu_torch.config as tcfg
    script = _script("precision_year")
    monkeypatch.setattr(jcfg, "earth_config",
                        _small_earth(jcfg.earth_config, jcfg.small_config))
    monkeypatch.setattr(tcfg, "earth_config",
                        _small_earth(tcfg.earth_config, tcfg.small_config))
    years = SEGMENTS * 5.0 / 365.0
    script.run("float64", str(tmp_path / "jax.json"), years)
    assert precision_year.main(["run", "float64", str(tmp_path / "port.json"),
                                str(years), "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got["dtype"] == want["dtype"] == "float64"
    assert len(got["rows"]) == len(want["rows"]) == SEGMENTS
    for a, b in zip(got["rows"], want["rows"]):
        assert list(a) == list(b) and a["seg"] == b["seg"]
        for k in precision_year.KEYS:
            assert abs(a[k] - b[k]) <= RTOL * max(abs(b[k]), 1e-30), \
                (a["seg"], k, a[k], b[k])
    assert "wrote" in capsys.readouterr().out


@pytest.fixture(scope="module")
def study_runs():
    script = _script("precision_study")
    jm, jsnaps = script.run("float64", 8, False)
    tm, tsnaps = precision_study.run("float64", 8, False, device="cpu")
    return jm, jsnaps, tm, tsnaps


def test_study_snapshots_match_script(study_runs):
    _, jsnaps, _, tsnaps = study_runs
    assert sorted(jsnaps) == sorted(tsnaps) == [2, 4, 8]
    for n in jsnaps:
        for k in ("t", "u", "psi"):
            want, got = jsnaps[n][k], tsnaps[n][k]
            scale = float(np.abs(want).max())
            assert scale > 0.0
            assert float(np.abs(got - want).max()) <= RTOL * scale, (n, k)


def test_study_rows_are_the_scripts(study_runs):
    """The drift rows of the port's float64 snapshots against the JAX
    package's, by the port's ``drift_rows`` and by the script's
    expressions (``scripts/precision_study.py:77-102``)."""
    jm, jsnaps, tm, tsnaps = study_runs
    got = precision_study.drift_rows(tm, jsnaps, tsnaps, False)
    wet = np.asarray(jm.params.topo.tmask) > 0
    for row, n in zip(got, sorted(jsnaps)):
        a, b = jsnaps[n], tsnaps[n]
        dt_ = np.abs(a["t"] - b["t"])
        scale_T = max(np.abs(a["t"][0][wet]).max(), 1e-12)
        want = dict(
            step=int(n),
            temp_max_err=float(dt_[0][wet].max()),
            temp_rel=float(dt_[0][wet].max() / scale_T),
            salt_max_err=float(dt_[1][wet].max()),
            u_rel=float(np.abs(a["u"] - b["u"]).max()
                        / max(np.abs(a["u"]).max(), 1e-12)),
            psi_rel=float(np.abs(a["psi"] - b["psi"]).max()
                          / max(np.abs(a["psi"]).std(), 1e-12)))
        assert row == want
