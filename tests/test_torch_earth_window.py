"""The port's committed climate window: ten unaccelerated float32 years of
the earth model on the card from the year-1060 restart of lineage
``r5accept`` (``earth_accept/``), logged by ``python3 -m
uvic_tpu_torch.spinup 10 --resume`` as ``earth_accept_torch/
window_log.jsonl`` and made into ``earth_run_torch.json`` by
``scripts/make_earth_run_json.py`` (last 10 years).

- ``select_window``'s integrity rules hold for the log (contiguous
  years, one run id, accel 1), and the artifact holds that window;
- the artifact's drift recomputes from its own yearly series;
- the climate criteria that ``earth_run.json`` meets (``VERDICT.md:
  20-22,307``): |dSAT/dt| < 0.05 degC/decade, |mean TOA| < 0.5 W/m^2,
  mean ``toa_audit_resid_wm2`` <= 0.1 W/m^2;
- each year's ``sat_gm``, ``sst_gm`` and ``amoc_sv`` lie within 3 sigma
  of the JAX package's row of the same year (``earth_spinup/
  spinup_log.jsonl``, run ``r5accept``, years 1061-1070, the last row
  of each year), sigma the detrended year-to-year standard deviation of
  ``earth_accept/window_log.jsonl`` (years 990-1039).

The limits were fixed before the card's run was made.  The drift
criterion fails over these ten years, for the port and for the JAX
package alike; its case is marked so (strict) and the fault recorded in
``ROADMAP.md`` Queue C.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
LOG = ROOT / "earth_accept_torch" / "window_log.jsonl"
ARTIFACT = ROOT / "earth_run_torch.json"
JAX_LOG = ROOT / "earth_spinup" / "spinup_log.jsonl"
JAX_WINDOW = ROOT / "earth_accept" / "window_log.jsonl"
YEARS = list(range(1061, 1071))
DRIFT_LIMIT = 0.05          # degC/decade
TOA_LIMIT = 0.5             # W/m^2
AUDIT_LIMIT = 0.1           # W/m^2
SIGMA = dict(sat_gm=0.060, sst_gm=0.019, amoc_sv=0.89)
LIMITS = dict(sat_gm=0.18, sst_gm=0.058, amoc_sv=2.7)     # 3 sigma


def _rows(path):
    return [json.loads(x) for x in path.read_text().splitlines()
            if x.startswith("{")]


@pytest.fixture(scope="module")
def make_json():
    spec = importlib.util.spec_from_file_location(
        "make_earth_run_json", ROOT / "scripts" / "make_earth_run_json.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def artifact():
    return json.loads(ARTIFACT.read_text())


def test_window_follows_select_window_rules(make_json, artifact):
    rows = _rows(LOG)
    window = make_json.select_window(rows, len(YEARS))
    assert [r["year"] for r in window] == YEARS
    assert {r["run_id"] for r in window} == set(artifact["run_ids"])
    assert len(artifact["run_ids"]) == 1
    assert {r["accel"] for r in window} == {1.0}
    assert artifact["years"] == len(YEARS)
    assert artifact["year_range"] == [YEARS[0], YEARS[-1]]
    assert artifact["yearly"] == window


def test_drift_recomputes_from_series(artifact):
    years = np.asarray([r["year"] for r in artifact["yearly"]], float)
    sat = np.asarray([r["sat_gm"] for r in artifact["yearly"]], float)
    drift = float(np.polyfit(years, sat, 1)[0] * 10.0)
    assert round(drift, 4) == artifact["sat_drift_degC_per_decade"]
    assert round(float(sat.mean()), 3) == artifact["sat_mean"]


# The SAT drift over these ten years exceeds the limit that the fifty-year
# window meets, for the card (+0.0852 degC/decade) and for the JAX
# package's own rows of the same years (+0.0818, earth_spinup/
# spinup_log.jsonl): recorded in ROADMAP.md Queue C and left standing.
DRIFT_OVER_LIMIT = pytest.mark.xfail(
    strict=True, reason="the ten-year SAT drift exceeds 0.05 degC/decade "
    "for the port and for the JAX package over years 1061-1070 (ROADMAP.md "
    "Queue C)")


@pytest.mark.parametrize("criterion", [
    pytest.param("sat_drift", marks=DRIFT_OVER_LIMIT), "toa_mean",
    "audit_resid_mean"])
def test_climate_criteria(criterion, artifact):
    if criterion == "sat_drift":
        assert abs(artifact["sat_drift_degC_per_decade"]) < DRIFT_LIMIT
    elif criterion == "toa_mean":
        assert abs(artifact["toa_mean_wm2"]) < TOA_LIMIT
    else:
        resid = [r["toa_audit_resid_wm2"] for r in artifact["yearly"]]
        assert float(np.mean(resid)) <= AUDIT_LIMIT


def test_sigma_of_the_jax_window():
    """The limits' sigma: the detrended year-to-year standard deviation
    of the JAX package's acceptance window, as stated."""
    rows = _rows(JAX_WINDOW)
    years = np.asarray([r["year"] for r in rows], float)
    for key, sigma in SIGMA.items():
        v = np.asarray([r[key] for r in rows], float)
        resid = v - np.polyval(np.polyfit(years, v, 1), years)
        assert float(resid.std(ddof=1)) == pytest.approx(sigma, rel=0.02), \
            key
        assert LIMITS[key] == pytest.approx(3.0 * sigma, rel=0.02), key


def test_years_within_three_sigma_of_jax(artifact):
    jax = {}
    for r in _rows(JAX_LOG):
        if r.get("run_id") == "r5accept" and r["year"] in YEARS:
            jax[r["year"]] = r          # last write wins
    assert sorted(jax) == YEARS
    for r in artifact["yearly"]:
        for key, lim in LIMITS.items():
            assert abs(r[key] - jax[r["year"]][key]) <= lim, \
                (r["year"], key, r[key], jax[r["year"]][key])
