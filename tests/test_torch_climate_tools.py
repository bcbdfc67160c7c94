"""The port's climate indicators (``uvic_tpu_torch.diag.climate``) and the
row functions of its acceptance, tuning and probe tools against the
expressions of the JAX package's scripts, on the CPU in float64.

Both packages hold the same state, ``earth_accept/restart.npz`` (year
1060) loaded into the tools' earth model (``config.tools_earth_config``
in float64), and the same seeded segment means and flux totals; each
script's expressions are evaluated with the JAX package's model, its
``meridional_overturning``, ``atlantic_mask`` and ``FullAudit`` (the
scripts keep them in closures, so this file carries them and cites
script and line).  Every quantity agrees within 1e-12 relative (of the
largest term it differences, where it differences two).

Then ``run_earth``, ``tune_earth`` and ``probes.year_closure`` are driven
through their ``main(argv)`` with ``--device cpu`` for one segment of
the tools' earth model on the small grid of ``small_config``.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import ModelConfig as JModelConfig
from uvic_tpu.core.earth import atlantic_mask as j_atlantic_mask
from uvic_tpu.coupler.driver import CoupledModel as JCoupled
from uvic_tpu.diag.conservation import FullAudit as JAudit
from uvic_tpu.diag.energy import meridional_overturning as j_moc
from uvic_tpu.io.restart import load_restart as j_load_restart
from uvic_tpu.models.embm import constants as JC
from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing

import uvic_tpu_torch.diag.climate as climate
import uvic_tpu_torch.probes.segment_closure as segment_closure
import uvic_tpu_torch.tune_earth as tune_earth
from uvic_tpu_torch.config import small_config, tools_earth_config
from uvic_tpu_torch.coupler.driver import CoupledModel
from uvic_tpu_torch.diag.conservation import FullAudit
from uvic_tpu_torch.io.restart import load_restart
from uvic_tpu_torch.models.ocean.model import make_forcing
from uvic_tpu_torch.probes import (closure, energy, moc, replay_vs_manual,
                                   toa_decompose, triage, year_closure)
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

RESTART = "earth_accept/restart.npz"
RTOL = 1e-12
ACC = ("heat", "freshwater", "taux", "tauy", "swr", "wspd", "toa_sw", "olr",
       "precip", "psno", "evap", "runoff", "uplwr", "upsens", "upltnt")


def _unrounded(x, ndigits=None):
    return x


def close(got, want, scale=None):
    """Within RTOL of ``scale`` (default |want|), element by element."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k], scale)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            close(a, b, scale)
        return
    s = abs(want) if scale is None else scale
    assert abs(got - want) <= RTOL * max(s, 1e-300), (got, want)


@pytest.fixture(scope="module")
def pair():
    """Both packages' tools earth model in float64 on the year-1060
    state, with the same seeded segment means and flux totals."""
    jc = JModelConfig(dtype="float64")
    jc = jc.replace(
        ocean=dataclasses.replace(
            jc.ocean, isopycmix=True, gent_mcwilliams=True, tidal_kv=True,
            gthflx=True, aniso_visc=True, aniso_zonal=True),
        embm=dataclasses.replace(jc.embm, seasonal=True),
        land=dataclasses.replace(jc.land, enabled=True))
    jm = JCoupled(jc, topo_kind="earth")
    tm = CoupledModel(tools_earth_config("float64"), topo_kind="earth",
                      device="cpu")
    js = j_load_restart(RESTART, jm.init_state())
    ts = load_restart(RESTART, tm.init_state())
    g = jm.grid
    km, jmt, imt = g.km, g.jmt, g.imt
    rng = np.random.default_rng(17)
    acc = {k: rng.normal(0.0, 1e11, (jmt, imt)) for k in ACC}
    acc["toa_sw"] = rng.uniform(1e12, 3e12, (jmt, imt))
    acc["olr"] = rng.uniform(1e12, 3e12, (jmt, imt))
    acc["evap"] = rng.uniform(0.0, 1e-1, (jmt, imt))
    acc["psno"] = rng.uniform(0.0, 1e-2, (jmt, imt))
    acc["time"] = np.asarray(4.32e5 * 2.0)
    v = rng.normal(0.0, 1.0, (km, jmt, imt)) * np.asarray(jm.ocean.umask)
    psi = rng.normal(0.0, 3e13, (jmt, imt))
    jm.last_acc = {k: jnp.asarray(x) for k, x in acc.items()}
    jm.last_tavg = {"v": jnp.asarray(v), "psi": jnp.asarray(psi)}
    tm.last_acc = {k: torch.as_tensor(x) for k, x in acc.items()}
    tm.last_tavg = {"v": torch.as_tensor(v), "psi": torch.as_tensor(psi)}
    return jm, js, tm, ts, acc, v, psi, rng


def _area(g):
    area = (np.asarray(g.cst)[:, None] * np.asarray(g.dyt)[:, None]
            * np.asarray(g.dxt)[None, :])
    area[:, 0] = 0.0
    area[:, -1] = 0.0
    return area


def test_acceptance_row_matches_run_earth(pair):
    """``scripts/run_earth.py:40-97`` (its weights and ``diags``)."""
    jm, js, tm, ts, *_ = pair
    g = jm.grid
    amask = jnp.asarray(j_atlantic_mask(g))
    area_j = jnp.asarray(_area(g))
    lat = np.broadcast_to(np.asarray(g.yt)[:, None], area_j.shape)
    nh = jnp.asarray((lat > 0) * _area(g))
    sh = jnp.asarray((lat < 0) * _area(g))
    tmsk = jm.embm.tmsk
    sst = js.ocean.t[0, 0]
    osum = jnp.sum(tmsk * area_j)
    v_mean = jm.last_tavg["v"]
    moc_g = j_moc(v_mean, jm.ocean.g, jm.ocean.umask)
    moc_atl = j_moc(v_mean, jm.ocean.g, jm.ocean.umask * amask[None])
    deep = jnp.asarray(np.asarray(g.zt) >= 500.0e2)[:, None]
    jlat = jnp.asarray((np.asarray(g.yu) > 20.0)
                       & (np.asarray(g.yu) < 70.0))[None, :]
    a = jm.last_acc
    want = dict(
        sst_mean=float(jnp.sum(sst * tmsk * area_j) / osum),
        sst_trop=float(jnp.max(sst)),
        sat_mean=float(jnp.mean(js.atm.at[0])),
        ice_area_nh_1e6km2=float(jnp.sum(js.ice.aice * tmsk * nh)) / 1e16,
        ice_area_sh_1e6km2=float(jnp.sum(js.ice.aice * tmsk * sh)) / 1e16,
        moc_global_max_sv=float(jnp.max(moc_g)) / 1e12,
        moc_atl_deep_max_sv=float(jnp.max(
            jnp.where(deep & jlat, moc_atl, -jnp.inf))) / 1e12,
        psi_max_sv=float(jnp.abs(js.ocean.psi0).max()) / 1e12,
        toa_wm2=float(jnp.sum((a["toa_sw"] - a["olr"]) / a["time"] * 1e-3
                              * area_j) / jnp.sum(area_j)),
        ohf_wm2=float(jnp.sum(a["heat"] / a["time"] * 1e-3 * tmsk
                              * area_j) / osum))
    got = climate.acceptance_row(tm, ts, climate.ClimateWeights(tm))
    assert want["ice_area_nh_1e6km2"] > 0 and want["moc_atl_deep_max_sv"] > 0
    toa_scale = float(jnp.abs(a["toa_sw"]).max() / a["time"] * 1e-3)
    for k in want:
        close(got[k], want[k],
              toa_scale if k in ("toa_wm2", "ohf_wm2") else None)


def test_tuning_row_matches_tune_earth(pair, monkeypatch):
    """``scripts/tune_earth.py:40-110`` (its weights, ``zonal`` and
    ``report``), unrounded; rounded, the port's ``report`` keeps the
    script's digits."""
    jm, js, tm, ts, *_ = pair
    g = jm.grid
    lat = np.asarray(g.yt)
    area = _area(g)
    tmsk = np.asarray(jm.embm.tmsk)
    lmsk = 1.0 - tmsk
    oarea = area * tmsk

    def zonal(f, w):
        ws = w.sum(1)
        return np.where(ws > 0, (np.asarray(f) * w).sum(1) / np.maximum(
            ws, 1e-30), np.nan)

    def pick(zb, lats):
        return [float(zb[int(np.argmin(np.abs(lat - L)))]) for L in lats]

    sst = np.asarray(js.ocean.t[0, 0])
    sat = np.asarray(js.atm.at[0])
    aice = np.asarray(js.ice.aice)
    moc_g = np.asarray(j_moc(jm.last_tavg["v"], jm.ocean.g,
                             jm.ocean.umask)) / 1e12
    nh = (lat > 0)[:, None]
    acc = jm.last_acc
    tsec = float(acc["time"])
    toa2d = (np.asarray(acc["toa_sw"]) - np.asarray(acc["olr"])) / tsec \
        * 1e-3
    want = dict(
        sat_gm=float((sat * area).sum() / area.sum()),
        sat_max=float(sat.max()),
        sat_land_max=float((sat * lmsk).max()),
        sst_gm=float((sst * oarea).sum() / oarea.sum()),
        sst_max=float(sst.max()),
        sst_min=float(np.where(tmsk > 0, sst, 99.0).min()),
        sst_z=pick(zonal(sst, oarea), [-65, -60, -30, 0, 30, 60, 75, 85]),
        sat_z=pick(zonal(sat, area), [-85, -60, -30, 0, 30, 60, 85]),
        ice_nh=float((aice * oarea * nh).sum()) / 1e16,
        ice_sh=float((aice * oarea * ~nh).sum()) / 1e16,
        psi_sv=float(np.abs(np.asarray(js.ocean.psi0)).max()) / 1e12,
        moc_max=float(moc_g.max()),
        moc_min=float(moc_g.min()),
        toa_gm=float((toa2d * area).sum() / area.sum()),
        olr_gm=float((np.asarray(acc["olr"]) / tsec * 1e-3 * area).sum()
                     / area.sum()),
        ohf_gm=float((np.asarray(acc["heat"]) / tsec * 1e-3 * oarea).sum()
                     / oarea.sum()),
        toa_z=pick(zonal(toa2d, area), [-85, -60, -30, 0, 30, 60, 85]))
    w = climate.ClimateWeights(tm)
    got = climate.tuning_row(tm, ts, w)
    scale = float(np.abs(np.asarray(acc["toa_sw"])).max() / tsec * 1e-3)
    for k in want:
        close(got[k], want[k],
              scale if k in ("toa_gm", "ohf_gm", "toa_z") else None)
    rep = tune_earth.report(tm, ts, w, 3, 0.0)
    assert list(rep) == ["yr"] + list(want) + ["wall"] and rep["yr"] == 3
    for k, n in tune_earth.DIGITS.items():
        for a, b in zip(np.atleast_1d(rep[k]), np.atleast_1d(want[k])):
            assert abs(a - b) <= 0.5001 * 10.0 ** -n, k


def test_precision_row_matches_precision_year(pair):
    """``scripts/precision_year.py:33-63``."""
    jm, js, tm, ts, *_ = pair
    g = jm.grid
    area = _area(g)
    oarea = area * np.asarray(jm.embm.tmsk)
    dvol = (np.asarray(g.dzt)[:, None, None] * area[None]
            * np.asarray(jm.ocean.tmask))
    sst = np.asarray(js.ocean.t[0, 0], np.float64)
    sat = np.asarray(js.atm.at[0], np.float64)
    t3 = np.asarray(js.ocean.t[0], np.float64)
    want = dict(
        sat_gm=float((sat * area).sum() / area.sum()),
        sst_gm=float((sst * oarea).sum() / oarea.sum()),
        heat=float((t3 * dvol).sum() / dvol.sum()),
        psi_max=float(np.abs(np.asarray(js.ocean.psi0,
                                        np.float64)).max()) / 1e12,
        ice=float((np.asarray(js.ice.aice, np.float64) * oarea).sum())
        / 1e16)
    close(climate.precision_row(ts, climate.ClimateWeights(tm)), want)


def _perturbed(t, rng, amp=1e-3):
    return t + amp * rng.normal(size=t.shape) * (np.asarray(t) != 0)


def test_year_closure_rows_match_script(pair):
    """``scripts/probe_year_closure.py:40-82``, the applied heat over the
    accumulated time times the segment (the script takes the leapfrog-
    weighted total as it stands: twice the applied flux)."""
    jm, js, tm, ts, acc, _, _, rng = pair
    ja, ta = JAudit(jm), FullAudit(tm)
    area64 = np.asarray(ja.ocean_area, np.float64)
    dvol = jnp.asarray(ja.dvol)

    def heat_inv(t):
        return float(np.asarray(jnp.sum(t[0] * dvol, axis=0),
                                np.float64).sum())

    t1 = _perturbed(np.asarray(js.ocean.t), rng)
    h0, h1 = heat_inv(js.ocean.t), heat_inv(jnp.asarray(t1))
    close(year_closure.heat_inventory(ts.ocean.t, ta.dvol), h0)
    close(year_closure.heat_inventory(torch.as_tensor(t1), ta.dvol), h1)
    bhf_rate = float((np.asarray(jm.ocean.bhf, np.float64) * area64).sum())
    assert bhf_rate > 0
    close(year_closure.bhf_rate(tm, climate.host(ta.ocean_area)), bhf_rate)
    seg_s = 5.0 * 86400.0
    applied = float((np.asarray(acc["heat"], np.float64) * area64).sum()) \
        * 2.389e-8 * seg_s / float(acc["time"])
    resid = (h1 - h0 - applied - bhf_rate * seg_s)
    want = resid * 4.186e7 / seg_s / float(area64.sum()) * 1e-3
    got = year_closure.segment_residual_wm2(
        h0, h1, tm.last_acc, bhf_rate, climate.host(ta.ocean_area), seg_s)
    close(got, want, max(abs(h1 - h0), abs(applied))
          * 4.186e7 / seg_s / float(area64.sum()) * 1e-3)
    r = np.asarray([0.3, -1.2, 0.05, 2.5004, -2.4])
    assert year_closure.year_row(2, list(r)) == dict(
        yr=2, resid_mean_wm2=round(float(r.mean()), 3),
        resid_min=round(float(r.min()), 3), resid_max=round(float(r.max()), 3),
        worst_seg=3, worst=round(float(r[3]), 3))


def _forcings(jm, tm, rng):
    g = jm.grid
    stf = rng.normal(0.0, 1e-5, (jm.ocean.nt, g.jmt, g.imt)) \
        * np.asarray(jm.topo.tmask[0])
    smf = rng.normal(0.0, 1.0, (2, g.jmt, g.imt))
    return (j_make_forcing(jnp.asarray(smf), jnp.asarray(stf)),
            make_forcing(torch.as_tensor(smf), torch.as_tensor(stf)))


def test_segment_closure_rows_match_script(pair, monkeypatch):
    """``scripts/probe_segment_closure.py:85-127``, unrounded; the
    geothermal term masked by the surface mask ``tmask[0]`` where the
    script takes ``tmask[0][0]`` (its first row, land: a zero term)."""
    jm, js, tm, ts, acc, _, _, rng = pair
    monkeypatch.setattr(segment_closure, "round", _unrounded, raising=False)
    ja, ta = JAudit(jm), FullAudit(tm)
    jf, tf = _forcings(jm, tm, rng)
    before = np.array(js.ocean.t, np.float64)
    after = _perturbed(before, rng, 1e-4)
    nst, dtts = tm.ntspos, tm.cfg.ocean.dtts
    errs = ja.ocean_closure(before, jnp.asarray(after), jf, nst, dtts)
    dvol = ja.dvol
    d_heat = float(jnp.einsum("kji,kji->", jnp.asarray(after[0] - before[0]),
                              jnp.asarray(dvol, jnp.float64)))
    area64 = np.asarray(ja.ocean_area, np.float64)
    seg_s = nst * dtts
    applied = float((np.asarray(jf.stf[0], np.float64) * area64).sum()) \
        * seg_s
    bhf_int = float((np.asarray(jm.ocean.bhf, np.float64)
                     * np.asarray(jm.ocean.tmask[0], np.float64)
                     * area64).sum()) * seg_s
    oa = float(area64.sum())

    def wm2(x):
        return x / seg_s / oa * 4.186e7 * 1e-3

    got = segment_closure.closure_row(tm, ta, torch.as_tensor(before),
                                      torch.as_tensor(after), tf)
    close(got["closure_rel"], dict(temp=errs["temp"], salt=errs["salt"]))
    scale = wm2(max(abs(d_heat), abs(applied), abs(bhf_int)))
    close(got["d_heat_wm2"], wm2(d_heat))
    close(got["applied_wm2"], wm2(applied))
    close(got["bhf_wm2"], wm2(bhf_int))
    assert got["bhf_wm2"] > 0.0
    close(got["resid_wm2"], wm2(d_heat - applied - bhf_int), scale)

    acc_m = {k: 1.01 * v for k, v in tm.last_acc.items()}
    got = segment_closure.replay_row(tm, ta, torch.as_tensor(before),
                                     torch.as_tensor(after), tm.last_acc,
                                     acc_m)

    def acc_wm2(a):
        ohf = float((np.asarray(a["heat"], np.float64) * area64).sum()) \
            * 2.389e-8 / float(a["time"]) * seg_s
        return ohf / seg_s / oa * 4.186e7 * 1e-3

    close(got, dict(fused_d_heat_wm2=wm2(d_heat),
                    fused_acc_heat_wm2=acc_wm2(acc),
                    manual_acc_heat_wm2=acc_wm2(
                        {k: v.numpy() for k, v in acc_m.items()})))


def test_replay_vs_manual_row_matches_script(pair):
    """``scripts/probe_fused_vs_manual.py:77-87``."""
    _, js, tm, ts, acc, _, _, rng = pair
    t_r = np.array(js.ocean.t)
    t_m = _perturbed(t_r, rng, 1e-6)
    acc_m = {k: v * (1.0 + 1e-7) for k, v in acc.items()}
    d_sst = np.abs(t_r[0] - t_m[0])
    want = dict(max_dT=float(d_sst.max()), mean_dT=float(d_sst.mean()),
                acc_absdiff={k: float(np.abs(acc[k] - acc_m[k]).max())
                             for k in ("heat", "freshwater", "swr")},
                acc_heat_scale=float(np.abs(acc["heat"]).max()))
    assert replay_vs_manual.compare_row(
        torch.as_tensor(t_r), torch.as_tensor(t_m), tm.last_acc,
        {k: torch.as_tensor(v) for k, v in acc_m.items()}) == want


def test_energy_rows_match_script(pair, monkeypatch):
    """``scripts/probe_energy.py:61-148``, unrounded."""
    jm, js, tm, ts, acc, *_ = pair
    monkeypatch.setattr(energy, "round", _unrounded, raising=False)
    ja, ta = JAudit(jm), FullAudit(tm)
    area_np = np.asarray(ja.area, np.float64)
    earth_area = float(area_np.sum())
    ocean_area = float(np.asarray(ja.ocean_area, np.float64).sum())

    def total_E(state):
        inv = ja.inventories(state)
        return (inv["atm_heat_J"] + inv["ocn_heat_J"]
                - 3.34e9 * 1e-7 * inv["ice_water_kg"] * 1e3), inv

    def atm_heat_J(at):
        a = np.asarray(at, np.float64)
        return float(((a[0] * JC.CPATM * JC.RHOATM * JC.SHT
                       + a[1] * JC.RHOATM * JC.SHQ * JC.VLOCN)
                      * area_np).sum()) * 1e-7

    e0, inv0 = total_E(js)
    te0, tinv0 = energy.total_energy(ta, ts)
    close(te0, e0)
    close(tinv0, inv0)
    close(energy.atm_heat_j(ts.atm.at, climate.host(ta.area)),
          atm_heat_J(js.atm.at))

    phys_seg = jm.ntspas * jm.cfg.embm.dtatm
    lmsk_np = np.asarray(jm.embm.lmsk, np.float64)
    f = {k: np.asarray(acc[k], np.float64) for k in energy.FLUX_KEYS}
    r = phys_seg / float(f["time"])
    toa_int = float(((f["toa_sw"] - f["olr"]) * area_np).sum()) * 1e-7 * r
    ohf_int = float((f["heat"] * area_np).sum()) * 1e-7 * r
    exp_atm = ((f["toa_sw"] - f["swr"]) - f["olr"] + f["uplwr"]
               + f["upsens"] + JC.VLOCN * f["evap"]
               + (JC.SLICE - JC.VLOCN) * f["psno"])
    exp_atm_int = float((exp_atm * area_np).sum()) * 1e-7 * r
    land_res_int = float(((f["swr"] - f["uplwr"] - f["upltnt"]
                           - f["upsens"]) * lmsk_np * area_np).sum()) \
        * 1e-7 * r
    ints = energy.YearIntegrals(climate.host(ta.area),
                                climate.host(tm.embm.lmsk), phys_seg)
    ints.add(tm.last_acc)
    big = float((np.abs(f["toa_sw"]) * area_np).sum()) * 1e-7 * r
    close([ints.toa, ints.ohf, ints.exp_atm, ints.land_res],
          [toa_int, ohf_int, exp_atm_int, land_res_int], big)

    # a "year" whose end state is the start state moved a little
    inv1 = {k: v * (1.0 + 1e-6) for k, v in inv0.items()}
    e1 = e0 * (1.0 + 2e-6)
    e_atm0, e_atm1 = atm_heat_J(js.atm.at), atm_heat_J(js.atm.at) * 1.001
    yr_s = 365.0 * 86400.0
    want = dict(
        yr=1,
        dE_wm2=(e1 - e0) / yr_s / earth_area * 1e7 * 1e-3,
        toa_wm2=toa_int / yr_s / earth_area * 1e7 * 1e-3,
        ohf_wm2_ocean=ohf_int / yr_s / ocean_area * 1e7 * 1e-3,
        d_ocn_heat_wm2=(inv1["ocn_heat_J"] - inv0["ocn_heat_J"]) / yr_s
        / earth_area * 1e7 * 1e-3,
        d_atm_heat_wm2=(inv1["atm_heat_J"] - inv0["atm_heat_J"]) / yr_s
        / earth_area * 1e7 * 1e-3,
        d_ice_latent_wm2=-3.34e9 * 1e-4 * (inv1["ice_water_kg"]
                                           - inv0["ice_water_kg"]) / yr_s
        / earth_area * 1e-3,
        atm_transport_loss_wm2=((e_atm1 - e_atm0) - exp_atm_int) / yr_s
        / earth_area * 1e7 * 1e-3,
        land_res_wm2=land_res_int / yr_s / earth_area * 1e7 * 1e-3,
        sat_gm=float(jnp.mean(js.atm.at[0])))
    got = energy.year_row(1, ints, e0, inv0, e1, inv1, e_atm0, e_atm1,
                          earth_area, ocean_area,
                          float(ts.atm.at[0].mean()))
    scale = big / yr_s / earth_area * 1e7 * 1e-3
    close(got, want, scale)


def test_toa_decompose_rows_match_script(pair, monkeypatch):
    """``scripts/probe_toa_decompose.py:62-161``, unrounded."""
    jm, js, tm, ts, acc, _, _, rng = pair
    monkeypatch.setattr(toa_decompose, "round", _unrounded, raising=False)
    ja, ta = JAudit(jm), FullAudit(tm)
    area = np.asarray(ja.area, np.float64)
    earth_area = area.sum()
    lmsk = np.asarray(jm.embm.lmsk, np.float64)
    ice = js.ice
    ice_mass = ((np.asarray(ice.hice, np.float64)
                 * np.asarray(ice.aice, np.float64) * JC.RHOICE
                 + np.asarray(ice.hsno, np.float64) * JC.RHOSNO)
                * area).sum()
    soilm = (np.asarray(js.atm.soilm, np.float64) * lmsk * area).sum()
    ocn = float(np.asarray(jnp.sum(jnp.asarray(js.ocean.t)[0] * ja.dvol),
                           np.float64)) * 4.186e7
    tarea, tlmsk = climate.host(ta.area), climate.host(tm.embm.lmsk)
    close(toa_decompose.ice_mass(ts.ice, tarea), ice_mass)
    close(toa_decompose.soil_water(ts.atm, tlmsk, tarea), soilm)
    close(toa_decompose.ocean_heat(ts.ocean.t, ta.dvol), ocn)

    steps = [{k: v * (1.0 + 0.1 * n) for k, v in acc.items()}
             for n in range(3)]
    srcs = dict(atm_src=0.0, land_res=0.0, toa=0.0, ocn_heat=0.0,
                snow_fus=0.0, time=0.0)
    got_src = toa_decompose.SegmentSources(tarea, tlmsk)
    for a in steps:
        f = {k: np.asarray(a[k], np.float64) for k in toa_decompose.STEP_KEYS}
        s = (f["toa_sw"] - f["swr"] - f["olr"] + f["uplwr"] + f["upsens"]
             + JC.VLOCN * f["evap"] + (JC.SLICE - JC.VLOCN) * f["psno"])
        srcs["atm_src"] += (s * area).sum()
        srcs["land_res"] += ((f["swr"] - f["uplwr"] - f["upltnt"]
                              - f["upsens"]) * lmsk * area).sum()
        srcs["toa"] += ((f["toa_sw"] - f["olr"]) * area).sum()
        srcs["ocn_heat"] += (f["heat"] * area).sum()
        srcs["snow_fus"] += ((JC.SLICE - JC.VLOCN) * f["psno"] * area).sum()
        srcs["time"] += float(f["time"])
        got_src.add({k: torch.as_tensor(v) for k, v in a.items()})
    big = (np.abs(steps[-1]["toa_sw"]) * area).sum() * 3
    close(got_src.s, srcs, big)
    phys_t = jm.ntspas * jm.cfg.embm.dtatm
    r = phys_t / srcs["time"]

    def wm2(x):
        return x / phys_t / earth_area * 1e-3

    d_atm, d_ice, d_soil, d_ocn = 3.0e20, -2.0e15, 7.0e14, 4.0e21
    want = dict(seg=4, toa_wm2=wm2(srcs["toa"] * r), d_atm_wm2=wm2(d_atm),
                exp_atm_wm2=wm2(srcs["atm_src"] * r),
                atm_transport_loss_wm2=wm2(d_atm - srcs["atm_src"] * r),
                d_ocn_wm2=wm2(d_ocn), exp_ocn_wm2=wm2(srcs["ocn_heat"] * r),
                land_res_wm2=wm2(srcs["land_res"] * r),
                d_ice_lat_wm2=wm2(-3.34e9 * d_ice),
                d_soilm_kg=d_soil * 1e-3,
                snow_fus_wm2=wm2(srcs["snow_fus"] * r))
    got = toa_decompose.segment_row(4, got_src, phys_t, earth_area, d_atm,
                                    d_ice, d_soil, d_ocn)
    close(got, want, wm2(big * r))


def test_closure_probe_matches_script(pair):
    """``scripts/probe_closure.py:44-66``: the fixed forcing, and the row
    from the audit's closure of the same tracers."""
    jm, js, tm, ts, _, _, _, rng = pair
    g = jm.grid
    yu = np.asarray(g.yu)
    taux = np.sin(np.deg2rad(yu * 3))[:, None] * np.ones((1, g.imt))
    smf = np.stack([taux / 1.035, np.zeros_like(taux)])
    stf = np.zeros((jm.ocean.nt, g.jmt, g.imt))
    stf[0] = -4.0e-6 * np.ones((g.jmt, g.imt))
    stf[1] = -2.0e-8
    stf *= np.asarray(jm.topo.tmask[0])
    f = closure.fixed_forcing(tm)
    np.testing.assert_array_equal(f.smf.numpy(), smf)
    np.testing.assert_array_equal(f.stf.numpy(), stf)
    before = np.array(js.ocean.t, np.float64)
    after = _perturbed(before, rng, 1e-5)
    want = JAudit(jm).ocean_closure(before, after, j_make_forcing(
        jnp.asarray(smf), jnp.asarray(stf)), 24, jm.cfg.ocean.dtts)
    got = FullAudit(tm).ocean_closure(torch.as_tensor(before),
                                      torch.as_tensor(after), f, 24,
                                      tm.cfg.ocean.dtts)
    close(got, want)
    assert closure.closure_row("x", got) == dict(
        variant="x", temp=round(got["temp"], 5), salt=round(got["salt"], 5))
    assert list(closure.VARIANTS) == ["earth-full", "no-fourfil", "no-isopyc",
                                      "no-tidal", "no-aniso", "bare"]


def test_moc_row_matches_script(pair, monkeypatch):
    """``scripts/probe_moc.py:73-123``, unrounded."""
    jm, js, tm, ts, acc, v, psi, _ = pair
    monkeypatch.setattr(moc, "round", _unrounded, raising=False)
    g = jm.grid
    lat, latu = np.asarray(g.yt), np.asarray(g.yu)
    area = _area(g)
    moc_j = np.asarray(j_moc(jnp.asarray(v), jm.ocean.g,
                             jm.ocean.umask)) / 1e12
    toa2d = (acc["toa_sw"] - acc["olr"]) / acc["time"] * 1e-3
    zt_km = np.asarray(g.zt) / 1e5
    kmax, jmax = np.unravel_index(np.argmax(moc_j), moc_j.shape)
    kmin, jmin = np.unravel_index(np.argmin(moc_j), moc_j.shape)
    vab = np.abs(v)
    kv, jv, iv = np.unravel_index(np.argmax(vab), vab.shape)
    u_full = np.asarray(jm.ocean.full_velocity(js.ocean.u, js.ocean.psi0))
    uab = np.abs(u_full)
    cu, ku, ju, iu = np.unravel_index(np.argmax(uab), uab.shape)
    psiab = np.abs(psi)
    jp, ip = np.unravel_index(np.argmax(psiab), psiab.shape)

    def zonal_toa(lats):
        out = []
        for L in lats:
            j = int(np.argmin(np.abs(lat - L)))
            w = area[j]
            out.append(float((toa2d[j] * w).sum() / max(w.sum(), 1e-30)))
        return out

    want = dict(
        yr=2, toa_gm_ann=float((toa2d * area).sum() / area.sum()),
        toa_z_ann=zonal_toa([-85, -60, -30, 0, 30, 60, 85]),
        moc_max=float(moc_j.max()),
        moc_max_at=dict(z_km=zt_km[kmax], lat=latu[jmax]),
        moc_min=float(moc_j.min()),
        moc_min_at=dict(z_km=zt_km[kmin], lat=latu[jmin]),
        vmax_cm_s=float(vab.max()),
        vmax_at=dict(z_km=zt_km[kv], lat=latu[jv], i=int(iv)),
        umax_inst=float(uab.max()),
        umax_at=dict(c=int(cu), z_km=zt_km[ku], lat=latu[ju], i=int(iu)),
        psi_max_sv=float(psiab.max()) / 1e12,
        psi_max_at=dict(lat=latu[jp], i=int(ip)))
    u_t = tm.ocean.full_velocity(ts.ocean.u, ts.ocean.psi0)
    got, moc_t = moc.year_row(tm, climate.ClimateWeights(tm), 2, v, psi,
                              {k: acc[k] for k in moc.ACC_KEYS}, u_t)
    scale = float(np.abs(acc["toa_sw"]).max() / acc["time"] * 1e-3)
    close({k: got[k] for k in ("toa_gm_ann", "toa_z_ann")},
          {k: want[k] for k in ("toa_gm_ann", "toa_z_ann")}, scale)
    close({k: v for k, v in got.items() if not k.startswith("toa")},
          {k: v for k, v in want.items() if not k.startswith("toa")})
    prof = moc.profiles(tm, moc_t)
    for p, L in zip(prof, [-60, -30, 0, 30, 50, 65]):
        j = int(np.argmin(np.abs(latu - L)))
        assert p["lat"] == L
        close(p["moc_profile"], [round(float(moc_j[k, j]), 1)
                                 for k in range(0, g.km, 3)], 0.05 / RTOL)


def test_triage_lines_match_script(pair):
    """``scripts/triage_earth.py:27-34,63-76``."""
    jm, js, tm, ts, *_ = pair
    g = jm.grid
    tmax = float(np.abs(np.asarray(js.ocean.t[0])).max())
    uarr = np.asarray(jm.ocean.full_velocity(js.ocean.u, js.ocean.psi0))
    umax = float(np.abs(uarr).max())
    c, k, j, i = np.unravel_index(np.abs(uarr).argmax(), uarr.shape)
    loc = (f"{'uv'[c]}k{k}({np.asarray(g.yu)[j]:.0f}N,"
           f"{np.asarray(g.xu)[i]:.0f}E)")
    s = 7
    want = (f"seg {s:3d} day {(s+1)*5.0:7.1f} "
            f"Tmax {tmax:9.4g} umax {umax:9.4g} @{loc:22s} "
            f"psi {float(np.abs(np.asarray(js.ocean.psi0)).max())/1e12:8.2f}Sv "
            f"atmax {float(np.abs(np.asarray(js.atm.at[0])).max()):8.4g} "
            f"wall {1.25:6.1f}s")
    assert triage.segment_line(tm, s, ts, 1.25) == want
    a = np.asarray(js.atm.at)
    assert triage.field_report("atm.at", ts.atm.at) \
        == f"atm.at: max|.|={np.abs(a).max():.4g}"
    bad = a.copy()
    bad[1, 3, 4] = np.nan
    bad[0, 5, 6] = np.inf
    assert triage.field_report("atm.at", torch.as_tensor(bad)) \
        == "atm.at: NONFINITE at (0, 5, 6) (n=2)"


@pytest.fixture
def small_tools(monkeypatch):
    """The tools' earth model on the small grid, one segment a year."""
    import uvic_tpu_torch.config as tcfg
    import uvic_tpu_torch.run_earth as run_earth
    cfg = tools_earth_config()
    cfg = cfg.replace(grid=small_config().grid)
    monkeypatch.setattr(tcfg, "tools_earth_config", lambda *a, **k: cfg)
    for mod in (run_earth, tune_earth, year_closure):
        loop = mod.run_years
        monkeypatch.setattr(
            mod, "run_years",
            lambda *a, _loop=loop, **k: _loop(*a, seg_per_year=1, **k))
    yield run_earth


def test_entry_points_run_a_segment(small_tools, tmp_path, capsys):
    run_earth = small_tools
    out = tmp_path / "earth_run.json"
    assert run_earth.main(["1", str(out), "--device", "cpu"]) == 0
    summary = json.loads(out.read_text())
    assert summary["years"] == 1 and len(summary["yearly"]) == 1
    row = summary["yearly"][0]
    assert row["year"] == 1 and np.isfinite(row["sst_mean"])
    assert [r["doy"] for r in summary["final_year_ice"]] == [5.0]
    assert tune_earth.main(["1", "--device", "cpu"]) == 0
    assert year_closure.main(["1", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [d.get("year", d.get("yr")) for d in lines] == [1, 1, 1]
    assert np.isfinite(lines[1]["sat_gm"]) and lines[1]["sat_z"]
    # one segment of float32 on the CPU: the ocean heat budget closes
    assert abs(lines[2]["resid_mean_wm2"]) <= \
        segment_closure.RESID_LIMIT_WM2


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from uvic_tpu_torch import precision_year, run_earth
    from uvic_tpu_torch.probes import segment_closure as sc
    for main, argv in ((run_earth.main, ["1", "x.json"]),
                       (tune_earth.main, ["1"]),
                       (precision_year.main, ["run", "float32", "x.json"]),
                       (sc.main, ["0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
