"""The port's data-preparation and sampling tools against ``uvic_tpu``,
on the CPU in float64.

- ``io/regrid.py`` (the port's own NumPy copy): ``ctf``, ``ftc`` and
  ``extrap_fill`` bitwise equal to the reference's on the fields of
  ``tests/test_io_diag.py`` and on seeded random ones, and the reference
  test's properties;
- ``diag/regions.py``: ``setvr``, and ``build_regions`` on the earth grid
  (as ``tests/test_io_diag.py``): every mask, area and volume bitwise
  equal; ``volume_mean`` of seeded random fields to 1e-12, from the
  port's regions and from the reference's carried across (``convert``);
  a field equal to its region id averages back to the id;
- ``diag/sections.py``: ``XbtStations``, ``cross_section`` and
  ``zonal_mean_sbc`` on a state of the small ocean after 5 steps of the
  reference model, carried into the port: the gathers bitwise, the
  velocities and the means to 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import ModelConfig as JModelConfig
from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.diag import regions as j_regions
from uvic_tpu.diag import sections as j_sections
from uvic_tpu.io import regrid as j_regrid
from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean
from uvic_tpu.models.ocean.params import \
    build_ocean_params as j_build_params

from uvic_tpu_torch.config import ModelConfig as TModelConfig
from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import ocean_state_from_numpy, regions_from_numpy
from uvic_tpu_torch.diag import regions as t_regions
from uvic_tpu_torch.diag import sections as t_sections
from uvic_tpu_torch.io import regrid as t_regrid
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean
from uvic_tpu_torch.models.ocean.params import \
    build_ocean_params as t_build_params
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

RTOL = 1e-12


def test_regrid_matches_jax():
    # the reference test's fields
    f = np.zeros((8, 10))
    valid = np.zeros((8, 10), bool)
    f[:, 0], f[:, 5] = 1.0, 3.0
    valid[:, 0] = valid[:, 5] = True
    for cyclic in (False, True):
        ref = j_regrid.extrap_fill(f, valid, cyclic=cyclic, max_iter=2000,
                                   tol=1e-8)
        got = t_regrid.extrap_fill(f, valid, cyclic=cyclic, max_iter=2000,
                                   tol=1e-8)
        np.testing.assert_array_equal(got, ref)
    assert np.all(got[:, 1:5] > 1.0) and np.all(got[:, 1:5] < 3.0)
    rng = np.random.default_rng(0)
    field = rng.normal(size=(3, 12, 20))
    mask = rng.uniform(size=(3, 12, 20)) > 0.4
    np.testing.assert_array_equal(
        t_regrid.extrap_fill(field, mask, max_iter=50),
        j_regrid.extrap_fill(field, mask, max_iter=50))
    np.testing.assert_array_equal(t_regrid.extrap_fill(field, mask | True),
                                  field)

    slon = np.arange(0, 360, 10.0) + 5.0
    slat = np.linspace(-85, 85, 18)
    dlon = np.arange(0, 360, 3.6) + 1.8
    dlat = np.linspace(-88, 88, 50)
    for src in (np.sin(np.deg2rad(slat))[:, None] * np.ones((18, 36)),
                rng.normal(size=(2, 18, 36))):
        for cyclic in (True, False):
            ref = j_regrid.ctf(src, slon[::-1], slat, dlon - 180.0, dlat,
                               cyclic=cyclic)
            got = t_regrid.ctf(src, slon[::-1], slat, dlon - 180.0, dlat,
                               cyclic=cyclic)
            np.testing.assert_array_equal(got, ref)

    fine_lon = np.arange(0, 360, 1.0) + 0.5
    fine_lat = np.linspace(-89.5, 89.5, 180)
    lon_edges = np.arange(-20.0, 341.0, 30.0)
    lat_edges = np.linspace(-80, 90, 8)
    for fine in (np.full((180, 360), 7.5), rng.normal(size=(180, 360))):
        ref = j_regrid.ftc(fine, fine_lon, fine_lat, lon_edges, lat_edges)
        got = t_regrid.ftc(fine, fine_lon, fine_lat, lon_edges, lat_edges)
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def earth_regions():
    jp = j_build_params(JModelConfig(), topo_kind="earth")
    tp = t_build_params(TModelConfig(), topo_kind="earth")
    np.testing.assert_array_equal(tp.topo.kmt, np.asarray(jp.topo.kmt))
    jreg = j_regions.build_regions(jp.grid, jp.topo.kmt)
    treg = t_regions.build_regions(tp.grid, tp.topo.kmt, device="cpu")
    return jp, tp, jreg, treg


def test_build_regions_matches_jax(earth_regions):
    jp, tp, jreg, treg = earth_regions
    assert treg.hregnm == jreg.hregnm and treg.vregnm == jreg.vregnm
    assert treg.nhreg == 5 and treg.nvreg == 2
    for name in ("mskhr", "mskvr", "hmask", "vmask", "areab", "volbk",
                 "volbt"):
        np.testing.assert_array_equal(getattr(treg, name).numpy(),
                                      np.asarray(getattr(jreg, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(treg.dvol.numpy(), np.asarray(jreg._dvol))
    zw = np.asarray(tp.grid.zw)[:tp.grid.km]
    for bounds in ([(0.0, 1e9)], [(0.0, 500.0e2), (500.0e2, 2000.0e2)],
                   [(100.0e2, 300.0e2)]):
        np.testing.assert_array_equal(t_regions.setvr(zw, bounds),
                                      j_regions.setvr(zw, bounds))


def test_volume_mean_matches_jax(earth_regions):
    jp, tp, jreg, treg = earth_regions
    g = tp.grid
    km, jmt, imt = g.km, g.jmt, g.imt
    carried = regions_from_numpy(
        dict({k: np.asarray(getattr(jreg, k)) for k in (
            "hregnm", "vregnm", "mskhr", "mskvr", "hmask", "vmask", "areab",
            "volbk", "volbt")}, dvol=np.asarray(jreg._dvol)), "cpu")
    rng = np.random.default_rng(2)
    for field in (rng.normal(size=(km, jmt, imt)) * 5.0 + 10.0,
                  1e-4 * rng.normal(size=(km, jmt, imt))):
        ref = np.asarray(jreg.volume_mean(jnp.asarray(field)))
        for reg in (treg, carried):
            got = reg.volume_mean(torch.as_tensor(field)).numpy()
            np.testing.assert_allclose(got, ref, rtol=RTOL,
                                       atol=RTOL * np.abs(ref).max())
    # the reference test's property: a field equal to its region id
    ids = treg.mskhr.numpy()
    f = np.broadcast_to(ids[None], (km, jmt, imt)).astype(float)
    means = treg.volume_mean(torch.as_tensor(f)).numpy()
    for r in range(5):
        if treg.volbt[r] > 0:
            np.testing.assert_allclose(means[r], r + 1.0, rtol=1e-10)


@pytest.fixture(scope="module")
def small_state():
    kw = dict(isopycmix=False, gent_mcwilliams=False, dtts=3600.0,
              dtuv=900.0, dtsf=900.0, tolrsf=1e8)
    jc, tc = j_small_config(), t_small_config()
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **kw))
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **kw))
    jm, tm = j_make_ocean(jc), t_make_ocean(tc, device="cpu")
    g = jm.params.grid
    t0 = np.zeros((2, g.km, g.jmt, g.imt))
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None]
    t0 *= np.asarray(jm.params.topo.tmask)
    taux = np.sin(np.deg2rad(np.asarray(g.yu) * 3))[:, None] \
        * np.ones((1, g.imt))
    smf = np.stack([taux / 1.035, np.zeros_like(taux)])
    f = j_make_forcing(jnp.asarray(smf), jnp.zeros((jm.nt, g.jmt, g.imt)))
    js = jm.run(jm.init_state(t0), f, 5)
    d = {k: np.asarray(getattr(js, k)) for k in (
        "tm1", "t", "um1", "u", "psi0", "psi1", "ptd", "ptdb", "ubar",
        "ubarm1", "itt", "nconv")}
    return jm, tm, js, ocean_state_from_numpy(d, "cpu"), smf


def test_sections_match_jax(small_state):
    jm, tm, js, ts, smf = small_state
    jg, tg = jm.params.grid, tm.params.grid
    jx, tx = j_sections.XbtStations(jg), t_sections.XbtStations(tg)
    ref, got = jx.sample(js, jm), tx.sample(ts, tm)
    assert list(got) == list(ref) == [n for n, _, _ in
                                      t_sections.XbtStations.DEFAULT]
    for name in ref:
        assert list(got[name]) == ["temp", "salt", "u", "v"]
        for k in ("temp", "salt"):
            np.testing.assert_array_equal(got[name][k], ref[name][k])
        for k in ("u", "v"):
            np.testing.assert_allclose(got[name][k], ref[name][k],
                                       rtol=RTOL, atol=RTOL * np.abs(
                                           np.asarray(js.u)).max())
    custom = (("a", 10.0, 5.0), ("b", -170.0, -70.0))
    ref = j_sections.XbtStations(jg, custom).sample(js, jm)
    got = t_sections.XbtStations(tg, custom).sample(ts, tm)
    np.testing.assert_array_equal(got["b"]["temp"], ref["b"]["temp"])

    for kw in (dict(lat=0.0), dict(lat=-61.0), dict(lon=180.0),
               dict(lon=-20.0)):
        ref = j_sections.cross_section(js.t[0], jg, **kw)
        got = t_sections.cross_section(ts.t[0], tg, **kw)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        t_sections.cross_section(ts.t[0], tg)

    ref = j_sections.zonal_mean_sbc(
        dict(sst=js.t[0, 0], taux=jnp.asarray(smf[0])), jm.tmask[0], jg.dxt)
    got = t_sections.zonal_mean_sbc(
        dict(sst=ts.t[0, 0], taux=torch.as_tensor(smf[0])), tm.tmask[0],
        tg.dxt)
    assert list(got) == ["sst", "taux"]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL,
                                   atol=RTOL * np.abs(ref[k]).max())
