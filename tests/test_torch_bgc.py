"""The port's biogeochemistry against ``uvic_tpu`` on the CPU, in float64.

- the tracer registry (names, order, units, inits, flags, the index);
- ``co2calc_sws`` on seeded T, S, DIC, ALK and depth (rtol 1e-10; the
  air-sea difference dco2star to 1e-10 of co2star);
- ``Npzd.sources`` and ``Mobi.sources`` of the models' two instances
  (leapfrog, forward) and of the leapfrog instance with the ``c2dtts=``
  override that ``run_scan``'s mixing step uses, from a healthy seeded
  state with small noise on the 34x40x8 flagship-physics grid: each
  tracer's source agrees to 1e-9 of its largest magnitude.  Two reduced
  MOBI suites take the branches ``mobi_full()`` skips (no nitrogen, no
  iron, no prognostic CaCO3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import BgcConfig as JBgc
from uvic_tpu.config import mobi_full as j_mobi_full
from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.coupler.tracers import TracerIndex as JIndex
from uvic_tpu.coupler.tracers import build_registry as j_registry
from uvic_tpu.models.bgc.gasx import co2calc_sws as j_co2calc
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

from uvic_tpu_torch.config import BgcConfig as TBgc
from uvic_tpu_torch.config import mobi_full as t_mobi_full
from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.coupler.tracers import TracerIndex as TIndex
from uvic_tpu_torch.coupler.tracers import build_registry as t_registry
from uvic_tpu_torch.models.bgc.gasx import co2calc_sws as t_co2calc
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

FLAGSHIP = dict(isopycmix=True, gent_mcwilliams=True, tidal_kv=True,
                gthflx=True, aniso_visc=True, aniso_zonal=True)
NPZD = dict(suite="npzd", carbon=True, alk=True, o2=True, nitrogen=True)
MOBI_MIN = dict(suite="mobi", carbon=True, alk=True)
MOBI_NO_FE = dict(suite="mobi", carbon=True, carbon_13=True, alk=True,
                  o2=True, nitrogen=True, nitrogen_15=True, silicon=True)
SUITES = {
    "none": (JBgc(), TBgc()),
    "npzd_min": (JBgc(suite="npzd"), TBgc(suite="npzd")),
    "npzd": (JBgc(**NPZD), TBgc(**NPZD)),
    "mobi_min": (JBgc(**MOBI_MIN), TBgc(**MOBI_MIN)),
    "mobi_no_fe": (JBgc(**MOBI_NO_FE), TBgc(**MOBI_NO_FE)),
    "mobi_full": (j_mobi_full(), t_mobi_full()),
}


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_registry_matches(suite):
    jb, tb = SUITES[suite]
    jr, tr = j_registry(jb), t_registry(tb)
    assert [dataclasses.astuple(t) for t in tr] == \
        [dataclasses.astuple(t) for t in jr]
    ji, ti = JIndex(jr), TIndex(tr)
    assert (ti.names, ti.nt, ti.nsrc, ti.source_idx) == \
        (ji.names, ji.nt, ji.nsrc, ji.source_idx)
    for name in ti.names:
        assert name in ti
        assert ti[name] == ji[name] == getattr(ti, "i" + name)
        assert ti.index(name) == ji.index(name)
    assert "nonesuch" not in ti and ti.index("nonesuch") is None
    if suite == "mobi_full":
        assert ti.nt == 41


@pytest.mark.parametrize("depth", ["surface", "column"])
def test_co2calc_sws_matches(depth):
    rng = np.random.default_rng(1)
    shape = (6, 9, 11)
    t = rng.uniform(-2.0, 30.0, shape)
    s = rng.uniform(32.0, 37.5, shape)
    dic = rng.uniform(1.9, 2.4, shape)
    alk = rng.uniform(2.2, 2.5, shape)
    if depth == "surface":
        d = 0.0
    else:
        d = rng.uniform(0.0, 5500.0, (shape[0], 1, 1))
    ref = j_co2calc(jnp.asarray(t), jnp.asarray(s), jnp.asarray(dic),
                    jnp.asarray(alk), 280.0,
                    depth_m=d if depth == "surface" else jnp.asarray(d))
    got = t_co2calc(torch.as_tensor(t), torch.as_tensor(s),
                    torch.as_tensor(dic), torch.as_tensor(alk), 280.0,
                    depth_m=d if depth == "surface" else torch.as_tensor(d))
    assert sorted(got) == sorted(ref)
    for key in ref:
        # dco2star = co2star(air) - co2star is a difference of two nearly
        # equal terms: judged against the size of the terms
        atol = 1e-10 * np.abs(ref["co2star"]).max() \
            if key == "dco2star" else 0.0
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-10, atol=atol, err_msg=key)


def _models(suite):
    jb, tb = SUITES[suite]
    jc = j_small_config(imt=40, jmt=34, km=8)
    tc = t_small_config(imt=40, jmt=34, km=8)
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **FLAGSHIP), bgc=jb)
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **FLAGSHIP), bgc=tb)
    return j_make_ocean(jc), t_make_ocean(tc, device="cpu")


def _inputs(jm):
    """A healthy state (registry values, a thermocline, a few percent of
    log-normal noise) and seeded light and ice fields."""
    g = jm.params.grid
    idx = jm.tracer_index
    rng = np.random.default_rng(2)
    shape = (g.km, g.jmt, g.imt)
    t = np.empty((jm.nt,) + shape)
    for i, tr in enumerate(idx.tracers):
        t[i] = tr.init * np.exp(0.05 * rng.standard_normal(shape))
    t[idx.itemp] = (2.0 + 20.0 * np.exp(-np.asarray(g.zt) / 800e2)
                    )[:, None, None] + 0.5 * rng.standard_normal(shape)
    t[idx.isalt] = 1e-4 * rng.standard_normal(shape)
    t *= np.asarray(jm.params.topo.tmask)
    plane = (g.jmt, g.imt)
    swr = 2.0e5 * (1.0 + 0.2 * rng.standard_normal(plane))
    aice = rng.uniform(0.0, 1.0, plane) * (rng.uniform(size=plane) < 0.3)
    hice = 100.0 * aice
    hsno = 20.0 * aice
    return t, swr, aice, hice, hsno, 0.45


def _compare(jm, tm, lf, c2dtts):
    t, swr, aice, hice, hsno, relyr = _inputs(jm)
    jargs = [jnp.asarray(x) for x in (t, swr, aice, hice, hsno)]
    targs = [torch.as_tensor(x) for x in (t, swr, aice, hice, hsno)]
    kw = {} if c2dtts is None else dict(c2dtts=c2dtts)
    ref = np.asarray(jm.npzd[lf].sources(
        jargs[0], jm.kmt, jm.tmask, *jargs[1:], jm.tlat_rad,
        jnp.asarray(relyr), **kw))
    got = tm.npzd[lf].sources(
        targs[0], tm.kmt, tm.tmask, *targs[1:], tm.tlat_rad,
        torch.tensor(relyr, dtype=torch.float64), **kw).numpy()
    assert tm.npzd[lf].nbio == jm.npzd[lf].nbio
    assert np.isfinite(got).all()
    assert np.abs(ref).max() > 0.0
    for n, name in enumerate(jm.tracer_index.names):
        scale = np.abs(ref[n]).max()
        err = np.abs(got[n] - ref[n]).max()
        assert err <= 1e-9 * scale, \
            f"{name}: err {err:.3e} vs largest source {scale:.3e}"


CASES = [("leapfrog", True, None), ("forward", False, None),
         ("scan_mixing", True, "dtts")]


@pytest.fixture(scope="module")
def npzd_models():
    return _models("npzd")


@pytest.fixture(scope="module")
def mobi_models():
    return _models("mobi_full")


@pytest.mark.parametrize("case,lf,c2dtts", CASES, ids=[c[0] for c in CASES])
def test_npzd_sources_match(npzd_models, case, lf, c2dtts):
    jm, tm = npzd_models
    _compare(jm, tm, lf, None if c2dtts is None else jm.cfg.ocean.dtts)


@pytest.mark.parametrize("case,lf,c2dtts", CASES, ids=[c[0] for c in CASES])
def test_mobi_sources_match(mobi_models, case, lf, c2dtts):
    jm, tm = mobi_models
    _compare(jm, tm, lf, None if c2dtts is None else jm.cfg.ocean.dtts)


@pytest.mark.parametrize("suite", ["mobi_min", "mobi_no_fe"])
def test_reduced_mobi_sources_match(suite):
    jm, tm = _models(suite)
    _compare(jm, tm, True, None)
