"""Each CUDA kernel's plain PyTorch version against the Pallas kernel it
replaces, run in interpret mode as the JAX package's own tests run it
(tests/test_pallas_tracer.py, test_pallas_cg.py, test_ops.py).

On the CPU the port's wrappers take the plain versions, so these tests
also pin what the CUDA kernels must compute; ``chip_smoke.py`` holds the
kernels against the plain versions on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.models.ocean.isopyc import (compute_isopyc, iso_weight_pack,
                                          iso_weight_stack)
from uvic_tpu.models.ocean.kernels import adv_vel
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean
from uvic_tpu.ops.convection import _apply_region_means_pallas
from uvic_tpu.ops.pallas_cg import make_pallas_congrad
from uvic_tpu.ops.pallas_tracer import make_fct_tracer_step
from uvic_tpu.ops.solvers import congrad, make_inv
from uvic_tpu.ops.stencil import setbcx

import uvic_tpu_torch
from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.entry import _flagship
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean
from uvic_tpu_torch.ops.cg_kernel import CGSolver
from uvic_tpu_torch.ops.convection import apply_region_means
from uvic_tpu_torch.ops.tracer_kernel import (TracerStepConsts,
                                              fct_tracer_step)
from torch_threads import torch_one_thread  # noqa: F401  (autouse)


def T(x):
    return torch.as_tensor(np.array(x))


def _pair(isopyc):
    """JAX and port models on the grid of tests/test_pallas_tracer.py."""
    kw = dict(isopycmix=isopyc, gent_mcwilliams=isopyc, dtts=43200.0,
              dtuv=1800.0, dtsf=1800.0)
    jc = j_small_config(imt=40, jmt=34, km=8)
    tc = t_small_config(imt=40, jmt=34, km=8)
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **kw))
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **kw))
    return j_make_ocean(jc), t_make_ocean(tc, device="cpu")


def _tracer_inputs(jm):
    g = jm.params.grid
    tmask = np.asarray(jm.params.topo.tmask)
    umask = np.asarray(jm.params.topo.umask)
    rng = np.random.default_rng(7)
    shape = (g.km, g.jmt, g.imt)
    t0 = np.zeros((2,) + shape)
    t0[0] = 15.0 + 4.0 * rng.standard_normal(shape)
    t0[1] = 0.035 + 1e-4 * rng.standard_normal(shape)
    t0 *= tmask
    tm1 = (t0 + 0.05 * rng.standard_normal(t0.shape)) * tmask
    u = setbcx(jnp.asarray(2.0 * rng.standard_normal(shape) * umask), True)
    v = setbcx(jnp.asarray(2.0 * rng.standard_normal(shape) * umask), True)
    vet, vnt, vbt, *_ = adv_vel(u, v, jm.g, True)
    stf = 1e-5 * rng.standard_normal((2, g.jmt, g.imt))
    btf = 1e-6 * rng.standard_normal((2, g.jmt, g.imt))
    src = 1e-7 * rng.standard_normal(t0.shape)
    return t0, tm1, np.asarray(vet), np.asarray(vnt), np.asarray(vbt), \
        stf, btf, src


@pytest.mark.parametrize("case", ["aidif0", "aidif1_src", "iso_in_kernel"])
def test_tracer_step_ref_matches_pallas(case):
    iso = case == "iso_in_kernel"
    jm, tm = _pair(iso)
    t0, tm1, vet, vnt, vbt, stf, btf, src = _tracer_inputs(jm)
    cfg = jm.cfg.ocean
    aidif = {"aidif0": 0.0, "aidif1_src": 1.0, "iso_in_kernel": cfg.aidif}[case]
    source = None if case == "aidif0" else src
    diff_cbt = np.asarray(jm.diff_cbt)
    isow = None
    if iso:
        jiso = compute_isopyc(jnp.asarray(tm1), jm.tmask, jm.kmt, jm.eos_c,
                              jm.eos_to, jm.eos_so, jm.g, cfg, True,
                              addisop=jm.addisop)
        diff_cbt = diff_cbt + np.asarray(jiso.K33)
        vet = vet + np.asarray(jiso.vetiso)
        vnt = vnt + np.asarray(jiso.vntiso)
        vbt = vbt + np.asarray(jiso.vbtiso)
        isow = np.asarray(iso_weight_stack(iso_weight_pack(jiso, jm.g)))
    twodt = 2 * cfg.dtts * np.asarray(jm.g.dtxcel)
    km, jmt, imt = t0.shape[1:]
    fn = make_fct_tracer_step(2, km, jmt, imt, jm.g, cfg.ah, aidif,
                              ydiff_fluxform=iso, has_src=source is not None,
                              dtype=jnp.float64, interpret=True,
                              has_iso=iso)
    ref = fn(*map(jnp.asarray, (t0, tm1, vet, vnt, vbt, diff_cbt, stf,
                                btf)),
             None if source is None else jnp.asarray(source),
             jnp.asarray(twodt), jm.tmask, jm.kmt,
             isow=None if isow is None else jnp.asarray(isow))

    consts = TracerStepConsts(tm.g, cfg.ah, aidif, ydiff_fluxform=iso,
                              has_iso=iso)
    got = fct_tracer_step(consts, *map(T, (t0, tm1, vet, vnt, vbt, diff_cbt,
                                           stf, btf)),
                          None if source is None else T(source), T(twodt),
                          tm.tmask, tm.kmt,
                          isow=None if isow is None else T(isow))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9,
                               atol=1e-11)


def _cg_setup():
    cfg = j_small_config()
    cfg = cfg.replace(ocean=dataclasses.replace(
        cfg.ocean, isopycmix=False, gent_mcwilliams=False))
    jm = j_make_ocean(cfg)
    tcfg = t_small_config()
    tcfg = tcfg.replace(ocean=dataclasses.replace(
        tcfg.ocean, isopycmix=False, gent_mcwilliams=False))
    tm = t_make_ocean(tcfg, device="cpu")
    topo = jm.params.topo
    jmt, imt = topo.hr.shape
    pid = np.asarray(topo.perim_id)
    oh = np.stack([(pid == k).astype(np.float64)
                   for k in range(max(topo.nisle, 1))])
    interior = np.zeros((jmt, imt))
    interior[1:-1, 1:-1] = 1.0
    solver = make_pallas_congrad(
        np.asarray(jm.cf_unit), np.asarray(make_inv(jm.cf_unit, jm.isl)),
        oh, np.asarray(topo.perim_count), interior,
        (pid >= 0).astype(np.float64), imt, jmt, cfg.ocean.mxscan, True,
        interpret=True)
    return jm, tm, solver, interior


def test_congrad_ref_matches_pallas_cold_and_warm():
    jm, tm, pallas, interior = _cg_setup()
    c2dtsf = 2.0 * jm.cfg.ocean.dtsf
    omask = np.asarray(jm.isl.ocean_mask)
    forc = np.random.default_rng(7).normal(size=omask.shape) * omask \
        * interior
    pilot, *_ = congrad(jm.cf_unit / c2dtsf, jnp.zeros_like(forc),
                        jnp.asarray(forc), jm.isl, 1e-30,
                        jm.cfg.ocean.mxscan, True)
    tol = 1e-7 * float(jnp.abs(pilot).max())
    port = CGSolver(tm.cf_unit, tm.isl, tm.cfg.ocean.mxscan, True)
    for guess in (np.zeros_like(omask), 0.9 * np.asarray(pilot)):
        ref, it_ref = pallas(jnp.asarray(guess), jnp.asarray(forc),
                             jnp.asarray(c2dtsf), jnp.asarray(tol))
        got, it_got = port(T(guess), T(forc), c2dtsf, tol)
        assert not bool(torch.isnan(got).any())
        assert int(it_got) == int(it_ref)
        scale = float(jnp.abs(ref).max())
        assert float(np.abs(got.numpy() - np.asarray(ref)).max()) \
            <= 1e-9 * scale


# (nt, km, jmt, imt): the first case's inputs are those of the test
# before it took shapes; then km 1, 19 and 64 (the CUDA kernel's limit),
# planes that are not a multiple of 4, and nt 1 and 41.
REGION_MEANS_SHAPES = [(4, 6, 5, 7), (2, 1, 5, 7), (2, 19, 6, 9),
                       (1, 64, 3, 5), (41, 8, 7, 11), (41, 19, 2, 3),
                       (1, 19, 4, 4)]


@pytest.mark.parametrize("nt, km, jmt, imt", REGION_MEANS_SHAPES, ids=str)
def test_region_means_ref_matches_pallas(nt, km, jmt, imt):
    rng = np.random.default_rng(11)
    ts = rng.standard_normal((nt, km, jmt, imt))
    m = rng.uniform(0.0, 1.0, (km, km, jmt, imt))
    m /= m.sum(axis=1, keepdims=True)
    kmt = rng.integers(0, km + 1, size=(jmt, imt))
    ocean = (np.arange(km)[:, None, None] < kmt[None]).astype(np.float64)
    ref = _apply_region_means_pallas(jnp.asarray(ts), jnp.asarray(m),
                                     jnp.asarray(ocean), interpret=True)
    got = apply_region_means(T(ts), T(m), T(ocean))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13,
                               atol=1e-13)


def test_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uvic_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make_ocean(t_small_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _flagship(small=True)
    assert uvic_tpu_torch.resolve_device("cpu").type == "cpu"
