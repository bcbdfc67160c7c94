"""The port's ocean circulation diagnostics (``uvic_tpu_torch.diag.energy``)
against ``uvic_tpu.diag.energy`` on the CPU, in float64: each function
on the same seeded fields of the small configuration, with the ocean
models' own parameter bags (the reference's ``overturning_extrema``
reads ``zt`` from its grid, the port's from its bag).  Every output
agrees to rtol 1e-12 of its largest magnitude.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.diag import energy as J
from uvic_tpu.models.ocean.model import make_forcing as j_forcing
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

from uvic_tpu_torch.config import small_config
from uvic_tpu_torch.core.earth import atlantic_mask
from uvic_tpu_torch.diag import energy as T
from uvic_tpu_torch.models.ocean.model import make_forcing, make_ocean

RTOL = 1e-12


def close(got, ref, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= RTOL * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


def t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


@pytest.fixture(scope="module")
def models():
    cfg = dict(dtype="float64")
    jm = j_make_ocean(j_small_config(**cfg))
    tm = make_ocean(small_config(**cfg), device="cpu")
    g = jm.params.grid
    rng = np.random.default_rng(7)
    shape3 = (g.km, g.jmt, g.imt)
    f = dict(v=rng.normal(0.0, 2.0, shape3) * np.asarray(jm.umask),
             vntiso=rng.normal(0.0, 0.2, shape3),
             temp=rng.uniform(-2.0, 28.0, shape3) * np.asarray(jm.tmask),
             u=rng.normal(0.0, 3.0, (2,) + shape3) * np.asarray(jm.umask),
             psi=rng.normal(0.0, 3e12, (g.jmt, g.imt)),
             smf=rng.normal(0.0, 1.0, (2, g.jmt, g.imt)),
             cori=np.where(rng.uniform(0, 1, (g.jmt, g.imt)) < 0.1, 0.0,
                           rng.normal(0.0, 1e-4, (g.jmt, g.imt))),
             amask=atlantic_mask(tm.params.grid))
    return jm, tm, f


def test_meridional_overturning(models):
    jm, tm, f = models
    ref = J.meridional_overturning(jnp.asarray(f["v"]), jm.g, jm.umask)
    got = T.meridional_overturning(t(f["v"]), tm.g, tm.umask)
    close(got, ref, "psi_moc")


@pytest.mark.parametrize("atlantic", [False, True])
def test_gm_overturning(models, atlantic):
    jm, tm, f = models
    xm = f["amask"] if atlantic else None
    ref = J.gm_overturning(jnp.asarray(f["vntiso"]), jm.g,
                           None if xm is None else jnp.asarray(xm))
    got = T.gm_overturning(t(f["vntiso"]), tm.g,
                           None if xm is None else t(xm))
    close(got, ref, "psi_gm")


def test_overturning_extrema(models):
    jm, tm, f = models
    psi = J.meridional_overturning(jnp.asarray(f["v"]), jm.g, jm.umask)
    ref = J.overturning_extrema(psi, jm.params.grid)
    got = T.overturning_extrema(t(np.asarray(psi)), tm.g)
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], k)


@pytest.mark.parametrize("ekman", [False, True])
def test_gyre_components(models, ekman):
    jm, tm, f = models
    extra_j = extra_t = {}
    if ekman:
        extra_j = dict(smf=jnp.asarray(f["smf"]), cori=jnp.asarray(f["cori"]))
        extra_t = dict(smf=t(f["smf"]), cori=t(f["cori"]))
    ref = J.gyre_components(jnp.asarray(f["v"]), jnp.asarray(f["temp"]),
                            jm.g, jm.tmask, **extra_j)
    got = T.gyre_components(t(f["v"]), t(f["temp"]), tm.g, tm.tmask,
                            **extra_t)
    assert set(got) == set(ref)
    if ekman:
        assert float(np.abs(np.asarray(ref["ekman"])).max()) > 0.0
    for k in ref:
        close(got[k], ref[k], k)


@pytest.mark.parametrize("with_forcing", [False, True])
def test_energy_integrals(models, with_forcing):
    jm, tm, f = models
    js = jm.init_state(None)
    js = dataclasses.replace(js, u=jnp.asarray(f["u"]),
                             psi0=jnp.asarray(f["psi"]))
    ts = tm.init_state(None)
    ts = dataclasses.replace(ts, u=t(f["u"]), psi0=t(f["psi"]))
    jf = tf = None
    if with_forcing:
        nt = jm.nt
        zeros = np.zeros((nt,) + f["psi"].shape)
        jf = j_forcing(jnp.asarray(f["smf"]), jnp.asarray(zeros))
        tf = make_forcing(t(f["smf"]), t(zeros))
    ref = J.energy_integrals(js, jm, jf)
    got = T.energy_integrals(ts, tm, tf)
    assert set(got) == set(ref)
    assert ("wind_work_per_area" in ref) == with_forcing
    for k in ref:
        close(got[k], ref[k], k)


def test_tracer_term_balance(models):
    jm, tm, f = models
    g = jm.params.grid
    rng = np.random.default_rng(8)
    t_old = np.stack([f["temp"], rng.normal(0.0, 1e-3, f["temp"].shape)])
    t_new = t_old + rng.normal(0.0, 1e-2, t_old.shape)
    regions = (rng.uniform(0, 1, (3, g.jmt, g.imt)) < 0.5).astype(float)
    ref = J.tracer_term_balance(jnp.asarray(t_new), jnp.asarray(t_old),
                                86400.0, jnp.asarray(regions), jm.g,
                                jm.tmask)
    got = T.tracer_term_balance(t(t_new), t(t_old), 86400.0, t(regions),
                                tm.g, tm.tmask)
    close(got, ref, "term balance")
