"""The PyTorch port's ops against ``uvic_tpu`` on the same inputs.

Float64 on the CPU (tests/conftest.py enables x64 for JAX); inputs are
made from a NumPy seed and handed to both packages.  Tolerance: rtol
1e-10 with an absolute floor of 1e-12 x the field's scale — both sides
run the same arithmetic, in other summation orders at most.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.models.ocean import isopyc as j_isopyc
from uvic_tpu.models.ocean import kernels as j_kernels
from uvic_tpu.models.ocean import tropic as j_tropic
from uvic_tpu.models.ocean import vmix as j_vmix
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean
from uvic_tpu.ops import advection as j_adv
from uvic_tpu.ops import convection as j_conv
from uvic_tpu.ops import eos as j_eos
from uvic_tpu.ops import solvers as j_solvers
from uvic_tpu.ops import stencil as j_st
from uvic_tpu.ops import tridiag as j_tri

from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.models.ocean import isopyc as t_isopyc
from uvic_tpu_torch.models.ocean import kernels as t_kernels
from uvic_tpu_torch.models.ocean import tropic as t_tropic
from uvic_tpu_torch.models.ocean import vmix as t_vmix
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean
from uvic_tpu_torch.ops import advection as t_adv
from uvic_tpu_torch.ops import convection as t_conv
from uvic_tpu_torch.ops import eos as t_eos
from uvic_tpu_torch.ops import solvers as t_solvers
from uvic_tpu_torch.ops import stencil as t_st
from uvic_tpu_torch.ops import tridiag as t_tri

FLAGSHIP = dict(isopycmix=True, gent_mcwilliams=True, tidal_kv=True,
                gthflx=True, aniso_visc=True, aniso_zonal=True)


def close(got, ref, rtol=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-12 * scale)


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def models():
    jc = j_small_config(imt=40, jmt=34, km=8)
    tc = t_small_config(imt=40, jmt=34, km=8)
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **FLAGSHIP))
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **FLAGSHIP))
    return j_make_ocean(jc), t_make_ocean(tc, device="cpu")


@pytest.fixture(scope="module")
def fields(models):
    """Random but physical tracers and velocities on the small grid."""
    jm, _ = models
    g = jm.params.grid
    tmask = np.asarray(jm.params.topo.tmask)
    umask = np.asarray(jm.params.topo.umask)
    rng = np.random.default_rng(7)
    shape = (g.km, g.jmt, g.imt)
    t = np.zeros((2,) + shape)
    t[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None] \
        + 2.0 * rng.standard_normal(shape)
    t[1] = 1e-4 * rng.standard_normal(shape)
    t *= tmask
    tm1 = (t + 0.05 * rng.standard_normal(t.shape)) * tmask
    u = np.stack([2.0 * rng.standard_normal(shape) * umask,
                  2.0 * rng.standard_normal(shape) * umask])
    um1 = u + 0.1 * rng.standard_normal(u.shape) * umask
    u = np.asarray(j_st.setbcx(jnp.asarray(u), True))
    um1 = np.asarray(j_st.setbcx(jnp.asarray(um1), True))
    return dict(t=t, tm1=tm1, u=u, um1=um1, rng=rng)


def test_eos(models, fields):
    jm, tm = models
    t = fields["tm1"]
    for name in ("dens", "drodt", "drods"):
        jf, tf = getattr(j_eos, name), getattr(t_eos, name)
        ref = jf(jm.eos_c[:, None, None, :], t[0] - jm.eos_to[:, None, None],
                 t[1] - jm.eos_so[:, None, None])
        got = tf(tm.eos_c[:, None, None, :],
                 T(t[0]) - tm.eos_to[:, None, None],
                 T(t[1]) - tm.eos_so[:, None, None])
        close(got, ref)
    close(t_eos.state(tm.params.eos, T(t[0]), T(t[1])),
          j_eos.state(jm.params.eos, jnp.asarray(t[0]), jnp.asarray(t[1])))


def test_stencil(fields):
    a = fields["t"]
    for name in ("E", "W", "N", "S", "UP", "DN"):
        close(getattr(t_st, name)(T(a)), getattr(j_st, name)(jnp.asarray(a)),
              rtol=0)
    for cyclic in (True, False):
        close(t_st.setbcx(T(a), cyclic), j_st.setbcx(jnp.asarray(a), cyclic),
              rtol=0)


def test_invtri(models, fields):
    jm, tm = models
    rng = np.random.default_rng(3)
    g = jm.params.grid
    z = fields["t"][0]
    topbc = rng.standard_normal((g.jmt, g.imt))
    botbc = rng.standard_normal((g.jmt, g.imt))
    dcb = rng.uniform(0.1, 50.0, z.shape)
    tdt = 2 * 43200.0 * np.ones(g.km)
    kmt = np.asarray(jm.params.topo.kmt)
    tmask = np.asarray(jm.params.topo.tmask)
    ref = j_tri.invtri(*map(jnp.asarray, (z, topbc, botbc, dcb, tdt)),
                       jnp.asarray(kmt), jnp.asarray(tmask), jm.g.dztr,
                       jm.g.dztur, jm.g.dztlr, 0.5)
    got = t_tri.invtri(*map(T, (z, topbc, botbc, dcb, tdt)), T(kmt),
                       T(tmask), tm.g.dztr, tm.g.dztur, tm.g.dztlr, 0.5)
    close(got, ref)


def _velocities(m, u, backend):
    if backend == "jax":
        return j_kernels.adv_vel(jnp.asarray(u[0]), jnp.asarray(u[1]), m.g,
                                 True)
    return t_kernels.adv_vel(T(u[0]), T(u[1]), m.g, True)


def test_adv_vel(models, fields):
    jm, tm = models
    for ref, got in zip(_velocities(jm, fields["u"], "jax"),
                        _velocities(tm, fields["u"], "torch")):
        close(got, ref)


def test_fct_flux(models, fields):
    jm, tm = models
    vet, vnt, vbt, *_ = _velocities(jm, fields["u"], "jax")
    tvet, tvnt, tvbt, *_ = _velocities(tm, fields["u"], "torch")
    twodt = 2 * jm.cfg.ocean.dtts * np.asarray(jm.g.dtxcel)
    km = twodt.shape[0]
    ref = j_adv.fct_flux(jnp.asarray(fields["t"]), jnp.asarray(fields["tm1"]),
                         vet[None], vnt[None], vbt[None], jm.tmask[None],
                         jnp.asarray(twodt).reshape(1, km, 1, 1),
                         jm.g.cstdxt2r, jm.g.cstdyt2r[:, None],
                         jm.g.dzt2r[:, None, None])
    got = t_adv.fct_flux(T(fields["t"]), T(fields["tm1"]), tvet, tvnt, tvbt,
                         tm.tmask, T(twodt).reshape(km, 1, 1),
                         tm.g.cstdxt2r, tm.g.cstdyt2r[:, None],
                         tm.g.dzt2r[:, None, None])
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("aniso", [False, True])
def test_clinic_step(models, fields, aniso):
    jm, tm = models
    u, um1 = fields["u"], fields["um1"]
    rng = np.random.default_rng(11)
    g = jm.params.grid
    rho = 1e-3 * rng.standard_normal((g.km, g.jmt, g.imt)) \
        * np.asarray(jm.params.topo.tmask)
    smf = rng.standard_normal((2, g.jmt, g.imt))
    bmf = 0.1 * rng.standard_normal((2, g.jmt, g.imt))
    _, _, _, veu, vnu, vbu = _velocities(jm, u, "jax")
    _, _, _, tveu, tvnu, tvbu = _velocities(tm, u, "torch")
    c2dtuv = 2 * jm.cfg.ocean.dtuv
    ref = j_kernels.clinic_step(
        jnp.asarray(u), jnp.asarray(um1), jnp.asarray(rho), veu, vnu, vbu,
        jnp.asarray(smf), jnp.asarray(bmf), jm.visc_cbu, jm.kmu, jm.umask,
        jm.g, c2dtuv, True,
        hmix=("aniso",) + tuple(jm.aniso_visc) if aniso else None)
    got = t_kernels.clinic_step(
        T(u), T(um1), T(rho), tveu, tvnu, tvbu, T(smf), T(bmf),
        tm.visc_cbu, tm.kmu, tm.umask, tm.g, c2dtuv, True,
        hmix=("aniso",) + tuple(tm.aniso_visc) if aniso else None)
    for a, b in zip(got, ref):
        close(a, b)


def test_isopyc_weights_and_tidal(models, fields):
    jm, tm = models
    cfg = jm.cfg.ocean
    jiso = j_isopyc.compute_isopyc(
        jnp.asarray(fields["tm1"]), jm.tmask, jm.kmt, jm.eos_c, jm.eos_to,
        jm.eos_so, jm.g, cfg, True, addisop=jm.addisop)
    tiso = t_isopyc.compute_isopyc(
        T(fields["tm1"]), tm.tmask, tm.kmt, tm.eos_c, tm.eos_to, tm.eos_so,
        tm.g, tm.cfg.ocean, True, addisop=tm.addisop)
    for name in ("K11", "K22", "K33", "alphai", "betai", "ddxt", "ddyt",
                 "ddzt", "vetiso", "vntiso", "vbtiso"):
        close(getattr(tiso, name), getattr(jiso, name))
    close(t_isopyc.iso_weight_stack(t_isopyc.iso_weight_pack(tiso, tm.g)),
          j_isopyc.iso_weight_stack(j_isopyc.iso_weight_pack(jiso, jm.g)))

    jd = jiso.alphai * jiso.ddzt[0] + jiso.betai * jiso.ddzt[1]
    td = tiso.alphai * tiso.ddzt[0] + tiso.betai * tiso.ddzt[1]
    ref = j_vmix.tidal_kv_diff(jd, jm.kmt, jm.tidal_zw, jm.tlat_deg,
                               jm.tidal_edr, jm.diff_cbt)
    got = t_vmix.tidal_kv_diff(td, tm.kmt, tm.tidal_zw, tm.tlat_deg,
                               tm.tidal_edr, tm.diff_cbt)
    close(got, ref)


def test_filters(models, fields):
    jm, tm = models
    t, u = fields["t"], fields["u"]
    close(tm.filt_t(T(t)), jm.filt_t(jnp.asarray(t)))
    close(tm.filt_u(T(u)), jm.filt_u(jnp.asarray(u)))
    close(tm.filt_sf(T(t[0, 0])), jm.filt_sf(jnp.asarray(t[0, 0])))


def test_tropic_pieces(models, fields):
    jm, tm = models
    g = jm.params.grid
    rng = np.random.default_rng(5)
    zu = rng.standard_normal((2, g.jmt, g.imt))
    ref = j_tropic.sfforc(jnp.asarray(zu), jm.g.dxu, jm.g.dyu, jm.g.csu)
    close(t_tropic.sfforc(T(zu), tm.g.dxu, tm.g.dyu, tm.g.csu), ref)
    psi = 1e12 * rng.standard_normal((g.jmt, g.imt))
    ref = j_tropic.ext_mode_velocity(jnp.asarray(psi), jm.g.hr, jm.g.dxu2r,
                                     jm.g.dyu2r, jm.g.csur)
    got = t_tropic.ext_mode_velocity(T(psi), tm.g.hr, tm.g.dxu2r,
                                     tm.g.dyu2r, tm.g.csur)
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("warm", [False, True])
def test_congrad_same_iterations(models, warm):
    """congrad on the same system: same iteration count, same answer
    (both to rtol 1e-9 of the solution scale: the stop rule is an
    extrapolated error of tolerance ~1e-7 of it)."""
    jm, tm = models
    rng = np.random.default_rng(7)
    omask = np.asarray(jm.isl.ocean_mask)
    interior = np.zeros_like(omask)
    interior[1:-1, 1:-1] = 1.0
    forc = rng.normal(size=omask.shape) * omask * interior
    c2dtsf = 2.0 * jm.cfg.ocean.dtsf
    cf = jm.cf_unit / c2dtsf
    mx = jm.cfg.ocean.mxscan
    pilot, *_ = j_solvers.congrad(cf, jnp.zeros_like(forc), jnp.asarray(forc),
                                  jm.isl, 1e-30, mx, True)
    tol = 1e-7 * float(jnp.abs(pilot).max())
    guess = 0.9 * np.asarray(pilot) if warm else np.zeros_like(omask)
    ref, it_ref, _, conv = j_solvers.congrad(
        cf, jnp.asarray(guess), jnp.asarray(forc), jm.isl, tol, mx, True)
    got, it_got, _, tconv = t_solvers.congrad(
        tm.cf_unit / c2dtsf, T(guess), T(forc), tm.isl, tol, mx, True)
    assert int(it_ref) == it_got and bool(conv) == tconv
    close(got, ref, rtol=1e-9)
    # the port's solver object (plain path on the CPU) is the same solve
    dpsi, iters = tm.cg_solver(T(guess), T(forc), c2dtsf, tol)
    assert int(iters) == it_got
    close(dpsi, ref, rtol=1e-9)


def _conv_case(seed):
    km, jmt, imt = 6, 5, 5
    zt = (np.arange(km) + 0.5) * 100.0e2
    eos = j_eos.fit_eos(zt)
    dz = np.full(km, 100.0e2)
    rng = np.random.default_rng(seed)
    kmt = rng.integers(0, km + 1, size=(jmt, imt)).astype(np.int32)
    t = np.zeros((3, km, jmt, imt))
    t[0] = 10.0 + 3.0 * rng.standard_normal((km, jmt, imt))
    t[1] = 1e-3 * rng.standard_normal((km, jmt, imt))
    t[2] = rng.standard_normal((km, jmt, imt))
    return t, kmt, eos, dz


@pytest.mark.parametrize("seed", [11, 12])
def test_stable_labels_fixed_passes(seed):
    """km fixed passes reach the labels of the data-dependent while_loop,
    and convct_full agrees."""
    t, kmt, eos, dz = _conv_case(seed)
    jargs = (jnp.asarray(kmt), jnp.asarray(eos.c), jnp.asarray(eos.to),
             jnp.asarray(eos.so), jnp.asarray(dz))
    targs = (T(kmt), T(eos.c), T(eos.to), T(eos.so), T(dz))
    ref = j_conv._stable_labels(jnp.asarray(t), *jargs)
    got = t_conv._stable_labels(T(t), *targs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    close(t_conv.convct_full(T(t), *targs),
          j_conv.convct_full(jnp.asarray(t), *jargs))
