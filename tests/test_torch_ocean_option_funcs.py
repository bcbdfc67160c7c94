"""The functions of the port's ocean options against their ``uvic_tpu``
counterparts on the CPU, in float64, on seeded NumPy inputs at the small
grid of ``tests/torch_option_runs.py``: rtol 1e-12 of each output's
largest magnitude, and bitwise where a field is exact by construction
(host-side operators, masks, filter matrices).  The functions with a
barotropic CG solve inside (``tropic_step`` on the 9-point operator,
``surface_pressure_step``) solve to convergence in both packages and are
held at RTOL_SOLVE.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.models.ocean import hmix as j_hmix
from uvic_tpu.models.ocean import isopyc as j_isopyc
from uvic_tpu.models.ocean import kernels as j_kernels
from uvic_tpu.models.ocean import neptune as j_neptune
from uvic_tpu.models.ocean import surfpress as j_surfpress
from uvic_tpu.models.ocean import tropic as j_tropic
from uvic_tpu.models.ocean import vmix as j_vmix
from uvic_tpu.ops import advection as j_adv
from uvic_tpu.ops import convection as j_conv
from uvic_tpu.ops import filters as j_filters

from uvic_tpu_torch.models.ocean import hmix as t_hmix
from uvic_tpu_torch.models.ocean import isopyc as t_isopyc
from uvic_tpu_torch.models.ocean import kernels as t_kernels
from uvic_tpu_torch.models.ocean import neptune as t_neptune
from uvic_tpu_torch.models.ocean import surfpress as t_surfpress
from uvic_tpu_torch.models.ocean import tropic as t_tropic
from uvic_tpu_torch.models.ocean import vmix as t_vmix
from uvic_tpu_torch.ops import advection as t_adv
from uvic_tpu_torch.ops import convection as t_conv
from uvic_tpu_torch.ops import filters as t_filters
from uvic_tpu_torch.ops.cg_kernel import CGSolver

from torch_option_runs import SP_CONVERGED, setup

RTOL = 1e-12
# functions with a barotropic CG solve inside, solved to convergence in
# both packages: the two CGs differ in the order of their sums
RTOL_SOLVE = 1e-10


def close(got, ref, label, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, label
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"{label}: err {err:.3e}, scale {scale:.3e}"


def pair(x):
    """(jnp, torch) copies of a NumPy array."""
    return jnp.asarray(x), torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def models():
    """Both packages' small models (flagship-like: isopycnal/GM mixing,
    quicker coefficients in the bag) and a seeded state: tracers with
    unstable columns, velocities."""
    ocean = dict(isopycmix=True, gent_mcwilliams=True,
                 tracer_advection="quicker")
    jm, tm, _, _, _, _ = setup(ocean)
    g = jm.params.grid
    rng = np.random.default_rng(7)
    shape = (g.km, g.jmt, g.imt)
    tmask = np.asarray(jm.tmask)
    t = np.zeros((2,) + shape)
    t[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None] \
        + 1.0 * rng.standard_normal(shape)
    t[1] = 1e-3 * rng.standard_normal(shape)
    t *= tmask
    tm1 = t + 0.1 * rng.standard_normal(t.shape) * tmask
    u = 5.0 * rng.standard_normal((2,) + shape) * np.asarray(jm.umask)
    return dict(jm=jm, tm=tm, t=t, tm1=tm1, u=u, rng=rng)


# ---------------------------------------------------------------------
# advection
# ---------------------------------------------------------------------

def _harsh_fct_inputs(cyclic_rng=0):
    km, jmt, imt = 4, 8, 10
    rng = np.random.default_rng(cyclic_rng)
    t_tau = rng.normal(size=(1, km, jmt, imt)) * 5
    t_tm1 = t_tau + 0.3 * rng.normal(size=(1, km, jmt, imt))
    vet = rng.normal(size=(1, km, jmt, imt)) * 50
    vnt = rng.normal(size=(1, km, jmt, imt)) * 50
    vbt = rng.normal(size=(1, km, jmt, imt)) * 5
    tmask = (rng.uniform(size=(1, km, jmt, imt)) > 0.2).astype(float)
    c2dt = np.full((1, km, 1, 1), 7200.0)
    return (t_tau, t_tm1, vet, vnt, vbt, tmask, c2dt,
            np.full((jmt, imt), 1 / 4e7), np.full((jmt, 1), 1 / 4e7),
            np.full((km, 1, 1), 1 / 1e4))


@pytest.mark.parametrize("variant,fct3d,cyclic", [
    ("dlm1", False, True), ("dlm2", False, True), ("dlm1", True, True),
    ("dlm2", True, True), ("dlm2", True, False)])
def test_fct_flux_variants(variant, fct3d, cyclic):
    args = _harsh_fct_inputs()
    ref = j_adv.fct_flux(*[jnp.asarray(a) for a in args], cyclic,
                         variant=variant, fct3d=fct3d)
    got = t_adv.fct_flux(*[torch.as_tensor(a) for a in args], cyclic,
                         variant=variant, fct3d=fct3d)
    for name, a, b in zip(("fe", "fn", "fb"), got, ref):
        close(a, b, f"{variant} 3d={fct3d} cyclic={cyclic} {name}")


def test_quicker_coefficients_and_flux(models):
    jm, tm = models["jm"], models["tm"]
    g = jm.params.grid
    ref_c = j_adv.quicker_coefficients(g)
    got_c = t_adv.quicker_coefficients(g)
    for ax in ("x", "y", "z"):
        for k in ref_c[ax]:
            np.testing.assert_array_equal(got_c[ax][k], ref_c[ax][k])
    rng = models["rng"]
    v = [rng.normal(size=models["t"].shape[1:]) * s for s in (50, 50, 5)]
    ref = j_adv.quicker_flux(jnp.asarray(models["t"]),
                             jnp.asarray(models["tm1"]),
                             *[jnp.asarray(x)[None] for x in v],
                             jm.tmask[None], jm.g.quicker)
    got = t_adv.quicker_flux(torch.as_tensor(models["t"]),
                             torch.as_tensor(models["tm1"]),
                             *[torch.as_tensor(x)[None] for x in v],
                             tm.tmask[None], tm.g.quicker)
    for name, a, b in zip(("fe", "fn", "fb"), got, ref):
        close(a, b, f"quicker {name}")


# ---------------------------------------------------------------------
# variable horizontal mixing, vertical mixing, convection
# ---------------------------------------------------------------------

def test_smagnl_terms(models):
    jm, tm = models["jm"], models["tm"]
    ju, tu = pair(models["u"])
    ref = j_hmix.smagnl_coefficients(ju, jm.g, True)
    got = t_hmix.smagnl_coefficients(tu, tm.g, True)
    for name, a, b in zip(("strain", "am_lambda", "am_phi"), got, ref):
        close(a, b, f"smagnl {name}")
    rc = j_hmix.smag_tracer_coefficients(ref[1], ref[2], 1e5)
    gc = t_hmix.smag_tracer_coefficients(got[1], got[2], 1e5)
    close(gc[0], rc[0], "diff_cet")
    close(gc[1], rc[1], "diff_cnt")
    jt, tt = pair(models["tm1"])
    close(t_hmix.tracer_hdiff_var(tt, tm.tmask, tm.g, *gc),
          j_hmix.tracer_hdiff_var(jt, jm.tmask, jm.g, *rc), "hdiff_var")
    for n in (0, 1):
        r = j_hmix.smag_momentum_terms(*ref, jm.g, jm.sine, n)
        a = t_hmix.smag_momentum_terms(*got, tm.g, tm.sine, n)
        for name, x, y in zip(("ux", "uy", "metric"), a, r):
            close(x, y, f"smag momentum {n} {name}")


@pytest.mark.parametrize("cyclic", [True, False])
def test_biharmonic_terms(models, cyclic):
    jm, tm = models["jm"], models["tm"]
    jt, tt = pair(models["tm1"])
    close(t_hmix.tracer_hdiff_bihar(tt, tm.tmask, tm.g, 5e20, cyclic),
          j_hmix.tracer_hdiff_bihar(jt, jm.tmask, jm.g, 5e20, cyclic),
          "tracer biharmonic")
    ju, tu = pair(models["u"])
    for n in (0, 1):
        close(t_hmix.momentum_bihar_terms(tu, tm.umask, tm.g, 1e21, n,
                                          cyclic),
              j_hmix.momentum_bihar_terms(ju, jm.umask, jm.g, 1e21, n,
                                          cyclic), f"momentum biharmonic {n}")


def test_ppmix_coefficients(models):
    jm, tm = models["jm"], models["tm"]
    jt, tt = pair(models["tm1"])
    ju, tu = pair(models["u"])
    ref = j_vmix.ppmix_coefficients(jt, ju, jm.tmask, jm.umask, jm.eos_c,
                                    jm.eos_to, jm.eos_so, jm.g)
    got = t_vmix.ppmix_coefficients(tt, tu, tm.tmask, tm.umask, tm.eos_c,
                                    tm.eos_to, tm.eos_so, tm.g)
    close(got[0], ref[0], "diff_cbt")
    close(got[1], ref[1], "visc_cbu")


@pytest.mark.parametrize("ncon", [1, 3])
def test_convct_ncon(models, ncon):
    jm, tm = models["jm"], models["tm"]
    jt, tt = pair(models["t"])
    ref = j_conv.convct_ncon(jt, jm.kmt, jm.eos_c, jm.eos_to, jm.eos_so,
                             jm.dztxcl, ncon)
    got = t_conv.convct_ncon(tt, tm.kmt, tm.eos_c, tm.eos_to, tm.eos_so,
                             tm.dztxcl, ncon)
    assert float(np.abs(np.asarray(ref) - models["t"]).max()) > 0.0
    close(got, ref, f"convct_ncon {ncon}")


# ---------------------------------------------------------------------
# Neptune, shortwave, the full tensor
# ---------------------------------------------------------------------

def test_neptune_velocity_is_bitwise(models):
    jm = models["jm"]
    ref = j_neptune.neptune_velocity(jm.params.grid, jm.params.topo)
    got = t_neptune.neptune_velocity(jm.params.grid, jm.params.topo)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() > 0.0


def test_full_tensor_isopycnal_fields_and_fluxes(models):
    jm, tm = models["jm"], models["tm"]
    jcfg = dataclasses.replace(jm.cfg.ocean, full_tensor=True)
    tcfg = dataclasses.replace(tm.cfg.ocean, full_tensor=True)
    assert t_isopyc.full_tensor_delta(tm.g, tcfg) \
        == j_isopyc.full_tensor_delta(jm.g, jcfg)
    jt, tt = pair(models["tm1"])
    for jc, tc in ((jm.cfg.ocean, tm.cfg.ocean), (jcfg, tcfg)):
        ref = j_isopyc.compute_isopyc(jt, jm.tmask, jm.kmt, jm.eos_c,
                                      jm.eos_to, jm.eos_so, jm.g, jc, True)
        got = t_isopyc.compute_isopyc(tt, tm.tmask, tm.kmt, tm.eos_c,
                                      tm.eos_to, tm.eos_so, tm.g, tc, True)
        label = "full" if tc.full_tensor else "small-angle"
        for name in ("K11", "K22", "K33", "vetiso", "vntiso", "vbtiso"):
            close(getattr(got, name), getattr(ref, name), f"{label} {name}")
        if tc.full_tensor:
            close(got.ai0_e, ref.ai0_e, "ai0_e")
            for ip in (0, 1):
                for jq in (0, 1):
                    close(got.drodye[ip][jq], ref.drodye[ip][jq], "drodye")
                    close(got.drodxn[ip][jq], ref.drodxn[ip][jq], "drodxn")
        rf = j_isopyc.isoflux(ref, jt, jm.tmask, jm.g)
        gf = t_isopyc.isoflux(got, tt, tm.tmask, tm.g)
        for name, a, b in zip(("fe", "fn", "fb"), gf, rf):
            close(a, b, f"{label} isoflux {name}")


# ---------------------------------------------------------------------
# the generic tracer step
# ---------------------------------------------------------------------

@pytest.mark.parametrize("scheme,kw", [
    ("fct", {}), ("fct", dict(fct_variant="dlm2")),
    ("fct", dict(fct3d=True)), ("centered", {}), ("upstream", {}),
    ("quicker", {})])
@pytest.mark.parametrize("branch", ["const", "iso", "smagnl", "biharmonic",
                                    "iso_smagnl"])
def test_tracer_step_schemes_and_branches(models, scheme, kw, branch):
    jm, tm = models["jm"], models["tm"]
    g = jm.params.grid
    rng = np.random.default_rng(11)
    jt, tt = pair(models["t"])
    jt1, tt1 = pair(models["tm1"])
    ju, tu = pair(models["u"])
    jv = j_kernels.adv_vel(ju[0], ju[1], jm.g)[:3]
    tv = t_kernels.adv_vel(tu[0], tu[1], tm.g)[:3]
    stf, btf = 1e-4 * rng.normal(size=(2, 2, g.jmt, g.imt))
    jiso = tiso = jh = th = None
    if "iso" in branch:
        jiso = j_isopyc.compute_isopyc(jt1, jm.tmask, jm.kmt, jm.eos_c,
                                       jm.eos_to, jm.eos_so, jm.g,
                                       jm.cfg.ocean, True)
        tiso = t_isopyc.compute_isopyc(tt1, tm.tmask, tm.kmt, tm.eos_c,
                                       tm.eos_to, tm.eos_so, tm.g,
                                       tm.cfg.ocean, True)
    if "smagnl" in branch:
        rj = j_hmix.smagnl_coefficients(ju, jm.g)
        rt = t_hmix.smagnl_coefficients(tu, tm.g)
        jh = ("smagnl",) + j_hmix.smag_tracer_coefficients(rj[1], rj[2])
        th = ("smagnl",) + t_hmix.smag_tracer_coefficients(rt[1], rt[2])
    elif branch == "biharmonic":
        jh = th = ("biharmonic", 5e20)
    aidif = 0.5 if jiso is not None else 0.0
    ref = j_kernels.tracer_step(
        jt, jt1, *jv, jnp.asarray(stf), jnp.asarray(btf), None, jm.diff_cbt,
        jm.kmt, jm.tmask, jm.g, 7200.0, scheme, aidif, True, iso=jiso,
        hmix=jh, **kw)
    got = t_kernels.tracer_step(
        tt, tt1, *tv, torch.as_tensor(stf), torch.as_tensor(btf), None,
        tm.diff_cbt, tm.kmt, tm.tmask, tm.g, 7200.0, scheme, aidif, True,
        iso=tiso, hmix=th, **kw)
    close(got, ref, f"{scheme} {kw} {branch}")


# ---------------------------------------------------------------------
# barotropic operators, the streamfunction's 9-point solve, the filters
# ---------------------------------------------------------------------

@pytest.mark.parametrize("npt", [5, 9])
@pytest.mark.parametrize("acor", [0.0, 0.5])
def test_streamfunction_operators_are_bitwise(models, npt, acor):
    jm = models["jm"]
    g, topo = jm.params.grid, jm.params.topo
    args = (np.asarray(g.dxu), np.asarray(g.dyu), np.asarray(g.csu),
            np.asarray(topo.hr))
    f = np.asarray(jm.params.cori[0])
    jfn = j_tropic.sfc9pt_unit if npt == 9 else j_tropic.sfc5pt_unit
    tfn = t_tropic.sfc9pt_unit if npt == 9 else t_tropic.sfc5pt_unit
    ref, got = jfn(*args, f=f, acor=acor), tfn(*args, f=f, acor=acor)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert (np.abs(got[1]).max() > 0.0) == (acor != 0.0)


@pytest.mark.parametrize("leapfrog,euler2,save_ptd", [
    (True, False, True), (False, False, True), (False, False, False),
    (False, True, True)])
def test_tropic_step_9_point_with_acor(models, leapfrog, euler2, save_ptd):
    """tropic_step on the 9-point operator with implicit Coriolis and
    the checkerboard deflation, the port's solver on the step's whole
    operator (called with c2dtsf 1), solved to convergence."""
    jm, tm = models["jm"], models["tm"]
    g = jm.params.grid
    rng = np.random.default_rng(3)
    cf_unit, cf_acor = t_tropic.sfc9pt_unit(
        np.asarray(g.dxu), np.asarray(g.dyu), np.asarray(g.csu),
        np.asarray(jm.params.topo.hr), f=np.asarray(jm.params.cori[0]),
        acor=0.5)
    c2dtsf = 1800.0 if leapfrog else 900.0
    zu = rng.normal(size=(2, g.jmt, g.imt)) * np.asarray(jm.umask[0])
    psi = 1e10 * rng.normal(size=(4, g.jmt, g.imt))
    tol = 1e-2
    ref = j_tropic.tropic_step(
        jnp.asarray(zu), *[jnp.asarray(p) for p in psi],
        jnp.asarray(cf_unit), jnp.asarray(cf_acor), jm.isl, jm.g.dxu,
        jm.g.dyu, jm.g.csu, c2dtsf, tol, 2000, leapfrog, True,
        euler2=euler2, save_ptd=save_ptd, npt=9)
    cf = torch.as_tensor(cf_unit) / c2dtsf + torch.as_tensor(cf_acor)
    solver = CGSolver(cf, tm.isl, 2000, True)
    got = t_tropic.tropic_step(
        torch.as_tensor(zu), *[torch.as_tensor(p) for p in psi], tm.isl,
        tm.g.dxu, tm.g.dyu, tm.g.csu, c2dtsf, tol, 2000, leapfrog, solver,
        True, euler2=euler2, save_ptd=save_ptd, npt=9, solve_c2dtsf=1.0)
    for name, a, b in zip(("psi0", "psi1", "ptd", "ptdb"), got[:4],
                          ref[:4]):
        close(a, b, name, rtol=RTOL_SOLVE)
    assert int(got[4]) == int(ref[4])


@pytest.mark.parametrize("kind,cyclic", [("symmetric", True),
                                         ("asymmetric", True),
                                         ("symmetric", False)])
def test_fourier_filter_is_bitwise(models, kind, cyclic):
    jm = models["jm"]
    g, topo = jm.params.grid, jm.params.topo
    mask = np.asarray(topo.tmask if kind == "symmetric" else topo.umask)
    ref = j_filters.build_fourier_filter(mask, np.asarray(g.yt), kind,
                                         cyclic, np.float64)
    got = t_filters.build_fourier_filter(mask, np.asarray(g.yt), kind,
                                         cyclic, torch.float64)
    np.testing.assert_array_equal(got.rows.numpy(), ref.rows)
    np.testing.assert_array_equal(got.mats.numpy(), np.asarray(ref.mats))
    assert got.rows.numel() > 0
    x = models["t"]
    close(got(torch.as_tensor(x)), ref(jnp.asarray(x)), "filtered field")


# ---------------------------------------------------------------------
# the surface-pressure modes
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def sp_models():
    out = {}
    for mode in ("surface_pressure", "implicit_free_surface"):
        jm, tm, _, _, _, _ = setup(dict(barotropic=mode, **SP_CONVERGED))
        out[mode] = (jm, tm)
    return out


def test_surface_pressure_operators(sp_models):
    jm, tm = sp_models["implicit_free_surface"]
    g, topo = jm.params.grid, jm.params.topo
    args = (np.asarray(g.dxu), np.asarray(g.dyu), np.asarray(g.csu),
            np.asarray(topo.h))
    np.testing.assert_array_equal(t_surfpress.spc9pt_unit(*args),
                                  j_surfpress.spc9pt_unit(*args))
    np.testing.assert_array_equal(tm.cf_sp.numpy(), np.asarray(jm.cf_sp))
    np.testing.assert_array_equal(tm.fs_diag_unit.numpy(),
                                  np.asarray(jm.fs_diag_unit))
    np.testing.assert_array_equal(tm.sp_omask.numpy(),
                                  np.asarray(jm.sp_omask))
    rng = np.random.default_rng(5)
    uhat = rng.normal(size=(2, g.jmt, g.imt))
    close(t_surfpress.spforc(torch.as_tensor(uhat), tm.g.dxu, tm.g.dyu,
                             tm.g.csu, tm.g.h),
          j_surfpress.spforc(jnp.asarray(uhat), jm.g.dxu, jm.g.dyu,
                             jm.g.csu, jm.g.h), "spforc")
    x = rng.normal(size=(g.jmt, g.imt))
    close(t_surfpress.checkerboard_remove(torch.as_tensor(x), tm.sp_omask),
          j_surfpress.checkerboard_remove(jnp.asarray(x), jm.sp_omask),
          "checkerboard_remove")
    close(t_surfpress.zero_level(torch.as_tensor(x), tm.sp_omask, tm.g.dxt,
                                 tm.g.dyt, tm.g.cst),
          j_surfpress.zero_level(jnp.asarray(x), jm.sp_omask, jm.g.dxt,
                                 jm.g.dyt, jm.g.cst), "zero_level")


@pytest.mark.parametrize("mode", ["surface_pressure",
                                  "implicit_free_surface"])
@pytest.mark.parametrize("leapfrog,eb_pass", [(True, 0), (False, 0),
                                              (False, 1), (False, 2)])
def test_surface_pressure_step(sp_models, mode, leapfrog, eb_pass):
    """One external-mode step with the port's solver on the step's whole
    operator, solved to convergence, from seeded levels."""
    jm, tm = sp_models[mode]
    o = jm.cfg.ocean
    g = jm.params.grid
    rng = np.random.default_rng(9)
    zu = 1e-3 * rng.normal(size=(2, g.jmt, g.imt)) * np.asarray(jm.umask[0])
    ps = 10.0 * rng.normal(size=(4, g.jmt, g.imt))
    ub = rng.normal(size=(2, 2, g.jmt, g.imt)) * np.asarray(jm.umask[0])
    c2dtsf = 2 * o.dtsf if leapfrog else o.dtsf
    alph, gam, theta = jm.sp_consts
    fs = mode == "implicit_free_surface"
    ps1_eff = ps[1] if leapfrog else ps[0]
    ref = j_surfpress.surface_pressure_step(
        jnp.asarray(zu), *[jnp.asarray(p) for p in
                           (ps[0], ps[1], ps1_eff, ps[2])],
        jnp.asarray(ub[0]), jnp.asarray(ub[1]), jm.cf_sp, jm.fs_diag_unit,
        jm.isl_sp, jm.g, jm.umask[0], jm.sp_omask, c2dtsf, o.dtsf,
        o.tolrfs if fs else o.tolrsp, o.mxscan, leapfrog, free_surface=fs,
        alph=alph, gam=gam, theta=theta, eb_pass=eb_pass)
    solver, _ = tm.barotropic_solver(leapfrog)
    got = t_surfpress.surface_pressure_step(
        torch.as_tensor(zu), *[torch.as_tensor(p) for p in
                               (ps[0], ps[1], ps1_eff, ps[2])],
        torch.as_tensor(ub[0]), torch.as_tensor(ub[1]), solver, tm.g,
        tm.umask[0], tm.sp_omask, c2dtsf, o.dtsf,
        o.tolrfs if fs else o.tolrsp, leapfrog, free_surface=fs, alph=alph,
        gam=gam, theta=theta, eb_pass=eb_pass)
    for name, a, b in zip(("ps0", "ps1", "pguess", "ubar"), got[:4],
                          ref[:4]):
        close(a, b, f"{mode} lf={leapfrog} eb={eb_pass} {name}",
              rtol=RTOL_SOLVE)
    if fs:
        assert int(got[4]) == int(ref[4])
    else:
        # the rigid lid's operator is singular (checkerboard and
        # constant): its converged solves stop a few trips apart
        assert max(int(got[4]), int(ref[4])) < o.mxscan
