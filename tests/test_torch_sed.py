"""The port's ocean sediments against ``uvic_tpu`` on the CPU, in float64.

``models/sed/sediment.py`` (the legacy interfacial closure) and every
function of ``models/sed/porewater.py`` on the column inputs of
``tests/test_porewater.py`` (its bottom water, its shallow and deep
sites, its low and high organic rain), with seeded noise across the
columns and one land column: each output agrees with the JAX package's
to 1e-9 of its largest magnitude, through one ``porewater_step`` and
through five chained ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.models.sed import porewater as jpw
from uvic_tpu.models.sed import sediment as jsed

from uvic_tpu_torch.models.sed import porewater as tpw
from uvic_tpu_torch.models.sed import sediment as tsed

TOL = 1e-9
SHAPE = (3, 4)
# the sites of tests/test_porewater.py, as overrides of its bottom water
SITES = {
    "bottom_water": {},
    "shallow": dict(depth_m=1500.0),
    "deep": dict(depth_m=5000.0),
    "low_rain": dict(rain_org=0.2e-6 / 3.15e7),
    "high_rain": dict(rain_org=30e-6 / 3.15e7),
}


def _close(got, ref, what, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


def _bw(site="bottom_water", seed=0):
    """The bottom water of tests/test_porewater.py at ``site``, with
    seeded noise across the columns and column (0, 0) on land."""
    d = dict(temp=2.0, sal=35.0, alk_bw=2.4e-3, tco2_bw=2.35e-3,
             o2_bw=1.5e-4, rain_cal=1e-6 / 3.15e7, rain_org=1e-6 / 3.15e7,
             depth_m=4000.0)
    d.update(SITES[site])
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in d.items():
        noise = dict(temp=0.5, sal=0.2 / 35.0).get(k, 0.05)
        out[k] = v * (1.0 + noise * rng.standard_normal(SHAPE)) \
            if k != "temp" else v + noise * rng.standard_normal(SHAPE)
    mask = np.ones(SHAPE)
    mask[0, 0] = 0.0
    out["ocean_mask"] = mask
    return out


def _both(d):
    """(JAX arrays, torch tensors) of a dict of NumPy arrays."""
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _pw_state(seed):
    """A pore-water state away from the initial one: seeded profiles."""
    rng = np.random.default_rng(seed)
    k, (j, i) = tpw.KMAX, SHAPE
    return dict(
        calgg=np.clip(0.5 + 0.2 * rng.standard_normal((k, j, i)), 0.05, 0.9),
        orggg=0.003 * np.exp(0.3 * rng.standard_normal((k, j, i))),
        carb=np.stack([2.0e-5, 1.8e-3, 9.0e-5])[:, None, None, None]
        * np.exp(0.1 * rng.standard_normal((3, k, j, i))),
        o2=1.5e-4 * np.exp(0.2 * rng.standard_normal((k, j, i))),
        zrct=rng.uniform(0.5, 10.0, (j, i)),
        buried=rng.uniform(0.0, 1e-3, (j, i)),
        buried_org=np.zeros((j, i)))


def _states(seed):
    st = _pw_state(seed)
    jst, tst = _both(st)
    return jpw.PoreWaterState(**jst), tpw.PoreWaterState(**tst)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_chemistry_matches():
    """calc_k and calc_buff on the bottom water of every site."""
    for n, site in enumerate(SITES):
        j, t = _both(_bw(site, n))
        jk = jpw.calc_k(j["temp"], j["sal"], j["depth_m"])
        tk = tpw.calc_k(t["temp"], t["sal"], t["depth_m"])
        for name, a, b in zip(("k1", "k2", "kb", "csat"), tk, jk):
            _close(a, b, f"{site} {name}")
        jb = jpw.calc_buff(j["alk_bw"], j["tco2_bw"], j["sal"], *jk[:3])
        tb = tpw.calc_buff(t["alk_bw"], t["tco2_bw"], t["sal"], *tk[:3])
        for name, a, b in zip(("co2", "hco3", "co3"), tb, jb):
            _close(a, b, f"{site} {name}")


def _column(seed):
    """(JAX, torch) pore, form and the O2 penetration depth of seeded
    columns."""
    st = _pw_state(seed)
    jc, tc = _both(dict(calgg=st["calgg"][-1], zrct=st["zrct"]))
    jpore = jpw._set_pore(jc["calgg"])
    tpore = tpw._set_pore(tc["calgg"])
    return (jpore, jpore ** jpw.EXPB, jc["zrct"]), \
        (tpore, tpore ** tpw.EXPB, tc["zrct"])


def _random_blocks(rng, n, diag_dominant=True):
    """A block-tridiagonal system with 3x3 blocks over SHAPE columns."""
    L = rng.standard_normal((n, 3, 3) + SHAPE) * 0.3
    U = rng.standard_normal((n, 3, 3) + SHAPE) * 0.3
    D = rng.standard_normal((n, 3, 3) + SHAPE) * 0.3
    D += 3.0 * np.eye(3)[None, :, :, None, None]
    L[0] = 0.0
    U[-1] = 0.0
    R = rng.standard_normal((n, 3) + SHAPE)
    return L, D, U, R


@pytest.mark.parametrize("fn", ["set_pore", "face_ops", "face_ops_harmonic",
                                "db_ops", "react_gate", "tridiag",
                                "block_thomas", "minv3", "orgc_o2",
                                "co3_newton"])
def test_column_functions_match(fn):
    (jpore, jform, jz), (tpore, tform, tz) = _column(3)
    if fn == "set_pore":
        _close(tpore, jpore, "pore")
        _close(tform, jform, "form")
    elif fn in ("face_ops", "face_ops_harmonic"):
        h = fn.endswith("harmonic")
        for coef in (tpw.DIFO2,) + tpw.DIFC:
            for a, b, nm in zip(tpw._face_ops(coef, tform, tpore, h),
                                jpw._face_ops(coef, jform, jpore, h),
                                ("dplus", "dminus")):
                _close(a, b, f"{nm} {coef}")
    elif fn == "db_ops":
        for a, b, nm in zip(tpw._db_ops(tpore), jpw._db_ops(jpore),
                            ("dbpls", "dbmin")):
            _close(a, b, nm)
    elif fn == "react_gate":
        # depths on, between and beyond the level depths
        z = np.array(tpw.ZSED)
        zr = np.concatenate([z[1:], 0.5 * (z[1:] + z[:-1]), [0.1, 12.0]])
        zr = np.resize(zr, SHAPE)
        _close(tpw._react_gate(torch.from_numpy(zr)),
               jpw._react_gate(jnp.asarray(zr)), "gate on set depths")
        _close(tpw._react_gate(tz), jpw._react_gate(jz), "gate")
    elif fn == "tridiag":
        rng = np.random.default_rng(4)
        n = tpw.KMAX - 1
        a, c = (rng.uniform(0.1, 0.5, (n,) + SHAPE) for _ in range(2))
        b = 2.0 + rng.uniform(0, 1, (n,) + SHAPE)
        r = rng.standard_normal((n,) + SHAPE)
        _close(tpw._tridiag(*(torch.from_numpy(x) for x in (a, b, c, r))),
               jpw._tridiag(*(jnp.asarray(x) for x in (a, b, c, r))), fn)
    elif fn in ("block_thomas", "minv3"):
        L, D, U, R = _random_blocks(np.random.default_rng(5),
                                    tpw.KMAX - 1)
        x = tpw._block_thomas(*(torch.from_numpy(v) for v in (L, D, U, R)))
        ref = jpw._block_thomas(*(jnp.asarray(v) for v in (L, D, U, R)))
        _close(x, ref, fn)
        # and against a dense solve of the whole system, column (1, 2)
        n = tpw.KMAX - 1
        A = np.zeros((3 * n, 3 * n))
        for k in range(n):
            A[3 * k:3 * k + 3, 3 * k:3 * k + 3] = D[k, :, :, 1, 2]
            if k > 0:
                A[3 * k:3 * k + 3, 3 * k - 3:3 * k] = L[k, :, :, 1, 2]
            if k < n - 1:
                A[3 * k:3 * k + 3, 3 * k + 3:3 * k + 6] = U[k, :, :, 1, 2]
        dense = np.linalg.solve(A, R[:, :, 1, 2].reshape(-1))
        np.testing.assert_allclose(x[:, :, 1, 2].numpy().reshape(-1), dense,
                                   rtol=1e-10, atol=1e-12)
        if fn == "minv3":
            inv = tpw._minv3(torch.from_numpy(D[2]))
            prod = np.einsum("ab...,bc...->ac...", inv.numpy(), D[2])
            np.testing.assert_allclose(
                prod, np.broadcast_to(np.eye(3)[:, :, None, None],
                                      prod.shape), atol=1e-12)
    elif fn == "orgc_o2":
        rng = np.random.default_rng(6)
        rain = 1e-6 * np.exp(rng.standard_normal(SHAPE))
        rc = np.full(SHAPE, 2.0e-9)
        o2_bw = 1.5e-4 * np.exp(0.2 * rng.standard_normal(SHAPE))
        orggg0 = _pw_state(7)["orggg"]
        jout = jpw._orgc_o2(jnp.asarray(rain), jnp.asarray(rc), jpore, jform,
                            jnp.asarray(o2_bw), jz, jnp.asarray(orggg0))
        tout = tpw._orgc_o2(torch.from_numpy(rain), torch.from_numpy(rc),
                            tpore, tform, torch.from_numpy(o2_bw), tz,
                            torch.from_numpy(orggg0))
        for a, b, nm in zip(tout, jout, ("orggg", "orgml", "o2", "zrct",
                                         "resp_c1")):
            _close(a, b, nm)
    elif fn == "co3_newton":
        bw = _bw("deep", 8)
        j, t = _both(bw)
        jk = jpw.calc_k(j["temp"], j["sal"], j["depth_m"])
        tk = tpw.calc_k(t["temp"], t["sal"], t["depth_m"])
        st = _pw_state(9)
        resp = 1e-12 * np.exp(np.random.default_rng(10).standard_normal(
            (tpw.KMAX,) + SHAPE))
        resp[0] = 0.0
        jc, tc = _both(dict(carb=st["carb"], calgg=st["calgg"], resp=resp))
        jout = jpw._co3_newton(jc["carb"], jc["resp"], jc["calgg"], jpore,
                               jform, jk[3], jk[0], jk[1])
        tout = tpw._co3_newton(tc["carb"], tc["resp"], tc["calgg"], tpore,
                               tform, tk[3], tk[0], tk[1])
        for n, nm in enumerate(("co2", "hco3", "co3")):
            _close(tout[0][n], jout[0][n], nm)
        _close(tout[1], jout[1], "cal_c")


def _step_both(jst, tst, bw, dtsed=86400.0 * 360):
    j, t = _both(bw)
    jnew, jfl = jpw.porewater_step(jst, dtsed_s=dtsed, **j)
    tnew, tfl = tpw.porewater_step(tst, dtsed_s=dtsed, **t)
    return jnew, jfl, tnew, tfl


def _compare_step(jnew, jfl, tnew, tfl, what):
    assert set(tfl) == set(jfl)
    for k in jfl:
        _close(tfl[k], jfl[k], f"{what} flux {k}")
    for f in tpw.PW_FIELDS:
        _close(getattr(tnew, f), getattr(jnew, f), f"{what} {f}")


@pytest.mark.parametrize("site", sorted(SITES))
@pytest.mark.parametrize("start", ["init", "seeded"])
def test_porewater_step_matches(site, start):
    if start == "init":
        jst = jpw.init_porewater(*SHAPE)
        tst = tpw.init_porewater(*SHAPE)
        for f in tpw.PW_FIELDS:
            _close(getattr(tst, f), getattr(jst, f), f"init {f}")
    else:
        jst, tst = _states(11)
    _compare_step(*_step_both(jst, tst, _bw(site, 12)), f"{site} {start}")


def test_porewater_five_chained_steps_match():
    """Five steps in corrosive deep water (the calcite stock erodes, as
    in tests/test_porewater.py), a segment's dtsed each."""
    jst = jpw.init_porewater(*SHAPE)
    tst = tpw.init_porewater(*SHAPE)
    bw = _bw("deep", 13)
    for n in range(5):
        jst, jfl, tst, tfl = _step_both(jst, tst, bw, dtsed=432000.0)
        _compare_step(jst, jfl, tst, tfl, f"step {n + 1}")
    assert float(tst.calgg[-1, 1, 1]) < 0.5


def test_legacy_sediment_matches():
    """init_sed_state, co3_saturation, add_rain and three sed_steps on
    seeded bottom-water carbonate, over- and undersaturated."""
    rng = np.random.default_rng(14)
    depth = rng.uniform(1.0e5, 6.0e5, SHAPE)          # cm
    mask = np.ones(SHAPE)
    mask[0, 0] = 0.0
    js = jsed.init_sed_state(*SHAPE, jnp.float64)
    ts = tsed.init_sed_state(*SHAPE, torch.float64)
    for f in tsed.SED_FIELDS:
        _close(getattr(ts, f), getattr(js, f), f"init {f}")
    _close(tsed.co3_saturation(torch.from_numpy(depth)),
           jsed.co3_saturation(jnp.asarray(depth)), "co3sat")
    for n in range(3):
        rain = rng.uniform(0.0, 50.0, (2,) + SHAPE)
        js = jsed.add_rain(js, jnp.asarray(rain[0]), jnp.asarray(rain[1]))
        ts = tsed.add_rain(ts, torch.from_numpy(rain[0]),
                           torch.from_numpy(rain[1]))
        co3 = 0.1 * np.exp(0.5 * rng.standard_normal(SHAPE))
        js, jfl = jsed.sed_step(js, jnp.asarray(co3), jnp.asarray(depth),
                                jnp.asarray(mask), 432000.0)
        ts, tfl = tsed.sed_step(ts, torch.from_numpy(co3),
                                torch.from_numpy(depth),
                                torch.from_numpy(mask), 432000.0)
        for f in tsed.SED_FIELDS:
            _close(getattr(ts, f), getattr(js, f), f"step {n} {f}")
        assert set(tfl) == set(jfl)
        for k in jfl:
            _close(tfl[k], jfl[k], f"step {n} flux {k}")
