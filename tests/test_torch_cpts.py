"""The port's multi-category sea ice (``uvic_tpu_torch.models.ice.cpts``)
against ``uvic_tpu.models.ice.cpts`` on the CPU, in float64, function by
function on the same seeded inputs, mirroring ``tests/test_cpts.py``.

Every output agrees to TOL (1e-12) of its largest magnitude; the
thermodynamics also in the scenarios of the reference's tests (cold
growth, warm melt, new ice over open water, congelation under full
cover, flooding), and the category tables (bounds, salinity profile)
exactly.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.models.ice import cpts as J
from uvic_tpu_torch.models.ice import cpts as T
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

TOL = 1e-12
RNG = 2024


def close(got, ref, what, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


def t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def j(x):
    return jnp.asarray(np.asarray(x))


def states(st_np):
    """The same CPTS state in both packages from a dict of arrays."""
    return (J.CptsState(**{k: j(v) for k, v in st_np.items()}),
            T.CptsState(**{k: t(v) for k, v in st_np.items()}))


def close_state(got, ref, what):
    for f in T.CPTS_FIELDS:
        close(getattr(got, f), getattr(ref, f), f"{what} {f}")


def _mk_state(ncat=3, nlay=4, jmt=6, imt=6, hi=20.0, a=0.5, hs=0.0,
              noise=0.0):
    """test_cpts.py's state (category 0 holding ice of thickness hi at
    area a, at -5 C), with seeded noise on every field when ``noise``."""
    rng = np.random.default_rng(RNG)
    A = np.zeros((ncat, jmt, imt))
    A[0] = a
    S = J.salinity_profile(nlay)
    q = np.asarray(J.energy_of_melt(jnp.full((nlay,), -5.0), j(S)))
    E = np.zeros((ncat, nlay, jmt, imt))
    E[0] = (q * hi * a / nlay)[:, None, None]
    Ts = np.full((ncat, jmt, imt), -10.0) * (A > 0)
    st = dict(A=A, heff=A * hi, hseff=A * hs, Ts=Ts, E=E,
              uice=np.zeros((2, jmt, imt)))
    if noise:
        u = lambda *s: 1.0 + noise * rng.uniform(-1, 1, s)
        A = np.clip(A * u(ncat, jmt, imt), 0.0, 1.0)
        A[1] = noise * rng.uniform(0, 0.3, (jmt, imt))
        hcat = np.array([hi, 120.0, 400.0])[:ncat, None, None] \
            * u(ncat, jmt, imt)
        st = dict(A=A, heff=A * hcat, hseff=A * hs * u(ncat, jmt, imt),
                  Ts=np.where(A > 0, -10.0 * u(ncat, jmt, imt), 0.0),
                  E=(q[None, :, None, None] * (A * hcat)[:, None] / nlay
                     * u(ncat, nlay, jmt, imt)),
                  uice=rng.normal(0.0, 5.0, (2, jmt, imt)))
    return st


def test_tables_match():
    for n in (1, 3, 5, 10):
        np.testing.assert_array_equal(T.HSTAR[n], J.HSTAR[n])
    for nlay in (1, 2, 4, 8):
        np.testing.assert_array_equal(T.salinity_profile(nlay),
                                      J.salinity_profile(nlay))
    for name in ("CPICE", "RCPICE", "RFLICE", "RFLSNO", "ALPHA", "GAMMA",
                 "KAPPAI", "KAPPAS", "KIMIN", "BETA_K", "SALNEW", "TINY",
                 "GSTAR", "CK", "M1_LAT", "M2_LAT"):
        assert getattr(T, name) == getattr(J, name), name
    st = T.init_cpts_state(5, 4, 6, 7, torch.float64)
    ref = J.init_cpts_state(5, 4, 6, 7, jnp.float64)
    close_state(st, ref, "init")
    assert st.E.shape == (5, 4, 6, 7)


def test_enthalpy_functions_match():
    rng = np.random.default_rng(RNG)
    S = J.salinity_profile(4)
    T_ = np.concatenate([np.linspace(-25.0, -0.5, 40),
                         rng.uniform(-60.0, 1.0, 40)])[:, None] \
        * np.ones((1, 4))
    q = J.energy_of_melt(j(T_), j(S))
    close(T.energy_of_melt(t(T_), t(S)), q, "energy_of_melt")
    close(T.temp_from_energy(t(q), t(S)), J.temp_from_energy(q, j(S)),
          "temp_from_energy")
    close(T._conductivity(t(T_), t(S)), J._conductivity(j(T_), j(S)),
          "conductivity")
    # the round trip of the reference's test holds in the port too
    np.testing.assert_allclose(
        T.temp_from_energy(T.energy_of_melt(t(T_[:40]), t(S)), t(S)),
        T_[:40], rtol=1e-10)


@pytest.mark.parametrize("nlay", [1, 4, 8])
def test_vertical_solve_matches(nlay):
    rng = np.random.default_rng(RNG + nlay)
    n = 64
    S = J.salinity_profile(nlay)
    Ti = -rng.uniform(0.5, 30.0, (n, nlay))
    Ts = -rng.uniform(0.0, 35.0, n)
    hi = rng.uniform(0.0, 400.0, n)
    hs = rng.uniform(0.0, 50.0, n)
    fnet0 = rng.normal(0.0, 5e4, n)
    dfnet = -rng.uniform(1e3, 5e3, n)
    io_pen = np.zeros(n)
    tbot = -1.8 + 0.05 * rng.standard_normal(n)
    has = hi > 20.0
    ref = J._vertical_solve(j(Ts), j(Ti), j(hi), j(hs), j(S), j(fnet0),
                            j(dfnet), j(io_pen), j(tbot), 43200.0, nlay,
                            j(has))
    got = T._vertical_solve(t(Ts), t(Ti), t(hi), t(hs), t(S), t(fnet0),
                            t(dfnet), t(io_pen), t(tbot), 43200.0, nlay,
                            torch.as_tensor(has))
    for name, a, b in zip(("Ts", "Ti", "fcond_top", "condb"), got, ref):
        close(a, b, name)


def test_surface_equilibrium_fixed_point_matches():
    """test_cpts.py's conductive equilibrium: the port's solve moves Ts
    as little as the reference's, and to the same place."""
    Ti = np.stack([np.full(3, -15.0), np.full(3, -10.0), np.full(3, -6.0),
                   np.full(3, -3.0)], axis=-1)
    saltz = J.salinity_profile(4)
    ki = np.asarray(J._conductivity(j(Ti), j(saltz)))
    k_top = 1.0 / (25.0 * 0.5 / ki[..., 0])
    F0 = k_top * (-20.0 - -15.0)
    args = (np.full(3, -20.0), Ti, np.full(3, 100.0), np.zeros(3), saltz,
            -F0, np.full(3, -3.0e3), np.zeros(3), np.full(3, -1.8))
    ref = J._vertical_solve(*map(j, args), 1.0, 4, jnp.ones(3, bool))
    got = T._vertical_solve(*map(t, args), 1.0, 4,
                            torch.ones(3, dtype=torch.bool))
    for a, b in zip(got, ref):
        close(a, b, "equilibrium")
    assert float((got[0] - t(args[0])).abs().max()) < 2.0


@pytest.mark.parametrize("top", [False, True])
def test_remap_layers_matches(top):
    rng = np.random.default_rng(RNG)
    nlay = 4
    q = -rng.uniform(2e9, 4e9, (5, nlay))
    hi = rng.uniform(50.0, 150.0, 5)
    dht = rng.uniform(0.0, 5.0, 5) * (1.0 if top else -1.0)
    dhb = rng.uniform(-5.0, 5.0, 5)
    qn = np.full(5, -2.5e9)
    kw = dict(q_new_top=-J.RFLICE) if top else {}
    ref = J._remap_layers(j(q), j(hi), j(dht), j(dhb), j(qn), nlay, **kw)
    got = T._remap_layers(t(q), t(hi), t(dht), t(dhb), t(qn), nlay, **kw)
    close(got[0], ref[0], "q")
    close(got[1], ref[1], "hi")


def _thermo(pkg, conv, st, tair, sst, dts=43200.0, nlay=4, tmsk=None):
    S = J.salinity_profile(nlay)
    jmt, imt = st.A.shape[1:]
    one = np.ones((jmt, imt))
    tm = one if tmsk is None else tmsk
    return pkg.cpts_thermo(
        st, conv(tair * one), conv(2e-3 * one), conv(sst * one),
        conv(-1.8 * one), solins=conv(300e3 * one), aca=conv(0.8 * one),
        wspd=conv(500.0 * one), tmsk=conv(tm), dts=dts, saltz=conv(S),
        hstar=J.HSTAR[3], dnswr_ow=conv(100e3 * one),
        uplwr_ow=conv(120e3 * one), upsens_ow=conv(20e3 * one),
        upltnt_ow=conv(30e3 * one), evap_ow=conv(1e-5 * one))


# (state, air temperature, SST, dts): the reference tests' scenarios
SCENARIOS = {
    "cold_growth": (dict(), -25.0, -1.8, 43200.0),
    "warm_melt": (dict(), 10.0, 2.0, 43200.0),
    "open_water_freezing": (dict(a=0.0, hi=0.0), -30.0, -1.8, 43200.0),
    "full_cover_congelation": (dict(a=1.0, hi=50.0), -30.0, -1.8, 43200.0),
    "flooding": (dict(a=1.0, hi=40.0, hs=30.0), -10.0, -1.8, 1.0),
    "mixed_noisy": (dict(hs=10.0, noise=0.2), -15.0, -1.0, 86400.0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cpts_thermo_matches(name):
    kw, tair, sst, dts = SCENARIOS[name]
    js, ts = states(_mk_state(**kw))
    tmsk = np.ones(js.A.shape[1:])
    tmsk[0, :] = 0.0                      # a land row
    ref = _thermo(J, j, js, tair, sst, dts, tmsk=tmsk)
    got = _thermo(T, t, ts, tair, sst, dts, tmsk=tmsk)
    close_state(got[0], ref[0], name)
    for part, (g_, r_) in (("flux", (got[1], ref[1])),
                           ("adj", (got[2], ref[2]))):
        assert set(g_) == set(r_)
        for k in r_:
            close(g_[k], r_[k], f"{name} {part} {k}")
    close(got[3], ref[3], f"{name} aice")


@pytest.mark.parametrize("hi", [20.0, 120.0, 400.0])
def test_rebin_matches(hi):
    js, ts = states(_mk_state(hi=hi, noise=0.3))
    close_state(T.rebin(ts, T.HSTAR[3]), J.rebin(js, J.HSTAR[3]),
                f"rebin {hi}")


@pytest.mark.parametrize("divu", [-1e-6, -1e-8, 1e-7])
def test_ridge_matches(divu):
    js, ts = states(_mk_state(hi=30.0, a=0.9, hs=5.0, noise=0.2))
    shape = js.A.shape[1:]
    rng = np.random.default_rng(RNG)
    d = divu * (1.0 + 0.5 * rng.uniform(-1, 1, shape))
    close_state(T.ridge(ts, t(d), 43200.0, T.HSTAR[3]),
                J.ridge(js, j(d), 43200.0, J.HSTAR[3]), f"ridge {divu}")


def test_aggregate_matches():
    js, ts = states(_mk_state(hs=8.0, noise=0.3))
    for a, b, name in zip(T.aggregate(ts), J.aggregate(js),
                          ("hice", "aice", "hsno", "tice")):
        close(a, b, name)


@pytest.mark.parametrize("niats", [1, 2])
def test_cpts_advect_matches(niats):
    """Upstream advection of every category and layer on the small
    grid's B-grid metrics, the categories batched in the port."""
    from uvic_tpu.config import small_config as j_small
    from uvic_tpu.models.ocean.model import make_ocean as j_make
    from uvic_tpu_torch.config import small_config
    from uvic_tpu_torch.models.ocean.model import make_ocean
    cfg = dict(dtype="float64")
    jo = j_make(j_small(**cfg))
    to = make_ocean(small_config(**cfg), device="cpu")
    jmt, imt = jo.params.grid.jmt, jo.params.grid.imt
    js, ts = states(_mk_state(jmt=jmt, imt=imt, hs=5.0, noise=0.3))
    rng = np.random.default_rng(RNG)
    uice, vice = rng.normal(0.0, 20.0, (2, jmt, imt))
    ref = J.cpts_advect(js, j(uice), j(vice), jo.g, 43200.0, niats)
    got = T.cpts_advect(ts, t(uice), t(vice), to.g, 43200.0, niats)
    close_state(got, ref, f"advect niats {niats}")
