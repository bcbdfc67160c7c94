"""The port's flagship ocean step against ``uvic_tpu`` on a small grid.

The flagship physics (isopycnal/GM mixing, FCT dlm1, full convection,
tidal kv, geothermal heat, anisotropic viscosity, equatorial zonal
mixing, island-constrained streamfunction CG, FIR filters) on a
34x40x8 grid in float64: a forward priming step and 5 leapfrog steps in
both packages agree to rtol 1e-9 of each field's largest magnitude.  On
the CPU the JAX model takes its XLA paths (tracer_step, congrad,
convct_full), which its own tests hold equal to the Pallas kernels; the
port takes its kernels' plain versions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import (ocean_state_from_numpy,
                                    ocean_state_to_numpy)
from uvic_tpu_torch.models.ocean.model import make_forcing as t_make_forcing
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean

FLAGSHIP = dict(isopycmix=True, gent_mcwilliams=True, tidal_kv=True,
                gthflx=True, aniso_visc=True, aniso_zonal=True)
FIELDS = ("t", "tm1", "u", "um1", "psi0", "psi1", "ptd", "ptdb")
N_LEAPFROG = 5


def _j_state_dict(s):
    d = {name: np.asarray(getattr(s, name)) for name in FIELDS}
    d.update(ubar=np.asarray(s.ubar), ubarm1=np.asarray(s.ubarm1),
             itt=np.asarray(s.itt), nconv=np.asarray(s.nconv))
    return d


@pytest.fixture(scope="module")
def runs():
    jc = j_small_config(imt=40, jmt=34, km=8)
    tc = t_small_config(imt=40, jmt=34, km=8)
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **FLAGSHIP))
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **FLAGSHIP))
    jm, tm = j_make_ocean(jc), t_make_ocean(tc, device="cpu")
    g = jm.params.grid
    rng = np.random.default_rng(0)
    shape = (g.km, g.jmt, g.imt)
    t0 = np.zeros((2,) + shape)
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None] \
        + 0.5 * rng.standard_normal(shape)
    t0[1] = 1e-4 * rng.standard_normal(shape)
    t0 *= np.asarray(jm.params.topo.tmask)
    taux = np.sin(np.deg2rad(np.asarray(g.yu) * 3))[:, None] \
        * np.ones((1, g.imt))
    smf = np.stack([taux / 1.035, np.zeros_like(taux)])
    stf = np.zeros((2, g.jmt, g.imt))
    stf[0] = 1e-4 * rng.standard_normal((g.jmt, g.imt))
    jf = j_make_forcing(jnp.asarray(smf), jnp.asarray(stf))
    tf = t_make_forcing(torch.as_tensor(smf), torch.as_tensor(stf))

    js = jm.step(jm.init_state(t0), jf, leapfrog=False)
    ts = tm.step(tm.init_state(t0), tf, leapfrog=False)
    j_hist, t_hist = [_j_state_dict(js)], [ts]
    for _ in range(N_LEAPFROG):
        js = jm.step(js, jf, leapfrog=True)
        ts = tm.step(ts, tf, leapfrog=True)
        j_hist.append(_j_state_dict(js))
        t_hist.append(ts)
    return dict(tm=tm, tf=tf, j_hist=j_hist, t_hist=t_hist)


def test_flagship_steps_match_jax(runs):
    for n, (jd, ts) in enumerate(zip(runs["j_hist"], runs["t_hist"])):
        td = ocean_state_to_numpy(ts)
        for name in FIELDS:
            ref, got = jd[name], td[name]
            scale = np.abs(ref).max()
            err = np.abs(got - ref).max()
            assert err <= 1e-9 * scale, \
                f"step {n} {name}: err {err:.3e} vs scale {scale:.3e}"
        assert int(td["itt"]) == int(jd["itt"]) == n + 1
        assert int(td["nconv"]) == int(jd["nconv"])
    final = runs["t_hist"][-1]
    assert bool(torch.isfinite(final.t).all())
    assert float(final.psi0.abs().max()) > 0.0


def test_state_carried_across_is_bitwise(runs):
    """A state taken out of the port as NumPy and back continues
    bitwise; a JAX state carried into the port continues like the JAX
    run."""
    tm, tf, t_hist, j_hist = (runs["tm"], runs["tf"], runs["t_hist"],
                              runs["j_hist"])
    mid = 2
    s = ocean_state_from_numpy(ocean_state_to_numpy(t_hist[mid]), "cpu")
    for _ in range(N_LEAPFROG - mid):
        s = tm.step(s, tf, leapfrog=True)
    d, ref = ocean_state_to_numpy(s), ocean_state_to_numpy(t_hist[-1])
    for name in FIELDS:
        np.testing.assert_array_equal(d[name], ref[name], err_msg=name)

    s = ocean_state_from_numpy(j_hist[mid], "cpu")
    for _ in range(N_LEAPFROG - mid):
        s = tm.step(s, tf, leapfrog=True)
    d = ocean_state_to_numpy(s)
    for name in FIELDS:
        ref = j_hist[-1][name]
        assert np.abs(d[name] - ref).max() <= 1e-9 * np.abs(ref).max(), name


def test_small_flagship_entry_runs_on_the_cpu():
    from uvic_tpu_torch.entry import _flagship
    m, state, forcing = _flagship(small=True, device="cpu",
                                  dtype="float64")
    state = m.run(state, forcing, 3)
    assert state.itt == 4
    for name in ("t", "u", "psi0"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name
    assert float(state.psi0.abs().max()) > 0.0


@pytest.mark.parametrize("option", [dict(hmix="smagnl"),
                                    dict(convection="ncon"),
                                    dict(hlat_filter="fourier")])
def test_options_step_like_jax(option):
    """Options off the flagship path (``tests/torch_option_runs.py``):
    3 steps from itt 0, a mixing step first, agree with the reference to
    1e-9 (``test_torch_ocean_options*.py`` take every option)."""
    from torch_option_runs import assert_close, step_both
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        hist = step_both(option, nsteps=3)
    finally:
        torch.set_num_threads(threads)
    for n, (ref, got) in enumerate(hist):
        assert_close(ref, got, f"{option} step {n}")
