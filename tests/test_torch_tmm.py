"""The port's transport-matrix extraction (``uvic_tpu_torch.diag.tmm``)
and its centered tracer step against ``uvic_tpu``, on the CPU in float64.

The small ocean of ``tests/test_tmm.py`` (34x34x8, isopycnal mixing off,
dtts 3,600 s) after 10 steps of the reference model, the state carried
into the port.  Both packages' models take FCT for their own steps; the
extraction's sweep is the centered tracer step in both, whatever the
model's scheme.

- ``make_tiles``: bitwise equal;
- ``extract_matrices`` at the reference test's spacing (3, 4, 4), the
  tiles one tracer axis of one tracer step and the sheets one invtri
  call: Aexp and Aimp to 1e-9 of their largest magnitude, the tiles
  bitwise; with ``nsamples=2`` (a model step between the samples) too;
- ``tiles_to_sparse`` and ``sheets_to_sparse_vertical``: the same CSR
  structure, values to 1e-9;
- the reference test's two properties: A @ x equals the port's centered
  tracer step's tendency, and the implicit operator's rows sum to 1;
- the centered ``tracer_step`` with surface and bottom fluxes, a source,
  and the implicit vertical diffusion (aidif 0.5) to 1e-12; and the
  FCT, upstream and QUICKER schemes and the isopycnal and Smagorinsky
  branches to 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.diag import tmm as j_tmm
from uvic_tpu.models.ocean import kernels as j_kernels
from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import ocean_state_from_numpy
from uvic_tpu_torch.diag import tmm as t_tmm
from uvic_tpu_torch.models.ocean import kernels as t_kernels
from uvic_tpu_torch.models.ocean.model import make_forcing as t_make_forcing
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean
from uvic_tpu_torch.ops.stencil import setbcx

SPACING = (3, 4, 4)   # small grid: 32 physical columns, centered adv
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the steps are many small operations, which a
    thread pool slows down when other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, rtol=RTOL, label=""):
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, f"{label}: err {err:.3e} scale {scale:.3e}"


@pytest.fixture(scope="module")
def models():
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
    stf = np.zeros((jm.nt, g.jmt, g.imt))
    jf = j_make_forcing(jnp.asarray(smf), jnp.asarray(stf))
    tf = t_make_forcing(torch.as_tensor(smf), torch.as_tensor(stf))
    js = jm.run(jm.init_state(t0), jf, 10)
    d = {k: np.asarray(getattr(js, k)) for k in (
        "tm1", "t", "um1", "u", "psi0", "psi1", "ptd", "ptdb", "ubar",
        "ubarm1", "itt", "nconv")}
    ts = ocean_state_from_numpy(d, "cpu")
    ref = j_tmm.extract_matrices(jm, js, jf, spacing=SPACING)
    got = t_tmm.extract_matrices(tm, ts, tf, spacing=SPACING)
    return dict(jm=jm, tm=tm, js=js, d=d, ts=ts, jf=jf, tf=tf, ref=ref,
                got=got)


def test_make_tiles_matches_jax():
    for args, kw in (((8, 34, 34, SPACING), {}),
                     ((19, 20, 102, (3, 5, 5)), {}),
                     ((4, 9, 11, (2, 3, 3)), dict(cyclic=False))):
        np.testing.assert_array_equal(t_tmm.make_tiles(*args, **kw),
                                      j_tmm.make_tiles(*args, **kw))
    with pytest.raises(ValueError):
        t_tmm.make_tiles(8, 34, 34, (3, 5, 5))


def test_extract_matrices_matches_jax(models):
    (raexp, raimp, rtiles), (aexp, aimp, tiles) = models["ref"], \
        models["got"]
    assert aexp.shape == raexp.shape == (48,) + rtiles.shape[1:]
    assert aimp.shape == raimp.shape
    np.testing.assert_array_equal(tiles, rtiles)
    _close(aexp, raexp, label="Aexp")
    _close(aimp, raimp, label="Aimp")


def test_extract_matrices_over_two_samples_matches_jax(models):
    # the reference's model step donates its state: give it a copy
    js = jax.tree_util.tree_map(jnp.array, models["js"])
    ref = j_tmm.extract_matrices(models["jm"], js, models["jf"],
                                 spacing=SPACING, nsamples=2)
    got = t_tmm.extract_matrices(models["tm"], models["ts"], models["tf"],
                                 spacing=SPACING, nsamples=2)
    _close(got[0], ref[0], label="Aexp")
    _close(got[1], ref[1], label="Aimp")
    assert np.abs(got[0] - models["got"][0]).max() > 0.0


def test_sparse_matrices_match_jax(models):
    (raexp, raimp, rtiles), (aexp, aimp, tiles) = models["ref"], \
        models["got"]
    tmask = models["tm"].tmask.numpy()
    for ref, got in ((j_tmm.tiles_to_sparse(raexp, rtiles, tmask, SPACING),
                      t_tmm.tiles_to_sparse(aexp, tiles, tmask, SPACING)),
                     (j_tmm.sheets_to_sparse_vertical(raimp, tmask),
                      t_tmm.sheets_to_sparse_vertical(aimp, tmask))):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
        _close(got.data, ref.data, label="CSR")


def test_matrix_reproduces_the_centered_step(models):
    """tests/test_tmm.py's property on the port: A @ x is the tracer
    step's tendency on an arbitrary field."""
    tm, ts = models["tm"], models["ts"]
    aexp, aimp, tiles = models["got"]
    tmask = tm.tmask.numpy()
    A = t_tmm.tiles_to_sparse(aexp, tiles, tmask, spacing=SPACING)
    wetp = tmask > 0
    wetp[..., 0] = wetp[..., -1] = False
    assert A.shape == (int(wetp.sum()),) * 2
    rng = np.random.default_rng(3)
    x3 = setbcx(torch.as_tensor(rng.normal(size=tmask.shape) * tmask),
                True)
    u_tau = tm.full_velocity(ts.u, ts.psi0)
    vet, vnt, vbt, *_ = t_kernels.adv_vel(u_tau[0], u_tau[1], tm.g,
                                          tm.cyclic)
    g = tm.params.grid
    zs = torch.zeros((1, g.jmt, g.imt), dtype=torch.float64)
    c2dtts = 2 * tm.cfg.ocean.dtts
    out = t_kernels.tracer_step(x3[None], x3[None], vet, vnt, vbt, zs, zs,
                                None, tm.diff_cbt, tm.kmt, tm.tmask, tm.g,
                                c2dtts, "centered", 0.0, tm.cyclic)
    tend = (out[0] - x3).numpy() / c2dtts
    got = np.zeros_like(tend)
    got[wetp] = A @ x3.numpy()[wetp]
    assert np.abs(got - tend)[wetp].max() < 1e-8 * np.abs(tend).max()

    Ai = t_tmm.sheets_to_sparse_vertical(aimp, tmask)
    rs = np.asarray(Ai.sum(axis=1)).ravel()
    assert np.abs(rs - 1.0).max() < 1e-8


def test_centered_tracer_step_matches_jax(models):
    jm, tm = models["jm"], models["tm"]
    g = jm.params.grid
    rng = np.random.default_rng(5)
    nt, shape = 3, (g.km, g.jmt, g.imt)
    tmask = np.asarray(jm.tmask)
    t_tau = (rng.normal(size=(nt,) + shape) + 10.0) * tmask
    t_tm1 = t_tau + 0.1 * rng.normal(size=(nt,) + shape) * tmask
    stf, btf = 1e-4 * rng.normal(size=(2, nt, g.jmt, g.imt))
    source = 1e-6 * rng.normal(size=(nt,) + shape)
    d = models["d"]
    u = np.asarray(jm.full_velocity(jnp.asarray(d["u"]),
                                    jnp.asarray(d["psi0"])))
    jv = j_kernels.adv_vel(jnp.asarray(u[0]), jnp.asarray(u[1]), jm.g,
                           jm.cyclic)[:3]
    tv = t_kernels.adv_vel(torch.tensor(u[0]), torch.tensor(u[1]),
                           tm.g, tm.cyclic)[:3]
    for src in (None, source):
        for aidif in (0.0, 0.5):
            ref = j_kernels.tracer_step(
                jnp.asarray(t_tau), jnp.asarray(t_tm1), *jv,
                jnp.asarray(stf), jnp.asarray(btf),
                None if src is None else jnp.asarray(src), jm.diff_cbt,
                jm.kmt, jm.tmask, jm.g, 7200.0, "centered", aidif,
                jm.cyclic)
            got = t_kernels.tracer_step(
                torch.as_tensor(t_tau), torch.as_tensor(t_tm1), *tv,
                torch.as_tensor(stf), torch.as_tensor(btf),
                None if src is None else torch.as_tensor(src), tm.diff_cbt,
                tm.kmt, tm.tmask, tm.g, 7200.0, "centered", aidif,
                tm.cyclic)
            _close(got.numpy(), np.asarray(ref), rtol=1e-12,
                   label=f"source {src is not None}, aidif {aidif}")
    # the other schemes and the isopycnal and Smagorinsky branches (the
    # ocean options), each against the reference's tracer_step
    from uvic_tpu.models.ocean import hmix as j_hmix
    from uvic_tpu.models.ocean import isopyc as j_isopyc
    from uvic_tpu.ops.advection import quicker_coefficients
    from uvic_tpu_torch.models.ocean import hmix as t_hmix
    from uvic_tpu_torch.models.ocean import isopyc as t_isopyc
    qc = quicker_coefficients(g)
    jm.g.quicker = {ax: {k: jnp.asarray(v) for k, v in d.items()}
                    for ax, d in qc.items()}
    tm.g.quicker = {ax: {k: torch.as_tensor(v) for k, v in d.items()}
                    for ax, d in qc.items()}
    ju = jnp.asarray(u)
    tu = torch.tensor(u)
    j_iso = j_isopyc.compute_isopyc(jnp.asarray(t_tm1), jm.tmask, jm.kmt,
                                    jm.eos_c, jm.eos_to, jm.eos_so, jm.g,
                                    jm.cfg.ocean, jm.cyclic)
    t_iso = t_isopyc.compute_isopyc(torch.as_tensor(t_tm1), tm.tmask,
                                    tm.kmt, tm.eos_c, tm.eos_to, tm.eos_so,
                                    tm.g, tm.cfg.ocean, tm.cyclic)
    rj = j_hmix.smagnl_coefficients(ju, jm.g, jm.cyclic)
    rt = t_hmix.smagnl_coefficients(tu, tm.g, tm.cyclic)
    j_smag = ("smagnl",) + j_hmix.smag_tracer_coefficients(rj[1], rj[2])
    t_smag = ("smagnl",) + t_hmix.smag_tracer_coefficients(rt[1], rt[2])
    for scheme, jkw, tkw in (("fct", {}, {}), ("upstream", {}, {}),
                             ("quicker", {}, {}),
                             ("centered", dict(iso=j_iso),
                              dict(iso=t_iso)),
                             ("centered", dict(hmix=j_smag),
                              dict(hmix=t_smag))):
        ref = j_kernels.tracer_step(
            jnp.asarray(t_tau), jnp.asarray(t_tm1), *jv, jnp.asarray(stf),
            jnp.asarray(btf), None, jm.diff_cbt, jm.kmt, jm.tmask, jm.g,
            7200.0, scheme, 0.5, jm.cyclic, **jkw)
        got = t_kernels.tracer_step(
            torch.as_tensor(t_tau), torch.as_tensor(t_tm1), *tv,
            torch.as_tensor(stf), torch.as_tensor(btf), None, tm.diff_cbt,
            tm.kmt, tm.tmask, tm.g, 7200.0, scheme, 0.5, tm.cyclic, **tkw)
        _close(got.numpy(), np.asarray(ref), rtol=1e-12,
               label=f"{scheme} {sorted(jkw)}")
