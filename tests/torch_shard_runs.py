"""Both packages' ocean models stepped whole and rank-decomposed: the
helpers of ``tests/test_torch_shard_*.py``.

The set-up is ``tests/test_shardmap_step.py``'s ``_setup``:
``small_config(imt, jmt, km=8)`` with dtts 43,200 s, dtuv and dtsf
1,800 s, tolrsf 1 and mxscan 2,000; an exponential temperature profile,
zero salinity, a sin(3 lat) zonal wind stress, primed by one forward
step (of the port's model here), in float64 on the CPU.  The port's ranks start
from that primed state (``uvic_tpu_torch.parallel.shard_step.
run_sharded`` on gloo CPU ranks through ``launch.spawn``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from uvic_tpu.config import ModelConfig as JModelConfig
from uvic_tpu.config import mobi_full as j_mobi_full
from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

from uvic_tpu_torch.config import ModelConfig as TModelConfig
from uvic_tpu_torch.config import mobi_full as t_mobi_full
from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import (ocean_state_from_numpy,
                                    ocean_state_to_numpy)
from uvic_tpu_torch.models.ocean.model import make_forcing as t_make_forcing
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean
from uvic_tpu_torch.parallel.launch import spawn

from uvic_tpu_torch.parallel.shard_step import run_sharded

from torch_rank_fns import call_on_meshes

BASE = dict(dtts=43200.0, dtuv=1800.0, dtsf=1800.0, tolrsf=1e0,
            mxscan=2000)
# the flagship's physics (entry._flagship, __graft_entry__._flagship)
FLAGSHIP = dict(isopycmix=True, gent_mcwilliams=True, tidal_kv=True,
                gthflx=True, aniso_visc=True, aniso_zonal=True)
FIELDS = ("t", "tm1", "u", "um1", "psi0", "psi1", "ptd", "ptdb")
BAROTROPIC = ("psi0", "psi1", "ptd", "ptdb")
# the JAX tests' tolerances (test_shardmap_step.py:54-90)
TOL_JAX = dict(t=(1e-9, 1e-11), u=(1e-5, 3e-7))
PSI_OF_SCALE = 3e-5
# the port's sharded step against its own unsharded step: every field
# within 1e-12 of its largest magnitude (measured: 0 to 1e-15; the
# filters' and the CG's sums run on one BLAS thread in a rank)
TOL_PORT = 1e-12
SPAWN_S = 240.0


def configs(ocean, jmt=34, imt=40, km=8, flagship=False, mobi=False):
    """(JAX config, port config): small_config(imt, jmt, km) with BASE,
    or the standard grid with the flagship physics, options on top."""
    out = []
    for small, full, mobi_cfg in ((j_small_config, JModelConfig,
                                   j_mobi_full),
                                  (t_small_config, TModelConfig,
                                   t_mobi_full)):
        if flagship:
            cfg = full()
            opts = {**FLAGSHIP, **ocean}
        else:
            cfg = small(imt=imt, jmt=jmt, km=km)
            opts = {**BASE, **ocean}
        cfg = cfg.replace(ocean=dataclasses.replace(cfg.ocean, **opts))
        if mobi:
            cfg = cfg.replace(bgc=mobi_cfg())
        out.append(cfg)
    return out


def j_state_dict(s):
    d = {name: np.asarray(getattr(s, name)) for name in FIELDS}
    d.update(ubar=np.asarray(s.ubar), ubarm1=np.asarray(s.ubarm1),
             itt=np.asarray(s.itt), nconv=np.asarray(s.nconv))
    return d


def setup(jc, tc):
    """The JAX model, the primed state (NumPy) and the forcing (NumPy):
    the port's forward step from the exponential profile primes both
    packages' runs (one JAX compile fewer than priming with the JAX
    model; the two primings agree to round-off)."""
    jm = j_make_ocean(jc)
    forcing = wind(jm.params.grid, jm.nt)
    return jm, port_setup(tc, forcing), forcing


def j_forcing(forcing):
    return j_make_forcing(jnp.asarray(forcing["smf"]),
                          jnp.asarray(forcing["stf"]))


def jax_steps(jm, primed, forcing, schedule):
    """The JAX model's unsharded ``_step`` over ``schedule`` (its own
    jitted steps)."""
    from uvic_tpu.core.state import OceanState
    s = OceanState(**{k: jnp.asarray(v) for k, v in primed.items()})
    f = j_forcing(forcing)
    for lf in schedule:
        s = jm.step(s, f, leapfrog=lf)
    return j_state_dict(s)


def port_steps(tc, primed, forcing, schedule):
    """The port's unsharded ``step`` over ``schedule`` (``_step``; a
    mixing step of an ``eb`` model Euler-backward), on the tracer path
    the sharded core takes (the generic step, ``fused_tracer`` off)."""
    tm = t_make_ocean(tc, device="cpu")
    tm.fused_tracer = False
    s = ocean_state_from_numpy(primed, "cpu")
    f = t_forcing(forcing)
    for lf in schedule:
        s = tm.step(s, f, leapfrog=lf)
    return ocean_state_to_numpy(s)


def t_forcing(forcing):
    """The port's forcing of a dict of NumPy arrays (``relyr`` a float)."""
    return t_make_forcing(**{k: (v if k == "relyr" else torch.as_tensor(v))
                             for k, v in forcing.items()})


def port_setup(tc, forcing):
    """The port's state primed by one forward step from the exponential
    profile, in float64 on the CPU, as NumPy."""
    tm = t_make_ocean(tc, device="cpu")
    g = tm.params.grid
    t0 = np.zeros((2, g.km, g.jmt, g.imt))
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None]
    t0 *= np.asarray(tm.params.topo.tmask)
    s = tm.step(tm.init_state(t0), t_forcing(forcing), leapfrog=False)
    return ocean_state_to_numpy(s)


def wind(grid, nt):
    """The sin(3 lat) zonal wind stress and zero tracer fluxes."""
    yu = np.asarray(grid.yu)
    taux = np.sin(np.deg2rad(yu * 3))[:, None] * np.ones((1, grid.imt))
    return dict(smf=np.stack([taux / 1.035, np.zeros_like(taux)]),
                stf=np.zeros((nt, grid.jmt, grid.imt)))


def spawn_meshes(calls_by_shape):
    """``call_all`` calls on several meshes of gloo CPU ranks with one
    spawn, of the largest mesh's ranks (a smaller mesh takes the first
    of them): ``{shape: calls}`` -> ``{shape: [each of its ranks'
    results]}``."""
    shapes = list(calls_by_shape)
    world = max(shapes, key=lambda s: s[0] * s[1])
    res = spawn(call_on_meshes, world, "gloo", "cpu",
                SPAWN_S * len(shapes),
                [(s, calls_by_shape[s]) for s in shapes])
    return {s: [rank[i] for rank in res[:s[0] * s[1]]]
            for i, s in enumerate(shapes)}


def sharded_meshes(jobs_by_shape):
    """``run_sharded`` jobs on meshes of gloo CPU ranks, one spawn for
    them all: ``{shape: jobs}`` -> ``{shape: each job's rank-0 result}``,
    with ``ranks_barotropic`` and ``ranks_blocks`` every rank's
    replicated fields and blocks."""
    ranks = spawn_meshes({s: [(run_sharded, j) for j in jobs]
                          for s, jobs in jobs_by_shape.items()})
    out = {}
    for s, jobs in jobs_by_shape.items():
        res = ranks[s]
        out[s] = []
        for n in range(len(jobs)):
            r = dict(res[0][n])
            r["ranks_barotropic"] = [rank[n]["barotropic"] for rank in res]
            r["ranks_blocks"] = [rank[n]["blocks"] for rank in res]
            out[s].append(r)
    return out


def sharded(shape, jobs):
    """``sharded_meshes`` of one mesh: each job's result."""
    return sharded_meshes({shape: jobs})[shape]


def job(tc, primed, forcing, schedule, halo=None):
    return dict(cfg=tc, state=primed, forcing=forcing,
                schedule=list(schedule), halo=halo)


def rel_gap(got, ref):
    """Largest |got - ref| over the largest |ref|."""
    scale = float(np.abs(ref).max())
    return float(np.abs(got - ref).max()) / (scale if scale > 0 else 1.0)


def assert_jax_tolerances(got, ref, tol_u=TOL_JAX["u"]):
    """test_shardmap_step.py's contract: t at rtol 1e-9/atol 1e-11, psi
    within 3e-5 of its scale, u at rtol 1e-5/atol 3e-7."""
    np.testing.assert_allclose(got["t"], ref["t"], rtol=TOL_JAX["t"][0],
                               atol=TOL_JAX["t"][1])
    psi_scale = float(np.abs(ref["psi0"]).max())
    assert float(np.abs(got["psi0"] - ref["psi0"]).max()) \
        < PSI_OF_SCALE * psi_scale
    np.testing.assert_allclose(got["u"], ref["u"], rtol=tol_u[0],
                               atol=tol_u[1])


def assert_port_equal(got, ref):
    """The sharded step against the port's unsharded one: every field
    (the surface-pressure modes' ubar and ubarm1 too) within TOL_PORT of
    its scale, itt and nconv exactly."""
    for name in FIELDS + ("ubar", "ubarm1"):
        assert rel_gap(got[name], ref[name]) <= TOL_PORT, name
    assert int(got["itt"]) == int(ref["itt"])
    assert int(got["nconv"]) == int(ref["nconv"])


def assert_replicated(result):
    """Every rank's replicated fields (psi0, psi1, ptd and ptdb, and
    ubar and ubarm1) bitwise equal to rank 0's."""
    first = result["ranks_barotropic"][0]
    assert set(BAROTROPIC) <= set(first)
    for rank, fields in enumerate(result["ranks_barotropic"]):
        assert set(fields) == set(first), rank
        for name in first:
            assert np.array_equal(fields[name], first[name]), (rank, name)
