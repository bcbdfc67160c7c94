"""Both packages' small ocean models with options on top, stepped from
one state: the helpers of ``tests/test_torch_ocean_options*.py``.

The set-up is ``tests/test_variants.py``'s ``_setup``: ``small_config()``
(34x34x8) with isopycnal/GM mixing off, dtts 3,600 s, dtuv and dtsf
900 s, tolrsf 1e8; an exponential temperature profile, zero salinity and
a sin(3 lat) zonal wind stress, in float64 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.models.ocean.model import make_forcing as j_make_forcing
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import ocean_state_to_numpy
from uvic_tpu_torch.models.ocean.model import make_forcing as t_make_forcing
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean

BASE = dict(isopycmix=False, gent_mcwilliams=False, dtts=3600.0,
            dtuv=900.0, dtsf=900.0, tolrsf=1e8)
FIELDS = ("t", "u", "psi0", "psi1", "ptd", "ubar")
TOL = 1e-9
# The surface-pressure modes' solves run to convergence in both
# packages: at the reference test's tolerances (1e-6) the two CGs,
# equal up to the order of their sums, stop on steps that differ by
# round-off on an operator with a null space, so the fields agree only
# to about the solver's tolerance.
SP_CONVERGED = dict(mxscan=2000, tolrsp=1e-12, tolrfs=1e-12)


def configs(ocean, grid=None):
    """(JAX config, port config) of small_config with BASE and the
    options on top."""
    out = []
    for small in (j_small_config, t_small_config):
        cfg = small()
        cfg = cfg.replace(ocean=dataclasses.replace(cfg.ocean,
                                                    **{**BASE, **ocean}))
        if grid:
            cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, **grid))
        out.append(cfg)
    return out


def setup(ocean, grid=None):
    """Both models, their initial states and forcings."""
    jc, tc = configs(ocean, grid)
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
    return jm, tm, jm.init_state(t0), tm.init_state(t0), jf, tf


def j_numpy(s):
    d = {f: np.asarray(getattr(s, f)) for f in FIELDS}
    d.update(itt=int(s.itt), nconv=int(s.nconv))
    return d


def t_numpy(s):
    d = ocean_state_to_numpy(s)
    return {**{f: d[f] for f in FIELDS}, "itt": int(d["itt"]),
            "nconv": int(d["nconv"])}


def step_both(ocean, grid=None, nsteps=4):
    """``nsteps`` steps of both models through ``step`` with the mixing
    cadence of ``run`` (the first, from itt 0, a mixing step): the
    states after each step, as NumPy dicts."""
    jm, tm, js, ts, jf, tf = setup(ocean, grid)
    nmix = jm.cfg.ocean.nmix
    hist = []
    for _ in range(nsteps):
        lf = (int(js.itt) % nmix) != 0
        js = jm.step(js, jf, leapfrog=lf)
        ts = tm.step(ts, tf, leapfrog=lf)
        hist.append((j_numpy(js), t_numpy(ts)))
    return hist


def scan_both(ocean, grid=None, nsteps=4):
    """The end states of both packages' ``run_scan`` over ``nsteps``
    steps from itt 0."""
    jm, tm, js, ts, jf, tf = setup(ocean, grid)
    js = jm.run_scan(jax.tree_util.tree_map(jnp.array, js), jf, nsteps)
    return j_numpy(js), t_numpy(tm.run_scan(ts, tf, nsteps))


def assert_close(ref, got, label, tol=TOL):
    """Every field within tol of its largest magnitude, the counters
    equal."""
    for f in FIELDS:
        scale = max(float(np.abs(ref[f]).max()), 1e-300)
        err = float(np.abs(got[f] - ref[f]).max())
        assert err <= tol * scale, \
            f"{label} {f}: err {err:.3e}, scale {scale:.3e}"
    assert got["itt"] == ref["itt"], label
    assert got["nconv"] == ref["nconv"], label
