"""Entry points of the PyTorch port (counterparts of
``__graft_entry__._flagship`` and ``_wind``).

``_flagship(small=False)`` builds the flagship ocean: the standard
3.6 x 1.8 deg, 19-level grid with the reference's configured physics
(isopycnal/GM mixing, FCT, full convection, tidal kv, geothermal heat,
Large-2001 anisotropic viscosity, GD13 equatorial zonal mixing), two
tracers, in float32, and primes the leapfrog levels with one forward
step.  ``mobi=True`` adds the full MOBI suite (``mobi_full()``, 41
tracers): the initial condition is the same 2-tracer one, extended to 41
by ``init_state`` with the registry's defaults.  ``small=True`` gives
the light 34x40x8 configuration of the JAX entry (isopycnal/GM mixing
off).  ``ocean`` and ``grid`` (dicts of ``OceanConfig`` / ``GridConfig``
fields) set options on top, as ``cfg.replace(ocean=...)`` does.

``_earth`` builds the coupled production configuration,
``CoupledModel(earth_config(), topo_kind="earth")`` (the model that
``scripts/run_production.py --earth`` runs), and with a restart loads it
and sets ``relyr`` from the ``restart_meta.json`` beside it, as that
script does.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .config import ModelConfig, earth_config, mobi_full, small_config
from .models.ocean.model import make_forcing, make_ocean


def _flagship(small=False, device=None, dtype="float32", mobi=False,
              ocean=None, grid=None, small_shape=(34, 40)):
    """(model, primed state, forcing) of the flagship configuration,
    with the options ``ocean`` and ``grid`` on top; ``small_shape`` is
    the small form's (jmt, imt)."""
    if small:
        cfg = small_config(imt=small_shape[1], jmt=small_shape[0], km=8)
        cfg = cfg.replace(dtype=dtype, ocean=dataclasses.replace(
            cfg.ocean, isopycmix=False, gent_mcwilliams=False))
    else:
        cfg = ModelConfig(dtype=dtype)
        cfg = cfg.replace(ocean=dataclasses.replace(
            cfg.ocean, isopycmix=True, gent_mcwilliams=True,
            tidal_kv=True, gthflx=True, aniso_visc=True,
            aniso_zonal=True))
    if mobi:
        cfg = cfg.replace(bgc=mobi_full())
    if ocean:
        cfg = cfg.replace(ocean=dataclasses.replace(cfg.ocean, **ocean))
    if grid:
        cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, **grid))
    m = make_ocean(cfg, device=device)
    g = m.params.grid
    t0 = np.zeros((2, g.km, g.jmt, g.imt))
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None]
    t0 *= np.asarray(m.params.topo.tmask)
    forcing = _wind(m)
    state = m.step(m.init_state(t0), forcing, leapfrog=False)
    return m, state, forcing


def _wind(m):
    """Idealized zonal wind stress sin(3 lat), no tracer fluxes."""
    g = m.params.grid
    yu = np.asarray(g.yu)
    taux = np.sin(np.deg2rad(yu * 3))[:, None] * np.ones((1, g.imt))
    smf = np.stack([taux / 1.035, np.zeros_like(taux)])
    stf = np.zeros((m.nt, g.jmt, g.imt))

    def tn(x):
        return torch.as_tensor(x, dtype=m.dtype, device=m.device)

    return make_forcing(tn(smf), tn(stf))


def _earth(restart=None, device=None, dtype="float32", cfg=None):
    """(model, state) of the coupled earth configuration (``cfg``, by
    default ``earth_config(dtype)``); from ``restart`` (an npz of
    ``io.restart``) when given, with the model's ``relyr`` from the
    ``restart_meta.json`` beside it."""
    from .coupler.driver import CoupledModel
    from .io.restart import load_restart
    model = CoupledModel(cfg or earth_config(dtype=dtype),
                         topo_kind="earth", device=device)
    state = model.init_state()
    if restart is not None:
        state = load_restart(restart, state)
        meta = os.path.join(os.path.dirname(restart), "restart_meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                relyr = json.load(f).get("relyr")
            if relyr is not None:
                model.relyr = relyr
    return model, state


def dryrun_multichip(n_devices: int, device=None,
                     backend: str = "gloo") -> None:
    """``__graft_entry__.dryrun_multichip`` on a ``(2, n/2)`` mesh
    (``(1, n)`` for odd or small n) of ``n_devices`` ranks (``device``
    each rank's, ``cuda`` unless asked otherwise: the card of its rank
    modulo the host's cards; ``backend`` gloo, or nccl with one card a
    rank):

    1. the small flagship, one rank-decomposed leapfrog step;
    2. one coupled segment (``ShardedCoupledModel``) of the reference's
       part-2 configuration (``dryrun_coupled_config``: ``small_config``
       in float32 with ``mobi_full()``, isopycnal mixing off), the ocean
       on the mesh and the atmosphere, ice and land replicated.

    No NaN in the ocean's ``t`` (and the atmosphere's ``at``).  The
    halo is derived from the configuration (``ShardedOceanStep.
    required_halo``) and the grid widened where a block could not hold
    it with the ghost columns (44 columns on a (2, 4) mesh; the 34 rows
    hold it on two bands).  Raises if a rank fails."""
    from .parallel.launch import spawn
    if n_devices % 2 == 0 and n_devices > 2:
        shape = (2, n_devices // 2)
    else:
        shape = (1, n_devices)
    spawn(_dryrun_rank, shape, backend, device, 600.0)


def _dryrun_rank(mesh):
    from .parallel.mesh import gather_pytree, shard_pytree
    from .parallel.shard_step import ShardedOceanStep
    m, state, forcing = _flagship(small=True, device=mesh.device)
    w = ShardedOceanStep.required_halo(m.cfg.ocean)
    imt = 40
    while not _holds_halo(imt, mesh.shape[1], w):
        imt += 1
    if imt != 40:
        m, state, forcing = _flagship(small=True, device=mesh.device,
                                      small_shape=(34, imt))
    ss = ShardedOceanStep(m, mesh)
    g = m.params.grid
    s = ss.step(shard_pytree(state, mesh, g.jmt, g.imt),
                shard_pytree(forcing, mesh, g.jmt, g.imt), leapfrog=True)
    out = gather_pytree(s, mesh, g.jmt, g.imt)
    for name in ("t", "u", "psi0"):
        if bool(torch.isnan(getattr(out, name)).any()):
            raise AssertionError(f"sharded step NaN in {name}")

    # 2) the coupled segment, rank-decomposed
    from .coupler.driver import CoupledModel
    from .parallel.shard_segment import ShardedCoupledModel
    cm = CoupledModel(dryrun_coupled_config(mesh.shape), device=mesh.device)
    sm = ShardedCoupledModel(cm, mesh)
    whole = sm.gather(sm.run_segment(sm.shard(cm.init_state())))
    for part, a in (("ocean t", whole.ocean.t), ("atm at", whole.atm.at)):
        if bool(torch.isnan(a).any()):
            raise AssertionError(f"sharded coupled segment NaN in {part}")


def dryrun_coupled_config(shape) -> ModelConfig:
    """Part 2's configuration (``__graft_entry__.py:137-152``):
    ``small_config`` (km 8) in float32 with ``mobi_full()``, isopycnal
    and GM mixing off, dtts 43,200 s, dtuv and dtsf 1,800 s, tolrsf 1e8,
    on (ny*ceil(34/ny), nx*ceil(40/nx)), widened in x where a block could
    not hold the sharded step's halo with the ghost columns."""
    ny, nx = shape
    jmt = ny * -(-34 // ny)
    imt = nx * -(-40 // nx)

    def cfg_of(imt):
        cfg = small_config(imt=imt, jmt=jmt, km=8)
        return cfg.replace(
            dtype="float32",
            ocean=dataclasses.replace(
                cfg.ocean, isopycmix=False, gent_mcwilliams=False,
                dtts=43200.0, dtuv=1800.0, dtsf=1800.0, tolrsf=1e8),
            bgc=mobi_full())
    from .parallel.shard_step import ShardedOceanStep
    w = ShardedOceanStep.required_halo(cfg_of(imt).ocean)
    while not _holds_halo(imt, nx, w):
        imt += nx
    return cfg_of(imt)


def _holds_halo(imt, nx, w):
    """Whether blocks of ``nx`` ranks on ``imt`` columns hold a halo of
    ``w`` with the window's ghost and image columns."""
    imt_p = -(-imt // nx) * nx
    return nx == 1 or imt_p // nx >= w + 2 + imt_p - imt
