"""Host-side constants for the ocean step (NumPy).

Everything the reference computes once in setmom.F / hmixc.F `first`
blocks (Coriolis factors, metric mixing factors, ...) is assembled here
on the host, as in ``uvic_tpu.models.ocean.params``; ``OceanModel``
turns it into device tensors once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ...config import ModelConfig
from ...constants import OMEGA, RADIAN, RADIUS
from ...core.grid import Grid, make_grid
from ...core.topog import Topography, idealized_kmt, make_topography
from ...ops.eos import EosCoefficients, fit_eos


@dataclass
class OceanParams:
    cfg: ModelConfig
    grid: Grid
    topo: Topography
    eos: EosCoefficients

    # derived (filled in __post_init__), all NumPy in model dtype
    cori: Any = field(init=False)        # (2, jmt, imt) coriolis per component
    advmet: Any = field(init=False)      # (2, jmt) metric advection factors
    amc_north: Any = field(init=False)   # (jmt,)
    amc_south: Any = field(init=False)
    ahc_north: Any = field(init=False)
    ahc_south: Any = field(init=False)
    am3: Any = field(init=False)         # (jmt,)
    am4: Any = field(init=False)         # (2, jmt)
    dtxcel: Any = field(init=False)      # (km,) tracer acceleration factors
    nt: int = field(init=False)

    def __post_init__(self):
        cfg, g, topo = self.cfg, self.grid, self.topo
        dt = cfg.np_dtype
        jmt, imt = g.jmt, g.imt

        # Coriolis at U points (setmom.F:756-758); unrotated grid
        f = 2.0 * OMEGA * np.sin(g.yu / RADIAN)
        fij = np.broadcast_to(f[:, None], (jmt, imt))
        self.cori = np.stack([fij, -fij]).astype(dt)

        # metric advection factors (setmom.F:780-782)
        am1 = g.tng / RADIUS
        self.advmet = np.stack([am1, -am1]).astype(dt)

        # metric diffusion factors (setmom.F:770-774)
        am = cfg.ocean.am
        self.am3 = (am * (1.0 - g.tng**2) / RADIUS**2).astype(dt)
        am4_1 = -am * 2.0 * g.sine / (RADIUS * g.csu**2)
        self.am4 = np.stack([am4_1, -am4_1]).astype(dt)

        # momentum meridional mixing factors (hmixc.F:57-66)
        jp1 = np.minimum(np.arange(jmt) + 1, jmt - 1)
        self.amc_north = (am * g.cst[jp1] * (1.0 / g.dyt[jp1])
                          * g.csur * g.dyur).astype(dt)
        self.amc_south = (am * g.cst / g.dyt * g.csur * g.dyur).astype(dt)

        # tracer meridional mixing factors (hmixc.F:96-106)
        jm1 = np.maximum(np.arange(jmt) - 1, 0)
        ah = cfg.ocean.ah
        self.ahc_north = (ah * g.csu * g.dyur * g.cstr * g.dytr).astype(dt)
        self.ahc_south = (ah * g.csu[jm1] * g.dyur[jm1]
                          * g.cstr * g.dytr).astype(dt)

        # depth-dependent tracer timestep acceleration (accel.h,
        # Bryan 1984 asynchronous stepping): 1 above dtxcel_z0, linear
        # ramp in depth to dtxcel_deep at the bottom level
        if cfg.ocean.dtxcel_deep > 1.0:
            zt = np.asarray(g.zt, np.float64)
            z0 = cfg.ocean.dtxcel_z0
            zb = zt[-1]
            frac = np.clip((zt - z0) / max(zb - z0, 1.0), 0.0, 1.0)
            self.dtxcel = (1.0 + (cfg.ocean.dtxcel_deep - 1.0)
                           * frac).astype(dt)
        else:
            self.dtxcel = np.ones(g.km, dtype=dt)

        # tracer registry (additive composition, size.h:28-50)
        from ...coupler.tracers import TracerIndex, build_registry
        self.tracer_index = TracerIndex(build_registry(cfg.bgc))
        self.nt = self.tracer_index.nt


def build_ocean_params(cfg: ModelConfig, kmt: np.ndarray | None = None,
                       topo_kind: str = "world") -> OceanParams:
    grid = make_grid(cfg.grid)
    if kmt is None:
        if topo_kind == "earth":
            # coarse real-Earth bathymetry authored in-repo
            # (core/earth.py; topog.F data path analog)
            from ...core.earth import earth_kmt
            kmt = earth_kmt(grid)
        else:
            kmt = idealized_kmt(grid, topo_kind)
    topo = make_topography(grid, kmt)
    eos = fit_eos(grid.zt)
    return OceanParams(cfg=cfg, grid=grid, topo=topo, eos=eos)
