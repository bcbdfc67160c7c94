"""Staggered B-grid construction and metric factors.

Grid module of the PyTorch port (reference: source/common/grids.F).
The reference reads the standard grid from a data file (`G_grid.nc`,
grids.F:64-98) that is not shipped with the repository; grids are therefore
*generated* here with the same cosine-stretch cell construction algorithm
the reference uses to build grids (`gcell`, grids.F:233-377), and all
derived metric factors follow grids.F:440-550.

Everything here is one-time host-side NumPy; the resulting arrays are
turned into device tensors once, by the ocean model.

Conventions (identical to the reference, 0-based):
- horizontal index ``i`` (longitude, fastest-varying / lane dimension),
  ``j`` (latitude), ``k`` (depth, k=0 at surface).
- cells ``i=0`` and ``i=imt-1`` are boundary cells; with a cyclic domain
  column 0 mirrors column imt-2 and column imt-1 mirrors column 1
  (util.F:789-815 ``setbcx``).
- rows ``j=0`` and ``j=jmt-1`` are solid boundary rows.
- U cell (i,j) sits at the north-east corner of T cell (i,j).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import GridConfig
from ..constants import DEG_TO_CM, RADIAN


def gcell(bounds, d_bounds, nbpts: int, stretch: float = 1.0):
    """Build cell widths over a multi-region domain (grids.F:233-377).

    Within each region [bounds[l], bounds[l+1]] the dual-grid ("u") cell
    widths vary smoothly from d_bounds[l] to d_bounds[l+1] following a
    half-cosine, which guarantees an integral number of cells per region;
    primal ("t") widths are the two-cell average of dual widths so tracer
    advection stays second-order accurate on the stretched grid.

    Returns (deltat, deltau) as float64 arrays. ``nbpts`` != 0 appends one
    boundary cell at each end (used for the horizontal directions).
    """
    bounds = np.asarray(bounds, dtype=np.float64)
    d_bounds = np.asarray(d_bounds, dtype=np.float64)
    deltau = []
    nreg = len(bounds) - 1
    for l in range(nreg):
        last = l == nreg - 1
        d_hi = d_bounds[l + 1] * (stretch if last else 1.0)
        avg_res = 0.5 * (d_bounds[l] + d_hi)
        chg_res = d_hi - d_bounds[l]
        tol = 1.0e-5
        wid = abs(bounds[l + 1] - bounds[l])
        m = max(1, int(round(wid / avg_res)))
        acc = 0.5 * d_bounds[l] - 0.5 * d_bounds[l + 1]
        for i in range(1, 100000):
            delta = avg_res - 0.5 * chg_res * np.cos((np.pi / m) * i)
            if acc + delta <= wid * (1.0 + tol):
                acc += delta
                deltau.append(delta)
            else:
                break
    deltau = np.asarray(deltau)
    num = len(deltau)
    deltat = np.empty(num)
    deltat[0] = 0.5 * (d_bounds[0] + deltau[0])
    deltat[1:] = 0.5 * (deltau[1:] + deltau[:-1])
    if nbpts:
        deltat = np.concatenate([[deltat[0]], deltat, [deltat[-1]]])
        deltau = np.concatenate([[d_bounds[0]], deltau, [deltau[-1]]])
    return deltat, deltau


@dataclass(frozen=True)
class Grid:
    """All grid coordinates and metric factors (NumPy, float64).

    Field names match the reference COMMON blocks (coord.h / grdvar.h) so
    the numerics modules read like the finite-difference spec in
    fdift.h/fdifm.h.
    """
    imt: int
    jmt: int
    km: int
    cyclic: bool

    # coordinates [degrees / cm]
    xt: np.ndarray
    xu: np.ndarray
    yt: np.ndarray
    yu: np.ndarray
    zt: np.ndarray          # depth of T points [cm]
    zw: np.ndarray          # depth of bottom of T cells [cm]

    # cell widths [cm]
    dxt: np.ndarray
    dxu: np.ndarray
    dyt: np.ndarray
    dyu: np.ndarray
    dzt: np.ndarray
    dzw: np.ndarray         # (km+1,) distances between T points, dzw[0]=zt[0]

    # trig factors
    cst: np.ndarray         # cos at T rows
    csu: np.ndarray         # cos at U rows
    sine: np.ndarray        # sin at U rows
    tng: np.ndarray         # tan at U rows
    phi: np.ndarray         # latitude of U rows [rad]
    phit: np.ndarray        # latitude of T rows [rad]

    # sub-cell distances [cm] (grids.F:531-550)
    duw: np.ndarray
    due: np.ndarray
    dus: np.ndarray
    dun: np.ndarray
    dxmetr: np.ndarray      # 1/(dxt[i]+dxt[i+1])

    @property
    def shape3d(self):
        return (self.km, self.jmt, self.imt)

    @property
    def shape2d(self):
        return (self.jmt, self.imt)

    # reciprocals are trivially derived; keep them as cached properties so
    # the numerics reads like the reference (grdvar.h names)
    def __getattr__(self, name):
        base = {
            "dxtr": ("dxt", 1.0), "dxt2r": ("dxt", 0.5), "dxt4r": ("dxt", 0.25),
            "dxur": ("dxu", 1.0), "dxu2r": ("dxu", 0.5), "dxu4r": ("dxu", 0.25),
            "dytr": ("dyt", 1.0), "dyt2r": ("dyt", 0.5), "dyt4r": ("dyt", 0.25),
            "dyur": ("dyu", 1.0), "dyu2r": ("dyu", 0.5), "dyu4r": ("dyu", 0.25),
            "dztr": ("dzt", 1.0), "dzt2r": ("dzt", 0.5),
            "cstr": ("cst", 1.0), "csur": ("csu", 1.0),
        }
        if name in base:
            src, fac = base[name]
            val = fac / object.__getattribute__(self, src)
            object.__setattr__(self, name, val)
            return val
        if name == "dzwr":
            val = 1.0 / self.dzw
            object.__setattr__(self, name, val)
            return val
        if name == "dztur":   # 1/(dzw[k-1]*dzt[k]) (grids.F:475)
            val = 1.0 / (self.dzw[:-1] * self.dzt)
            object.__setattr__(self, name, val)
            return val
        if name == "dztlr":   # 1/(dzw[k]*dzt[k]) (grids.F:476)
            val = 1.0 / (self.dzw[1:] * self.dzt)
            object.__setattr__(self, name, val)
            return val
        if name == "cstdytr":
            val = 1.0 / (self.cst * self.dyt)
            object.__setattr__(self, name, val)
            return val
        if name == "cstdyt2r":
            val = 0.5 / (self.cst * self.dyt)
            object.__setattr__(self, name, val)
            return val
        if name == "csudyur":
            val = 1.0 / (self.csu * self.dyu)
            object.__setattr__(self, name, val)
            return val
        if name == "csudyu2r":
            val = 0.5 / (self.csu * self.dyu)
            object.__setattr__(self, name, val)
            return val
        if name == "cst_dytr":
            val = self.cst / self.dyt
            object.__setattr__(self, name, val)
            return val
        if name == "csu_dyur":
            val = self.csu / self.dyu
            object.__setattr__(self, name, val)
            return val
        if name == "cstdxtr":   # 2-D (j,i): 1/(cst[j]*dxt[i])
            val = 1.0 / (self.cst[:, None] * self.dxt[None, :])
            object.__setattr__(self, name, val)
            return val
        if name == "cstdxt2r":
            val = 0.5 / (self.cst[:, None] * self.dxt[None, :])
            object.__setattr__(self, name, val)
            return val
        if name == "cstdxur":   # 1/(cst[j]*dxu[i])
            val = 1.0 / (self.cst[:, None] * self.dxu[None, :])
            object.__setattr__(self, name, val)
            return val
        if name == "csudxur":
            val = 1.0 / (self.csu[:, None] * self.dxu[None, :])
            object.__setattr__(self, name, val)
            return val
        if name == "csudxu2r":
            val = 0.5 / (self.csu[:, None] * self.dxu[None, :])
            object.__setattr__(self, name, val)
            return val
        raise AttributeError(name)


def make_grid(cfg: GridConfig) -> Grid:
    """Generate the grid from a GridConfig (grids.F `grids` equivalent)."""
    dxtdeg, dxudeg = gcell(cfg.x_bounds, cfg.x_res, nbpts=1)
    dytdeg, dyudeg = gcell(cfg.y_bounds, cfg.y_res, nbpts=1)
    dzt, _ = gcell(cfg.z_bounds, cfg.z_res, nbpts=0, stretch=cfg.z_stretch)

    if len(dxtdeg) != cfg.imt or len(dytdeg) != cfg.jmt or len(dzt) != cfg.km:
        raise ValueError(
            f"generated grid ({len(dxtdeg)},{len(dytdeg)},{len(dzt)}) does not "
            f"match configured (imt,jmt,km)=({cfg.imt},{cfg.jmt},{cfg.km}); "
            "adjust bounds/resolution")

    imt, jmt, km = cfg.imt, cfg.jmt, cfg.km

    # coordinates: U point (i) at the east edge of T cell (i+1) [0-based].
    # T cell i spans [xu[i-1], xu[i]] => xu increments by dxt; U cell i spans
    # [xt[i], xt[i+1]] => xt increments by dxu. Anchor: xu[0] = western
    # domain edge (the first T/U cells are boundary cells, grids.F:165-176).
    def coords(bound0, dt, du):
        n = len(dt)
        u = np.empty(n)
        u[0] = bound0
        u[1:] = bound0 + np.cumsum(dt[1:])
        t = np.empty(n)
        t[0] = u[0] - 0.5 * du[0]
        t[1:] = t[0] + np.cumsum(du[:-1])
        return t, u

    xt, xu = coords(cfg.x_bounds[0], dxtdeg, dxudeg)
    yt, yu = coords(cfg.y_bounds[0], dytdeg, dyudeg)

    # vertical: T points centered in cells
    zw = np.cumsum(dzt)
    zt = zw - 0.5 * dzt
    dzw = np.empty(km + 1)
    dzw[0] = zt[0]
    dzw[1:km] = zt[1:] - zt[:-1]
    dzw[km] = zw[-1] - zt[-1]

    # widths in cm; cyclic duplicate columns (grids.F:449-454)
    dxt = dxtdeg * DEG_TO_CM
    dxu = dxudeg * DEG_TO_CM
    if cfg.cyclic:
        dxt[0], dxt[-1] = dxt[imt - 2], dxt[1]
        dxu[0], dxu[-1] = dxu[imt - 2], dxu[1]
    dyt = dytdeg * DEG_TO_CM
    dyu = dyudeg * DEG_TO_CM

    # trig factors; clamp cos at the poles (grids.F:481-505)
    tiny = 1.0e-20
    phi = yu / RADIAN
    phit = yt / RADIAN
    cst = np.cos(phit)
    csu = np.cos(phi)
    cst = np.where(np.abs(cst) < tiny, tiny, cst)
    csu = np.where(np.abs(csu) < tiny, tiny, csu)
    sine = np.sin(phi)
    tng = sine / csu

    # sub-cell distances (grids.F:531-550)
    duw = (xu - xt) * DEG_TO_CM
    due = np.empty(imt)
    due[:-1] = (xt[1:] - xu[:-1]) * DEG_TO_CM
    due[-1] = due[1] if cfg.cyclic else due[-2]
    dus = (yu - yt) * DEG_TO_CM
    dun = np.empty(jmt)
    dun[:-1] = (yt[1:] - yu[:-1]) * DEG_TO_CM
    dun[-1] = dun[-2]
    dxmetr = np.zeros(imt)
    dxmetr[1:-1] = 1.0 / (dxt[1:-1] + dxt[2:])

    return Grid(
        imt=imt, jmt=jmt, km=km, cyclic=cfg.cyclic,
        xt=xt, xu=xu, yt=yt, yu=yu, zt=zt, zw=zw,
        dxt=dxt, dxu=dxu, dyt=dyt, dyu=dyu, dzt=dzt, dzw=dzw,
        cst=cst, csu=csu, sine=sine, tng=tng, phi=phi, phit=phit,
        duw=duw, due=due, dus=dus, dun=dun, dxmetr=dxmetr,
    )
