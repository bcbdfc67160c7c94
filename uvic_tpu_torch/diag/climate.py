"""Climate indicators of the earth model: the quantities the repo's
acceptance and tuning tools report (``scripts/run_earth.py:58-97``,
``scripts/tune_earth.py:52-110``, ``scripts/precision_year.py:46-64``),
written once for the port's ``run_earth``, ``tune_earth``,
``precision_year`` and ``spinup``.

Everything is taken to the host and computed there in float64 (the
scripts sum in the model's dtype on the device: the two differ by the
float32 round-off of a sum, ~1e-7 relative), except the overturning
streamfunctions, which ``diag.energy.meridional_overturning`` computes
on the device in the model's dtype.  ``ClimateWeights`` holds the area
weights; the functions return unrounded floats and the callers round
as their scripts do.
"""

from __future__ import annotations

import numpy as np
import torch

from .energy import meridional_overturning


def host(x) -> np.ndarray:
    """A tensor (or array) as a host float64 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class ClimateWeights:
    """The area weights of the indicators: cell areas without the cyclic
    columns (``area`` [cm^2]), the ocean and land masks of the EMBM
    (``tmsk``, ``lmsk``) and their areas (``oarea``, ``larea``), the
    T-row latitudes (``lat``), the hemispheres' ocean areas on the
    device in float64 (``nh``, ``sh``: the spin-up's sea-ice samples),
    the ocean cells' volumes (``dvol`` [cm^3], host) and the Atlantic
    mask of the AMOC (``amask``)."""

    def __init__(self, m):
        from ..core.earth import atlantic_mask
        g = m.grid
        self.lat = np.asarray(g.yt)
        area = (np.asarray(g.cst)[:, None] * np.asarray(g.dyt)[:, None]
                * np.asarray(g.dxt)[None, :])
        area[:, 0] = 0.0
        area[:, -1] = 0.0
        self.area = area
        self.tmsk = host(m.embm.tmsk)
        self.lmsk = 1.0 - self.tmsk
        self.oarea = area * self.tmsk
        self.larea = area * self.lmsk
        self.dvol = (np.asarray(g.dzt)[:, None, None] * area[None]
                     * host(m.ocean.tmask))

        def dev(x):
            return torch.as_tensor(x, dtype=torch.float64, device=m.device)

        self.nh = dev((self.lat > 0)[:, None] * self.oarea)
        self.sh = dev((self.lat < 0)[:, None] * self.oarea)
        self.amask = atlantic_mask(g)


def area_mean(f, w) -> float:
    """The ``w``-weighted mean of the 2-D field ``f``."""
    return float((host(f) * w).sum() / w.sum())


def zonal(f, w, empty=np.nan) -> np.ndarray:
    """The ``w``-weighted zonal means of ``f`` by row; ``empty`` where a
    row has no weight (``scripts/tune_earth.py:52-55``)."""
    ws = w.sum(1)
    return np.where(ws > 0, (host(f) * w).sum(1) / np.maximum(ws, 1e-30),
                    empty)


def pick(zb, lat, lats) -> list:
    """The values of the by-row ``zb`` at the rows nearest ``lats``."""
    return [float(zb[int(np.argmin(np.abs(lat - L)))]) for L in lats]


def toa_net(acc) -> np.ndarray:
    """The net TOA flux, absorbed shortwave minus OLR [W/m^2], of the
    flux totals ``acc`` (a segment's ``last_acc`` or a year's sums)."""
    return (host(acc["toa_sw"]) - host(acc["olr"])) / host(acc["time"]) \
        * 1e-3


def flux_wm2(acc, key) -> np.ndarray:
    """The mean of the accumulated flux ``acc[key]`` [W/m^2]."""
    return host(acc[key]) / host(acc["time"]) * 1e-3


def overturning_sv(m, v, xmask=None) -> np.ndarray:
    """The meridional overturning streamfunction [Sv] (km, jmt) of the
    velocity ``v`` (a tensor or array), over the basin of the 2-D mask
    ``xmask`` (None: the whole ocean)."""
    dt, dev = m.ocean.tmask.dtype, m.ocean.tmask.device
    v = torch.as_tensor(host(v), dtype=dt, device=dev)
    umask = m.ocean.umask
    if xmask is not None:
        umask = umask * torch.as_tensor(np.asarray(xmask), dtype=dt,
                                        device=dev)[None]
    return host(meridional_overturning(v, m.ocean.g, umask)) / 1e12


def atlantic_deep_max(m, moc_atl) -> float:
    """The Atlantic cell's maximum below 500 m between 20N and 70N
    (``scripts/run_earth.py:69-72,86-87``)."""
    deep = np.asarray(m.grid.zt) >= 500.0e2
    yu = np.asarray(m.grid.yu)
    jlat = (yu > 20.0) & (yu < 70.0)
    return float(moc_atl[np.ix_(deep, jlat)].max())


def ice_area(aice, weight) -> float:
    """Sea-ice area [1e6 km^2] of the concentration ``aice`` over the
    area weights ``weight`` [cm^2]."""
    return float((host(aice) * weight).sum()) / 1e16


def psi_max(psi) -> float:
    """The largest |barotropic streamfunction| [Sv]."""
    return float(np.abs(host(psi)).max()) / 1e12


def acceptance_row(m, state, w: ClimateWeights) -> dict:
    """The climate diagnostics of ``scripts/run_earth.py:61-97`` (its
    ``diags``) after a segment: the means, the sea-ice areas by
    hemisphere, the overturning of the segment-mean velocity (global
    and Atlantic deep), psi and the segment's TOA and ocean heat flux."""
    sst = host(state.ocean.t[0, 0])
    nh = (w.lat > 0)[:, None] * w.area
    sh = (w.lat < 0)[:, None] * w.area
    v_mean = m.last_tavg["v"]
    moc = overturning_sv(m, v_mean)
    moc_atl = overturning_sv(m, v_mean, w.amask)
    acc = m.last_acc
    return dict(
        sst_mean=area_mean(sst, w.oarea),
        sst_trop=float(sst.max()),
        sat_mean=float(host(state.atm.at[0]).mean()),
        ice_area_nh_1e6km2=ice_area(state.ice.aice, w.tmsk * nh),
        ice_area_sh_1e6km2=ice_area(state.ice.aice, w.tmsk * sh),
        moc_global_max_sv=float(moc.max()),
        moc_atl_deep_max_sv=atlantic_deep_max(m, moc_atl),
        psi_max_sv=psi_max(state.ocean.psi0),
        toa_wm2=area_mean(toa_net(acc), w.area),
        ohf_wm2=area_mean(flux_wm2(acc, "heat"), w.oarea),
    )


TUNE_SST_LATS = (-65, -60, -30, 0, 30, 60, 75, 85)
TUNE_LATS = (-85, -60, -30, 0, 30, 60, 85)


def tuning_row(m, state, w: ClimateWeights) -> dict:
    """The climate indicators of ``scripts/tune_earth.py:57-110`` (its
    ``report`` without the year and the wall time), unrounded: global,
    extreme and zonal SAT and SST, the sea-ice areas, psi, the
    overturning's extrema of the segment-mean velocity and the segment's
    TOA, OLR and ocean heat flux."""
    sst = host(state.ocean.t[0, 0])
    sat = host(state.atm.at[0])
    nh = (w.lat > 0)[:, None]
    moc = overturning_sv(m, m.last_tavg["v"])
    acc = m.last_acc
    toa2d = toa_net(acc)
    return dict(
        sat_gm=area_mean(sat, w.area),
        sat_max=float(sat.max()),
        sat_land_max=float((sat * w.lmsk).max()),
        sst_gm=area_mean(sst, w.oarea),
        sst_max=float(sst.max()),
        sst_min=float(np.where(w.tmsk > 0, sst, 99.0).min()),
        sst_z=pick(zonal(sst, w.oarea), w.lat, TUNE_SST_LATS),
        sat_z=pick(zonal(sat, w.area), w.lat, TUNE_LATS),
        ice_nh=ice_area(state.ice.aice, w.oarea * nh),
        ice_sh=ice_area(state.ice.aice, w.oarea * ~nh),
        psi_sv=psi_max(state.ocean.psi0),
        moc_max=float(moc.max()),
        moc_min=float(moc.min()),
        toa_gm=area_mean(toa2d, w.area),
        olr_gm=area_mean(flux_wm2(acc, "olr"), w.area),
        ohf_gm=area_mean(flux_wm2(acc, "heat"), w.oarea),
        toa_z=pick(zonal(toa2d, w.area), w.lat, TUNE_LATS),
    )


def precision_row(state, w: ClimateWeights) -> dict:
    """The per-segment scalars of ``scripts/precision_year.py:53-63``:
    the global SAT and SST, the mean ocean temperature (``heat``), psi
    max [Sv] and the sea-ice area [1e6 km^2]."""
    t3 = host(state.ocean.t[0])
    return dict(
        sat_gm=area_mean(state.atm.at[0], w.area),
        sst_gm=area_mean(t3[0], w.oarea),
        heat=float((t3 * w.dvol).sum() / w.dvol.sum()),
        psi_max=psi_max(state.ocean.psi0),
        ice=ice_area(state.ice.aice, w.oarea),
    )
