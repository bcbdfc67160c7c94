"""Station, section and zonal-mean diagnostics, torch.

Port of ``uvic_tpu.diag.sections``, the reference's sampling
diagnostics:

- XbtStations  : per-station column time series of T/S/u/v
  (source/mom/xbt.F:1-200 `xbt` stations, txbtxbt output) — stations
  are fixed (lon, lat) columns gathered from the state each call.
- cross_section: vertical slice of a 3-D field along a latitude or
  longitude line (source/mom/diag.F:216+ "matrix sections" output).
- zonal_mean_sbc: zonal means of the surface boundary fields
  (source/mom/diag.F zonal-mean SBC block; embm_tsi zonal rows).

Each sampler gathers or reduces on the device the fields lie on and
hands NumPy arrays to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x):
    """A tensor's values as NumPy (a NumPy array as it is)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class XbtStations:
    """Fixed measurement columns (xbt.F station list)."""

    #: default station set: named basins of the reference xbt output
    DEFAULT = (
        ("n_atlantic", 330.0, 30.0),
        ("eq_atlantic", 335.0, 0.0),
        ("s_atlantic", 345.0, -30.0),
        ("n_pacific", 180.0, 40.0),
        ("eq_pacific", 220.0, 0.0),
        ("s_pacific", 220.0, -30.0),
        ("indian", 80.0, -10.0),
        ("southern", 200.0, -60.0),
        ("arctic", 0.0, 80.0),
    )

    def __init__(self, grid, stations=None):
        stations = stations or self.DEFAULT
        lon = np.asarray(grid.xt) % 360.0
        lat = np.asarray(grid.yt)
        self.names, jj, ii = [], [], []
        for name, slon, slat in stations:
            self.names.append(name)
            ii.append(int(np.argmin(np.abs(lon - (slon % 360.0)))))
            jj.append(int(np.argmin(np.abs(lat - slat))))
        self.jj = np.asarray(jj)
        self.ii = np.asarray(ii)

    def sample(self, ocean_state, ocean_model) -> dict:
        """dict name -> dict(temp/salt/u/v: (km,) column)."""
        t = ocean_state.t
        jj = torch.as_tensor(self.jj, device=t.device)
        ii = torch.as_tensor(self.ii, device=t.device)
        uf = ocean_model.full_velocity(ocean_state.u, ocean_state.psi0)
        cols = dict(
            temp=t[0][:, jj, ii],
            salt=t[1][:, jj, ii] * 1000.0 + 35.0,
            u=uf[0][:, jj, ii],
            v=uf[1][:, jj, ii],
        )
        cols = {k: _host(v) for k, v in cols.items()}
        return {name: {k: v[:, n] for k, v in cols.items()}
                for n, name in enumerate(self.names)}


def cross_section(field, grid, lat=None, lon=None):
    """Vertical section of a (km, jmt, imt) field along a fixed
    latitude (returns (km, imt)) or longitude (returns (km, jmt))."""
    if (lat is None) == (lon is None):
        raise ValueError("specify exactly one of lat=, lon=")
    if lat is not None:
        j = int(np.argmin(np.abs(np.asarray(grid.yt) - lat)))
        return _host(field[:, j, :])
    i = int(np.argmin(np.abs((np.asarray(grid.xt) % 360.0)
                             - (lon % 360.0))))
    return _host(field[:, :, i])


def zonal_mean_sbc(fields: dict, tmask_surf, dxt) -> dict:
    """Zonal means over ocean cells of surface boundary fields
    (diag.F zonal-mean SBC): fields maps name -> (jmt, imt) tensors on
    the device of ``tmask_surf``."""
    w = tmask_surf * torch.as_tensor(np.asarray(dxt), dtype=tmask_surf.dtype,
                                     device=tmask_surf.device)[None, :]
    w[:, 0] = 0.0
    w[:, -1] = 0.0
    wsum = torch.clamp(torch.sum(w, dim=1), min=1e-30)
    return {k: _host(torch.sum(v * w, dim=1) / wsum)
            for k, v in fields.items()}
