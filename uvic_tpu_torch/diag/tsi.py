"""Time-step integrals (tsi): scalar global diagnostics.

Port of ``uvic_tpu.diag.tsi`` (mom_tsi.F / embm_tsi.F): global means
and extrema written every ``tsiint`` days, the reference's regression
signal (two runs match iff their tsi streams match).  With
``deterministic`` the device computes per-column partials only (summed
level by level) and the host sums them in float64 in a fixed order, so
the row does not depend on the device's reduction order; otherwise the sums run on the device in
the model's dtype, as the reference's default does.

The deterministic row also comes from a rank-decomposed state (``mesh``:
the ocean state as ``parallel.mesh.shard_pytree`` cuts it, the
atmosphere and ice whole): each rank computes its block's column
partials (the full velocity's external mode from the replicated
streamfunction), the partials are gathered into the whole (jmt, imt)
arrays and summed on the host in the same C order, so the row is
bitwise the unsharded one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.ocean.tropic import ext_mode_velocity
from ..parallel.mesh import gather_field, local_block

# the ocean's column partials (gathered from the blocks of a mesh)
OCEAN_COLS = ("o_tbar", "o_sbar", "o_ke", "o_sst", "_vol", "_area")


def column_sum(a):
    """The sum over the leading (level) axis, level by level: the same
    bits whatever the layout of the columns (``torch.sum`` over an axis
    may pair the terms otherwise for another inner size)."""
    out = a[0]
    for k in range(1, a.shape[0]):
        out = out + a[k]
    return out


def host_sum(a) -> float:
    """The float64 sum of a tensor's elements on the host, in C order."""
    return float(np.ascontiguousarray(
        a.detach().cpu().numpy()).astype(np.float64).sum())


class TsiDiagnostics:
    def __init__(self, ocean_model, embm_model=None, deterministic=False):
        self.m = ocean_model
        self.embm = embm_model
        self.deterministic = deterministic
        g = ocean_model.g
        tmask = ocean_model.tmask
        dvol = (g.dzt[:, None, None] * g.cst[None, :, None]
                * g.dyt[None, :, None] * g.dxt[None, None, :]) * tmask
        dvol[:, :, 0] = 0.0
        dvol[:, :, -1] = 0.0
        self.dvol = dvol
        self.vol = torch.sum(dvol)
        area = (g.cst[:, None] * g.dyt[:, None] * g.dxt[None, :]) \
            * tmask[0]
        area[:, 0] = 0.0
        area[:, -1] = 0.0
        self.area = area
        self.area_tot = torch.sum(area)

    def column_partials(self, ocean_state, atm_state=None, ice_state=None,
                        mesh=None):
        """Per-(j, i) partials of every sum-based scalar, and the
        order-independent extrema; with ``mesh`` the ocean's partials on
        the rank's block of a rank-decomposed ``ocean_state``."""
        t = ocean_state.t
        if mesh is None:
            u = self.m.full_velocity(ocean_state.u, ocean_state.psi0)
            dvol, area = self.dvol, self.area
        else:
            u = self._block_velocity(ocean_state, mesh)
            dvol, area = self._local(self.dvol, mesh), self._local(
                self.area, mesh)
        cols = dict(
            o_tbar=column_sum(t[0] * dvol),
            o_sbar=column_sum(t[1] * dvol),
            o_ke=0.5 * column_sum((u[0] ** 2 + u[1] ** 2) * dvol),
            o_sst=t[0, 0] * area,
            _vol=column_sum(dvol),
            _area=area)
        ext = dict(o_psi_max=torch.max(ocean_state.psi0) * 1e-12,
                   o_psi_min=torch.min(ocean_state.psi0) * 1e-12)
        if atm_state is not None:
            interior = torch.zeros_like(atm_state.at[0])
            interior[1:-1, 1:-1] = 1.0
            cols["a_sat"] = atm_state.at[0] * interior
            cols["a_shum"] = atm_state.at[1] * interior
            cols["_n_atm"] = interior
        if ice_state is not None:
            cols["i_area"] = ice_state.aice * self.area
            cols["i_vol"] = ice_state.hice * self.area
        return cols, ext

    def _local(self, a, mesh):
        g = self.m.params.grid
        return local_block(a, mesh, g.jmt, g.imt)

    def _block_velocity(self, ocean_state, mesh):
        """The full velocity on the block: the block's internal mode and
        the block of the external mode of the replicated psi0 (the ghost
        columns are left as they come: their volume is zero)."""
        g = self.m.g
        uext, vext = ext_mode_velocity(ocean_state.psi0, g.hr, g.dxu2r,
                                       g.dyu2r, g.csur)
        umask = self._local(self.m.umask, mesh)
        ui = ocean_state.u
        return torch.stack(
            [(ui[0] + self._local(uext, mesh)[None]) * umask,
             (ui[1] + self._local(vext, mesh)[None]) * umask])

    def _compute_deterministic(self, ocean_state, atm_state, ice_state,
                               mesh=None):
        cols, ext = self.column_partials(ocean_state, atm_state, ice_state,
                                         mesh)
        if mesh is not None:
            g = self.m.params.grid
            whole = gather_field(torch.stack([cols[k] for k in OCEAN_COLS]),
                                 mesh, g.jmt, g.imt)
            cols.update(zip(OCEAN_COLS, whole))
        s = {k: host_sum(v) for k, v in cols.items()}
        out = dict(o_tbar=s["o_tbar"] / s["_vol"],
                   o_sbar=s["o_sbar"] / s["_vol"] * 1000.0 + 35.0,
                   o_ke=s["o_ke"] / s["_vol"],
                   o_sst=s["o_sst"] / s["_area"])
        if atm_state is not None:
            out["a_sat"] = s["a_sat"] / s["_n_atm"]
            out["a_shum"] = s["a_shum"] / s["_n_atm"]
        if ice_state is not None:
            out["i_area"] = s["i_area"] * 1e-10
            out["i_vol"] = s["i_vol"] * 1e-15
        out.update({k: float(v) for k, v in ext.items()})
        return out

    def _compute_device(self, ocean_state, atm_state, ice_state):
        t = ocean_state.t
        out = dict(
            o_tbar=torch.sum(t[0] * self.dvol) / self.vol,
            o_sbar=torch.sum(t[1] * self.dvol) / self.vol * 1000.0 + 35.0)
        u = self.m.full_velocity(ocean_state.u, ocean_state.psi0)
        out["o_ke"] = 0.5 * torch.sum((u[0] ** 2 + u[1] ** 2)
                                      * self.dvol) / self.vol
        out["o_psi_max"] = torch.max(ocean_state.psi0) * 1e-12
        out["o_psi_min"] = torch.min(ocean_state.psi0) * 1e-12
        out["o_sst"] = torch.sum(t[0, 0] * self.area) / self.area_tot
        if atm_state is not None:
            sat = atm_state.at[0]
            out["a_sat"] = torch.sum(sat[1:-1, 1:-1]) \
                / (sat.shape[0] - 2) / (sat.shape[1] - 2)
            out["a_shum"] = torch.mean(atm_state.at[1][1:-1, 1:-1])
        if ice_state is not None:
            out["i_area"] = torch.sum(ice_state.aice * self.area) * 1e-10
            out["i_vol"] = torch.sum(ice_state.hice * self.area) * 1e-15
        return {k: float(v) for k, v in out.items()}

    def compute(self, ocean_state, atm_state=None, ice_state=None,
                mesh=None) -> dict:
        """The tsi row; with ``mesh``, of the rank-decomposed
        ``ocean_state`` (every rank calls it together and gets the row;
        deterministic only)."""
        if self.deterministic:
            return self._compute_deterministic(ocean_state, atm_state,
                                               ice_state, mesh)
        if mesh is not None:
            raise ValueError("a row of a rank-decomposed state needs "
                             "deterministic=True")
        return self._compute_device(ocean_state, atm_state, ice_state)


class TsiWriter:
    """Appends tsi rows to a CSV file (the netCDF tsi stream analog)."""

    def __init__(self, path):
        self.path = path
        self._wrote_header = False

    def write(self, days: float, row: dict):
        keys = sorted(row)
        if not self._wrote_header and not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write("days," + ",".join(keys) + "\n")
            self._wrote_header = True
        with open(self.path, "a") as f:
            f.write(f"{days:.4f}," +
                    ",".join(f"{row[k]:.10e}" for k in keys) + "\n")
