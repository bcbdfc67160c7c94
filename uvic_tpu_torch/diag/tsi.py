"""Time-step integrals (tsi): scalar global diagnostics.

Port of ``uvic_tpu.diag.tsi`` (mom_tsi.F / embm_tsi.F): global means
and extrema written every ``tsiint`` days, the reference's regression
signal (two runs match iff their tsi streams match).  With
``deterministic`` the device computes per-column partials only and the
host sums them in float64 in a fixed order, so the row does not depend
on the device's reduction order; otherwise the sums run on the device in
the model's dtype, as the reference's default does.
"""

from __future__ import annotations

import os

import numpy as np
import torch


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

    def column_partials(self, ocean_state, atm_state=None, ice_state=None):
        """Per-(j, i) partials of every sum-based scalar, and the
        order-independent extrema."""
        t = ocean_state.t
        u = self.m.full_velocity(ocean_state.u, ocean_state.psi0)
        cols = dict(
            o_tbar=torch.sum(t[0] * self.dvol, dim=0),
            o_sbar=torch.sum(t[1] * self.dvol, dim=0),
            o_ke=0.5 * torch.sum((u[0] ** 2 + u[1] ** 2) * self.dvol,
                                 dim=0),
            o_sst=t[0, 0] * self.area,
            _vol=torch.sum(self.dvol, dim=0),
            _area=self.area)
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

    def _compute_deterministic(self, ocean_state, atm_state, ice_state):
        cols, ext = self.column_partials(ocean_state, atm_state, ice_state)
        s = {k: float(v.detach().cpu().numpy().astype(np.float64).sum())
             for k, v in cols.items()}
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

    def compute(self, ocean_state, atm_state=None, ice_state=None) -> dict:
        if self.deterministic:
            return self._compute_deterministic(ocean_state, atm_state,
                                               ice_state)
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
