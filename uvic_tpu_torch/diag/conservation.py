"""Conservation audits (global_sums.F ``globalsum`` equivalents), in
PyTorch.

Port of ``uvic_tpu.diag.conservation``:

- ConservationAudit: the ocean's heat and salt inventories and their
  drift, which ``coupler.run.Run`` logs at the end of each year and
  writes into ``run_summary.json``; the deterministic inventories also
  of a rank-decomposed ocean state (the blocks' column partials
  gathered and summed on the host in the same order: bitwise the
  unsharded ones).
- FullAudit: the five-reservoir heat/water/carbon accounting of
  source/common/global_sums.F:74-260 (atmosphere, snow+ice, land, ocean)
  with the reference's unit conversions, and the ocean's segment
  closure: the change of each tracer inventory against the boundary
  fluxes the coupler applied.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.embm import constants as C
from ..parallel.mesh import gather_field, local_block
from .tsi import column_sum, host_sum


class ConservationAudit:
    def __init__(self, ocean_model, deterministic=False):
        """deterministic=True: the device computes per-column partials
        only (level by level) and the host sums them in float64 in a fixed order, so the
        inventories do not depend on the device's reduction order."""
        g = ocean_model.params.grid
        tmask = ocean_model.tmask
        dvol = torch.as_tensor(
            g.dzt[:, None, None] * g.cst[None, :, None]
            * g.dyt[None, :, None] * g.dxt[None, None, :],
            dtype=tmask.dtype, device=tmask.device) * tmask
        # count each physical cell once (the duplicated cyclic columns)
        dvol[:, :, 0] = 0.0
        dvol[:, :, -1] = 0.0
        self.dvol = dvol
        self.deterministic = deterministic

    def inventories(self, ocean_state, mesh=None) -> dict:
        """{"heat": [K cm^3], "salt": [model-S cm^3]} host floats; with
        ``mesh``, of the rank-decomposed ``ocean_state`` (every rank
        calls it together; deterministic only)."""
        t = ocean_state.t
        if self.deterministic:
            dvol = self.dvol
            jmt, imt = dvol.shape[-2:]
            if mesh is not None:
                dvol = local_block(dvol, mesh, jmt, imt)
            cols = torch.stack([column_sum(t[n] * dvol) for n in range(2)])
            if mesh is not None:
                cols = gather_field(cols, mesh, jmt, imt)
            return {k: host_sum(cols[n])
                    for n, k in enumerate(("heat", "salt"))}
        if mesh is not None:
            raise ValueError("inventories of a rank-decomposed state need "
                             "deterministic=True")
        return {k: float(torch.sum(t[n] * self.dvol))
                for n, k in enumerate(("heat", "salt"))}

    def drift(self, before: dict, after: dict) -> dict:
        out = {}
        for k in before:
            # scale by the larger magnitude (a zero initial inventory,
            # e.g. model-unit salt, must not blow the relative number)
            scale = max(abs(before[k]), abs(after[k]), 1e-30)
            out[k] = (after[k] - before[k]) / scale
        return out


class FullAudit:
    """Heat/water/carbon inventories across the atmosphere, snow+ice,
    land and ocean (global_sums.F:74-260), and the ocean's segment
    closure against the applied boundary fluxes.  Units follow the
    reference's conversions (global_sums.F:222-260): heat in J, water
    and carbon in kg."""

    REDCTN = 7.1e-3   # mol C per mmol N detritus (npzd redctn + molw)

    def __init__(self, coupled_model):
        cm = coupled_model
        g = cm.grid
        area = (np.asarray(g.cst)[:, None] * np.asarray(g.dyt)[:, None]
                * np.asarray(g.dxt)[None, :])
        area[:, 0] = 0.0
        area[:, -1] = 0.0
        area[0, :] = 0.0
        area[-1, :] = 0.0
        dt, dev = cm.dtype, cm.device
        self.area = torch.as_tensor(area, dtype=dt, device=dev)   # [cm^2]
        self.ocean_area = self.area * torch.as_tensor(
            np.asarray(cm.topo.kmt) > 0, dtype=dt, device=dev)
        self.dvol = torch.as_tensor(np.asarray(g.dzt), dtype=dt,
                                    device=dev)[:, None, None] \
            * self.area[None] * cm.ocean.tmask                     # [cm^3]
        self.idx = cm.ocean.tracer_index
        self.lmsk = cm.embm.lmsk

    def inventories(self, state, co2ccn=280.0) -> dict:
        idx = self.idx
        out = {}
        at = state.atm.at
        # atmosphere (global_sums.F:139-147, 222-229)
        taf = torch.sum(at[1] * self.area)                   # shum cm^2
        tah = torch.sum(at[0] * self.area)
        out["atm_heat_J"] = (taf * C.RHOATM * C.SHQ * C.VLOCN
                             + tah * C.CPATM * C.RHOATM * C.SHT) * 1e-7
        out["atm_water_kg"] = taf * C.RHOATM * C.SHQ * 1e-3
        co2 = torch.as_tensor(co2ccn, dtype=self.area.dtype,
                              device=self.area.device)
        out["atm_carbon_kg"] = (co2 * torch.sum(self.area)
                                * 4.138e-7 * C.RHOATM * C.SHC * 1e-3)
        # snow + ice water [kg]: h in cm over the cell area
        ice = state.ice
        out["ice_water_kg"] = (
            torch.sum(ice.hice * ice.aice * self.area) * C.RHOICE * 1e-3
            + torch.sum(ice.hsno * self.area) * C.RHOSNO * 1e-3)
        # land: EMBM soil moisture [kg] and the MTLM carbon pools
        out["land_water_kg"] = torch.sum(
            state.atm.soilm * self.lmsk * self.area) * 1e-3
        if state.land is not None:
            from ..models.land.mtlm import A_WL, B_WL, SIGL
            lai = state.land.lai

            def col(x):
                return torch.as_tensor(x, dtype=lai.dtype,
                                       device=lai.device)[:, None, None]

            leaf = col(SIGL) * lai
            wood = col(A_WL) * lai ** col(B_WL)
            cv = torch.sum(state.land.frac[:leaf.shape[0]]
                           * (leaf + wood), dim=0)
            out["land_carbon_kg"] = torch.sum(
                (cv + state.land.cs) * self.lmsk * self.area) * 1e-4
        # ocean (global_sums.F:199-221, 243-258)
        t = state.ocean.t
        rhocp = 4.186e7     # erg/cm^3/K (~1 cal/cm^3/K seawater)
        out["ocn_heat_J"] = torch.sum(t[0] * self.dvol) * rhocp * 1e-7
        out["ocn_salt_kg"] = torch.sum(t[1] * self.dvol)
        if "dic" in idx:
            toc = torch.sum(t[idx.idic] * self.dvol)
            for name in ("phyt", "zoop", "detr", "diaz"):
                if name in idx:
                    toc = toc + torch.sum(t[idx[name]] * self.dvol) \
                        * self.REDCTN
            out["ocn_carbon_kg"] = toc * 12.0e-9     # umol -> kg C
        return {k: float(v) for k, v in out.items()}

    def ocean_closure(self, before_t, after_t, forcing, nsteps,
                      dtts) -> dict:
        """Ocean inventory change against the applied boundary fluxes
        over ``nsteps`` tracer steps: d(inv)/dt must equal the
        area-summed stf (+ btf) for every tracer (the tracer step is
        conservative in flux form).  Per-tracer relative errors."""
        total_dt = nsteps * dtts
        d_inv = torch.einsum("nkji,kji->n", after_t - before_t, self.dvol)
        flux = torch.sum(forcing.stf * self.ocean_area[None],
                         dim=(1, 2)) * total_dt
        if forcing.btf is not None:
            flux = flux - torch.sum(forcing.btf * self.ocean_area[None],
                                    dim=(1, 2)) * total_dt
        scale = torch.clamp(torch.abs(flux), min=1e-30)
        rel = ((d_inv - flux) / scale).cpu().numpy()
        return {tr.name: float(rel[k])
                for k, tr in enumerate(self.idx.tracers)}
