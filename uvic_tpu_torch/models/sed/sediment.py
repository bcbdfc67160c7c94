"""Ocean sediment columns with the interfacial dissolution closure, in
PyTorch.

Port of ``uvic_tpu.models.sed.sediment`` (source/sed/: sed.F driver,
sediment.F Archer 1996-style diagenesis) in its legacy form,
``SedConfig(porewater=False)``: every ocean-bottom cell carries a
mixed-layer column as dense masked fields, and the pore-water CO3
balance collapses to the Keir/Archer interfacial rate law

    dissolution = k_diss * fCaCO3 * max(0, 1 - CO3_bw/CO3_sat)^n

with organic-carbon respiration, calcite burial from a mixed layer of
fixed capacity, and the coupler's fluxes (rain in, dissolved carbon and
alkalinity back to the bottom water).  The pore-water profile solver is
``porewater.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass
class SedState:
    caco3: torch.Tensor     # (jmt, imt) mixed-layer CaCO3 [umol/cm^2]
    orgc: torch.Tensor      # organic carbon [umol/cm^2]
    buried: torch.Tensor    # cumulative burial [umol/cm^2]
    rain_cal: torch.Tensor  # accumulated calcite rain [umol/cm^2]
    rain_org: torch.Tensor  # accumulated organic rain [umol/cm^2]

    def replace(self, **kw) -> "SedState":
        return replace(self, **kw)


SED_FIELDS = ("caco3", "orgc", "buried", "rain_cal", "rain_org")


def init_sed_state(jmt, imt, dtype, device="cpu"):
    z = torch.zeros((jmt, imt), dtype=dtype, device=device)
    return SedState(caco3=z + 100.0, orgc=z + 10.0, buried=z.clone(),
                    rain_cal=z.clone(), rain_org=z.clone())


KDISS = 0.2 / 86400.0     # dissolution rate constant [1/s]
NDISS = 4.5               # Keir rate-law exponent
KORG = 0.05 / 86400.0     # organic respiration rate [1/s]
MIXED_CAP = 2500.0        # mixed-layer capacity [umol/cm^2]


def co3_saturation(depth_cm):
    """Calcite saturation CO3 [mol/m^3] against depth (lysocline shape)."""
    return 0.0423 * torch.exp(depth_cm / 100.0 / 3890.0) * 1.0e-3 * 2.465


def sed_step(state: SedState, co3_bw, depth_cm, ocean_mask, dtsed):
    """One sediment step (sed.F:2-313 cadence).

    co3_bw : bottom-water carbonate ion [mol/m^3]
    Returns (new state, fluxes) with the dic and alk fluxes to the bottom
    water [umol/cm^2/s] (positive into the ocean) and the burial rate.
    """
    co3sat = co3_saturation(depth_cm)
    undersat = torch.clamp(1.0 - co3_bw / co3sat, min=0.0)
    # the rain accumulated since the last sediment step
    caco3 = state.caco3 + state.rain_cal
    orgc = state.orgc + state.rain_org

    diss = KDISS * caco3 * undersat ** NDISS
    resp = KORG * orgc
    caco3 = torch.clamp(caco3 - dtsed * diss, min=0.0)
    orgc = torch.clamp(orgc - dtsed * resp, min=0.0)

    # burial: the mixed layer has a finite capacity, the excess buries
    excess = torch.clamp(caco3 - MIXED_CAP, min=0.0)
    caco3 = caco3 - excess
    buried = state.buried + excess

    wet = ocean_mask > 0
    z = torch.zeros_like(co3_bw)
    new = SedState(
        caco3=torch.where(wet, caco3, state.caco3),
        orgc=torch.where(wet, orgc, state.orgc),
        buried=torch.where(wet, buried, state.buried),
        rain_cal=z, rain_org=z.clone())
    fluxes = dict(
        dic=(diss + resp) * ocean_mask,        # [umol/cm^2/s]
        alk=2.0 * diss * ocean_mask,
        burial=excess / max(dtsed, 1.0) * ocean_mask,
    )
    return new, fluxes


def add_rain(state: SedState, rain_cal, rain_org):
    """Accumulate particle rain between sediment steps (the sbc
    irorg/ircal accumulation, tracer.F:387-391, 505-510)."""
    return state.replace(rain_cal=state.rain_cal + rain_cal,
                         rain_org=state.rain_org + rain_org)

