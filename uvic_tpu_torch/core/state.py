"""Prognostic ocean state of the PyTorch port.

A plain dataclass of whole-domain tensors on one device, with the field
names of ``uvic_tpu.core.state.OceanState``.  Leapfrog time levels are
explicit fields and a step returns a new state.  Velocity fields hold
the *internal mode only*; the external (barotropic) mode is rebuilt from
the streamfunction when needed (loadmw.F:579-707 ``add_ext_mode``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class OceanState:
    tm1: torch.Tensor      # tracers (nt, km, jmt, imt) at tau-1
    t: torch.Tensor        # ... at tau
    um1: torch.Tensor      # internal-mode velocity (2, km, jmt, imt) at tau-1
    u: torch.Tensor        # ... at tau
    psi0: torch.Tensor     # streamfunction (jmt, imt) at tau
    psi1: torch.Tensor     # ... at tau-1
    ptd: torch.Tensor      # last two barotropic solutions, for the CG
    ptdb: torch.Tensor     # initial guess (tropic.F:146-160)
    ubar: torch.Tensor     # barotropic velocities (2, jmt, imt); zeros in
    ubarm1: torch.Tensor   # the streamfunction mode
    itt: int               # step counter (host side: it schedules leapfrog)
    nconv: torch.Tensor    # cumulative barotropic non-convergence count


def init_ocean_state(nt: int, km: int, jmt: int, imt: int, dtype,
                     device, t_init=None) -> OceanState:
    """Cold-start state (setmom.F idealized IC path)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    t0 = (zeros(nt, km, jmt, imt) if t_init is None
          else torch.as_tensor(t_init, dtype=dtype, device=device))
    return OceanState(
        tm1=t0.clone(), t=t0.clone(),
        um1=zeros(2, km, jmt, imt), u=zeros(2, km, jmt, imt),
        psi0=zeros(jmt, imt), psi1=zeros(jmt, imt),
        ptd=zeros(jmt, imt), ptdb=zeros(jmt, imt),
        ubar=zeros(2, jmt, imt), ubarm1=zeros(2, jmt, imt),
        itt=0,
        nconv=torch.zeros((), dtype=torch.int32, device=device),
    )
