"""Carry model state between ``uvic_tpu`` and the PyTorch port.

The JAX package's ``OceanState`` goes in as a dict of NumPy arrays under
its field names (``uvic_tpu/core/state.py``); the port's state comes
back out the same way.  The coupled state goes both ways under the
restart's keys ("ocean/t", "atm/nats", "land/frac", "sed/calgg", ...),
the keys of ``uvic_tpu.io.restart``.  A climatology (``TimeInterpField``)
and a region set (``Regions``) come in from their NumPy arrays, so that
both packages compute from the same inputs.  Parameters are not
converted: the port builds its own from the configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.state import OceanState

_TENSOR_FIELDS = ("tm1", "t", "um1", "u", "psi0", "psi1", "ptd", "ptdb",
                  "ubar", "ubarm1")


def ocean_state_from_numpy(d, device, dtype=None) -> OceanState:
    """Port state from a dict of NumPy arrays; ``dtype`` defaults to that
    of ``d["t"]``."""
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, np.asarray(d["t"]).dtype)).dtype
    fields = {name: torch.as_tensor(np.array(d[name]), dtype=dtype,
                                    device=device)
              for name in _TENSOR_FIELDS}
    nconv = d.get("nconv")
    nconv = 0 if nconv is None else int(np.asarray(nconv))
    return OceanState(**fields, itt=int(np.asarray(d["itt"])),
                      nconv=torch.tensor(nconv, dtype=torch.int32,
                                         device=device))


def ocean_state_to_numpy(state: OceanState) -> dict:
    """Dict of NumPy arrays under the ``uvic_tpu`` field names."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in _TENSOR_FIELDS}
    out["itt"] = np.asarray(state.itt, np.int32)
    out["nconv"] = np.asarray(state.nconv.cpu(), np.int32)
    return out


def coupled_state_to_numpy(state) -> dict:
    """Every field of a coupled state as NumPy under the restart keys;
    the host counters as int32 arrays."""
    from .coupler.driver import pack_state
    out = {k: v.detach().cpu().numpy() for k, v in pack_state(state).items()}
    out["ocean/itt"] = np.asarray(state.ocean.itt, np.int32)
    out["atm/nats"] = np.asarray(state.atm.nats, np.int32)
    return out


def coupled_state_from_numpy(d, template):
    """A coupled state shaped like ``template`` (its device, each
    field's dtype) from NumPy arrays under the restart keys."""
    from .coupler.driver import host_of, pack_state, unpack_state
    ws = {k: torch.as_tensor(np.array(d[k]), dtype=v.dtype,
                             device=v.device)
          for k, v in pack_state(template).items()}
    host = dict(host_of(template), itt=int(np.asarray(d["ocean/itt"])),
                nats=int(np.asarray(d["atm/nats"])))
    return unpack_state(ws, host)


def time_interp_field_from_numpy(records, centers, device):
    """A ``TimeInterpField`` holding ``uvic_tpu``'s records and centers
    (NumPy arrays, their dtype kept) on ``device``."""
    from .io.timeforce import TimeInterpField
    records = np.asarray(records)
    return TimeInterpField(records, centers=np.asarray(centers),
                           dtype=records.dtype, device=device)


def regions_from_numpy(d, device):
    """Port ``Regions`` from a dict of NumPy arrays under the field names
    of ``uvic_tpu.diag.regions.Regions`` (its ``_dvol`` as ``dvol``)."""
    from .diag.regions import Regions
    fields = {k: torch.as_tensor(np.array(d[k]), device=device)
              for k in ("mskhr", "mskvr", "hmask", "vmask", "areab",
                        "volbk", "volbt", "dvol")}
    return Regions(hregnm=tuple(d["hregnm"]), vregnm=tuple(d["vregnm"]),
                   **fields)
