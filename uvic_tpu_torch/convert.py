"""Carry an ocean state between ``uvic_tpu`` and the PyTorch port.

The JAX package's ``OceanState`` goes in as a dict of NumPy arrays under
its field names (``uvic_tpu/core/state.py``); the port's state comes
back out the same way.  Parameters are not converted: the port builds
its own from the configuration.
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
