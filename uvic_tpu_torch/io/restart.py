"""Checkpoint / restart of the coupled state (mom_rest.F, embm_rest.F).

Port of ``uvic_tpu.io.restart``: a compressed ``.npz`` with one array
per state field under the same keys (``ocean/t``, ``atm/at``,
``atm/nats``, ``ice/sig``, ``land/frac``, ``land/nacc``, ...), both
leapfrog time levels included, so that each package reads the other's
files and a split run reproduces a continuous one.  The counters
(``ocean/itt``, ``atm/nats``) are int32 arrays in the file and host
integers in the port.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..convert import coupled_state_from_numpy, coupled_state_to_numpy


def save_restart(path: str, state):
    """Write every field of the coupled state."""
    np.savez_compressed(path, **coupled_state_to_numpy(state))


def load_restart(path: str, template):
    """Read a restart into a state shaped like ``template``, on its
    device and in its dtype (values restore bit-for-bit in the stored
    precision).  A field the file lacks keeps the template's value, with
    a warning; keys of no state field (the reference's calendar entries
    ``__itt``, ``__days``) are ignored."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    known = coupled_state_to_numpy(template)
    missing = [k for k in known if k not in arrays]
    if missing:
        warnings.warn(
            f"restart {path}: {len(missing)} state field(s) absent, "
            f"keeping template values: {', '.join(missing[:8])}"
            + (" ..." if len(missing) > 8 else ""), stacklevel=2)
    return coupled_state_from_numpy({**known, **arrays}, template)
