"""Checkpoint / restart of the coupled state (mom_rest.F, embm_rest.F).

Port of ``uvic_tpu.io.restart``: a compressed ``.npz`` with one array
per state field under the same keys (``ocean/t``, ``atm/at``,
``atm/nats``, ``ice/sig``, ``land/frac``, ``land/nacc``, ``sed/calgg``,
``sed/carb``, ...), both leapfrog time levels included, so that each
package reads the other's files and a split run reproduces a continuous
one.  The counters (``ocean/itt``, ``atm/nats``) are int32 arrays in the
file and host integers in the port.  With a ``TimeManager`` the file
also carries the calendar (``__itt``, ``__days``), as the reference's
does, so that a ``Run`` of either package resumes the other's with the
same clock.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..convert import coupled_state_from_numpy, coupled_state_to_numpy


def save_restart(path: str, state, time_manager=None):
    """Write every field of the coupled state, and the calendar of
    ``time_manager`` when given."""
    meta = {}
    if time_manager is not None:
        meta["__itt"] = np.asarray(time_manager.itt)
        meta["__days"] = np.asarray(time_manager.days)
    np.savez_compressed(path, **coupled_state_to_numpy(state), **meta)


def load_restart(path: str, template, time_manager=None):
    """Read a restart into a state shaped like ``template``, on its
    device and in its dtype (values restore bit-for-bit in the stored
    precision).  A field the file lacks keeps the template's value, with
    a warning; a field stored with another shape than the template's
    raises a ``ValueError`` naming it (an nt=2 restart read into an nt=41
    model, say), where the reference takes the array as it is and fails
    later.  The calendar entries (``__itt``, ``__days``) go into
    ``time_manager`` when one is given and the file has them."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    known = coupled_state_to_numpy(template)
    for k, v in known.items():
        if k in arrays and arrays[k].shape != v.shape:
            raise ValueError(
                f"restart {path}: {k} has shape {arrays[k].shape}, the "
                f"model's is {v.shape}")
    missing = [k for k in known if k not in arrays]
    if missing:
        warnings.warn(
            f"restart {path}: {len(missing)} state field(s) absent, "
            f"keeping template values: {', '.join(missing[:8])}"
            + (" ..." if len(missing) > 8 else ""), stacklevel=2)
    if time_manager is not None and "__itt" in arrays:
        time_manager.itt = int(arrays["__itt"])
        time_manager.days = float(arrays["__days"])
    return coupled_state_from_numpy({**known, **arrays}, template)
