"""Declarative ocean tracer registry (physics tracers of the port).

The reference composes the tracer count additively from CPP flags
(size.h:28-50) and assigns indices imperatively in `tracer_init`
(UVic_ESCM.F:991-1133).  Here a declarative table is built from the
BgcConfig: each tracer has a name, units, an initial value, and flags
for sources / surface fluxes / virtual fluxes.  Index constants
(itemp, isalt, idic, ...) become attributes looked up by name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..config import BgcConfig


@dataclass(frozen=True)
class Tracer:
    name: str
    units: str
    init: float              # uniform initial value (idealized IC)
    has_source: bool = False
    surface_flux: bool = False   # participates in gas/virtual flux exchange


def build_registry(bgc: BgcConfig) -> List[Tracer]:
    """Tracer table in reference order (UVic_ESCM.F tracer_init)."""
    tr = [
        Tracer("temp", "deg C", 10.0),
        Tracer("salt", "(psu-35)/1000", 0.0),
    ]
    if bgc.suite != "none":
        raise NotImplementedError(
            "the PyTorch port carries the physics tracers only; "
            f"bgc suite {bgc.suite!r} is not ported yet")
    return tr


class TracerIndex:
    """Name -> index lookup (the itemp/isalt/... registry)."""

    def __init__(self, tracers: List[Tracer]):
        self.tracers = tracers
        for i, t in enumerate(tracers):
            setattr(self, "i" + t.name, i)
        self.nt = len(tracers)
