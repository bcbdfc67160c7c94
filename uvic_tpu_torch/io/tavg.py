"""Time-averaged field output (tavg: mom_tavg.F, timeavgs.h, ice.h:72-107).

Port of ``uvic_tpu.io.tavg``: running sums of the averaged fields kept
as tensors on the model's device, normalized to NumPy time means when a
record is written (``io.netcdf.write_tavg``).
"""

from __future__ import annotations


class TavgAccumulator:
    """Accumulates field dicts; ``normalize()`` returns their time means
    as NumPy arrays and starts a new window."""

    def __init__(self):
        self.sums = None
        self.n = 0

    def accumulate(self, fields: dict):
        if self.sums is None:
            self.sums = {k: v.clone() for k, v in fields.items()}
        else:
            for k, v in fields.items():
                self.sums[k].add_(v)
        self.n += 1

    def normalize(self) -> dict:
        if self.n == 0:
            return {}
        out = {k: v.detach().cpu().numpy() / self.n
               for k, v in self.sums.items()}
        self.sums = None
        self.n = 0
        return out


def ocean_tavg_fields(ocean_model, ocean_state) -> dict:
    """The standard averaged field set (mom_tavg.F selection)."""
    u = ocean_model.full_velocity(ocean_state.u, ocean_state.psi0)
    return dict(
        temp=ocean_state.t[0],
        salt=ocean_state.t[1] * 1000.0 + 35.0,
        u=u[0], v=u[1],
        psi=ocean_state.psi0,
    )


def coupled_tavg_fields(model, state) -> dict:
    """The ocean's set plus the atmosphere's and the ice's snapshots."""
    out = ocean_tavg_fields(model.ocean, state.ocean)
    out.update(dict(
        sat=state.atm.at[0],
        shum=state.atm.at[1],
        hice=state.ice.hice,
        aice=state.ice.aice,
        hsno=state.ice.hsno,
    ))
    return out
