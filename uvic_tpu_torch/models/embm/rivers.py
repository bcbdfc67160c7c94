"""River routing: land runoff to ocean discharge points (rivmodel.F).

Port of ``uvic_tpu.models.embm.rivers``: basins come from a
breadth-first "flow to the nearest coast" labeling at construction (each
land cell drains to its closest ocean cell, cyclic in x), and discharge
is a segment sum of runoff mass into the mouth cells.  The sum is a
gather of each mouth's sources from a padded table and a sum over the
table's rows, so it adds in the same order on every call (a scatter-add
with atomics would not, and a replayed segment would then differ from
an eager one).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch


def build_routing(kmt: np.ndarray, cyclic: bool = True) -> np.ndarray:
    """Flat index of the ocean cell each land cell drains to; ocean and
    boundary cells map to themselves."""
    jmt, imt = kmt.shape
    ocean = kmt > 0
    target = np.full((jmt, imt), -1, dtype=np.int64)
    q = deque()
    jj, ii = np.where(ocean)
    for j, i in zip(jj, ii):
        target[j, i] = j * imt + i
        q.append((j, i))
    while q:
        j, i = q.popleft()
        for dj, di in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            j2 = j + dj
            i2 = i + di
            if not (0 <= j2 < jmt):
                continue
            if cyclic:
                if i2 == 0:
                    i2 = imt - 2
                elif i2 == imt - 1:
                    i2 = 1
            if not (0 <= i2 < imt):
                continue
            if target[j2, i2] < 0:
                target[j2, i2] = target[j, i]
                q.append((j2, i2))
    # isolated cells drain in place
    unset = target < 0
    flat = np.arange(jmt * imt).reshape(jmt, imt)
    target[unset] = flat[unset]
    return target


def routing_table(target: np.ndarray):
    """(mouths (M,), sources (M, P)): each cell that receives discharge
    and the flat indices of the cells draining to it, padded with the
    index one past the grid (a zero appended to the mass)."""
    flat = target.ravel()
    order = np.argsort(flat, kind="stable")
    mouths, starts, counts = np.unique(flat[order], return_index=True,
                                       return_counts=True)
    table = np.full((mouths.size, counts.max()), flat.size, np.int64)
    for r, (s, c) in enumerate(zip(starts, counts)):
        table[r, :c] = order[s:s + c]
    return mouths, table


class RiverModel:
    def __init__(self, kmt: np.ndarray, area2d, cyclic: bool = True,
                 dtype=torch.float64, device="cpu"):
        target = build_routing(np.asarray(kmt), cyclic)
        mouths, table = routing_table(target)
        self.target = torch.as_tensor(target, device=device)
        self.mouths = torch.as_tensor(mouths, device=device)
        self.sources = torch.as_tensor(table, device=device)
        self.area = torch.as_tensor(np.asarray(area2d), dtype=dtype,
                                    device=device)
        self.shape = kmt.shape

    def discharge(self, runoff):
        """Route land runoff [g/cm^2/s] to ocean discharge [g/cm^2/s]
        (area-conserving segment sum, rivmodel.F ``rivmodel``)."""
        mass = (runoff * self.area).reshape(-1)
        padded = torch.cat([mass, mass.new_zeros(1)])
        per_mouth = padded[self.sources].sum(dim=1)
        out = torch.zeros_like(mass).index_copy(0, self.mouths, per_mouth)
        return out.reshape(self.shape) / (self.area + 1e-30)
