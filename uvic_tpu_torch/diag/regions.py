"""Named horizontal/vertical region machinery (setcom.F:210-317), torch.

Port of ``uvic_tpu.diag.regions``.  The reference reads an integer
horizontal region-id map (mskhr, G_mskhreg.nc) and builds vertical
region ids (mskvr) by fitting depth ranges to model levels (setvr);
regional tracer budgets (tbt.F, termbal.F) and averages then reduce over
the product of horizontal x vertical regions, with precomputed region
volumes/areas (cregin.h volbk/volbt/areab).

The region-id map is authored from the same basin geometry the earth
configuration uses (the reference's data file is not shipped), vertical
regions use the setvr nearest-level fit, and the reductions are dense
one-hot einsums on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device


@dataclass(frozen=True)
class Regions:
    """Region bookkeeping (cregin.h analog); tensors on one device."""
    hregnm: Tuple[str, ...]     # horizontal region names
    vregnm: Tuple[str, ...]     # vertical region names
    mskhr: torch.Tensor         # (jmt, imt) int, 0 = no region
    mskvr: torch.Tensor         # (km,) int, 0 = no region
    hmask: torch.Tensor         # (nhreg, jmt, imt) float one-hot
    vmask: torch.Tensor         # (nvreg, km) float one-hot
    areab: torch.Tensor         # (nhreg,) region areas [cm^2]
    volbk: torch.Tensor         # (nhreg, km) region volume per level
    volbt: torch.Tensor         # (nhreg,) total region volumes
    dvol: torch.Tensor          # (km, jmt, imt) ocean cell volumes

    @property
    def nhreg(self):
        return len(self.hregnm)

    @property
    def nvreg(self):
        return len(self.vregnm)

    def volume_mean(self, field):
        """(nhreg, nvreg) volume-weighted mean of a (km, jmt, imt)
        field over every horizontal x vertical region combination
        (region.F averages)."""
        wk = torch.einsum("rji,kji->rk", self.hmask, self.dvol)
        num = torch.einsum("rji,kji,kji->rk", self.hmask, self.dvol, field)
        numv = torch.einsum("rk,vk->rv", num, self.vmask)
        denv = torch.clamp(torch.einsum("rk,vk->rv", wk, self.vmask),
                           min=1e-30)
        return numv / denv


def setvr(zw_cm, bounds_cm: Sequence[Tuple[float, float]]):
    """Fit vertical regions to the nearest model levels
    (setcom.F:241-270 setvr): level k belongs to region n when its
    bottom depth zw(k) falls inside (start, end]."""
    km = len(zw_cm)
    mskvr = np.zeros(km, dtype=np.int32)
    for n, (z0, z1) in enumerate(bounds_cm, start=1):
        for k in range(km):
            if z0 < zw_cm[k] <= z1:
                mskvr[k] = n
    return mskvr


def _basin_id_map(grid) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Horizontal region ids from the coarse basin geometry
    (G_mskhreg analog authored in-repo): 1 Southern, 2 Atlantic,
    3 Pacific, 4 Indian, 5 Arctic."""
    lon = np.asarray(grid.xt)[None, :] % 360.0
    lat = np.asarray(grid.yt)[:, None]
    LON = np.broadcast_to(lon, (grid.jmt, grid.imt))
    LAT = np.broadcast_to(lat, (grid.jmt, grid.imt))
    ids = np.zeros((grid.jmt, grid.imt), dtype=np.int32)
    ids[LAT[:, 0] <= -34.0, :] = 1                      # Southern
    mid = (LAT > -34.0) & (LAT < 66.0)
    west_atl = np.where(LAT > 18.0, 262.0, 290.0)
    atl = mid & (((LON >= west_atl) & (LON < 360.0)) | (LON < 20.0))
    atl &= ~((LON >= 260.0) & (LON < 285.0) & (LAT < 8.0))
    ids[atl] = 2
    pac = mid & (LON >= 105.0) & (LON < west_atl) & ~atl
    ids[pac] = 3
    ind = mid & (LON >= 20.0) & (LON < 105.0) & (LAT < 30.0)
    ids[ind] = 4
    # Mediterranean/Black-Sea band drains to the Atlantic (the
    # reference's G_mskhreg groups marginal seas with their basin)
    med = mid & (ids == 0) & (LON >= 0.0) & (LON < 60.0) & (LAT >= 28.0)
    ids[med] = 2
    # any remaining unassigned mid-latitude cells join the Pacific
    ids[mid & (ids == 0)] = 3
    ids[(LAT >= 66.0)] = 5                              # Arctic
    return ids, ("Southern", "Atlantic", "Pacific", "Indian", "Arctic")


def build_regions(grid, kmt, mskhr=None, hregnm=None,
                  vbounds_cm=None, vregnm=None,
                  dtype=np.float64, device=None) -> Regions:
    """Assemble Regions for a model grid (setcom.F:210-317), on
    ``device`` (``cuda`` unless the caller says otherwise).

    mskhr/hregnm override the authored basin map (the reference reads
    G_mskhreg.nc); vbounds_cm are (start, end] depth ranges in cm
    (setvr), default upper(0-1000m)/deep(1000m-bottom)."""
    device = resolve_device(device)
    kmt = np.asarray(kmt)
    if mskhr is None:
        mskhr, hregnm = _basin_id_map(grid)
    mskhr = np.where(kmt > 0, mskhr, 0).astype(np.int32)
    zw = np.asarray(grid.zw)[:grid.km]
    if vbounds_cm is None:
        vbounds_cm = [(0.0, 1000.0e2), (1000.0e2, float(zw[-1]) + 1.0)]
        vregnm = ("upper 1000m", "deep")
    mskvr = setvr(zw, vbounds_cm)

    nh, nv = len(hregnm), len(vregnm)
    hmask = np.zeros((nh,) + mskhr.shape)
    for r in range(nh):
        hmask[r] = (mskhr == r + 1)
    vmask = np.zeros((nv, grid.km))
    for v in range(nv):
        vmask[v] = (mskvr == v + 1)

    area = (np.asarray(grid.cst)[:, None] * np.asarray(grid.dyt)[:, None]
            * np.asarray(grid.dxt)[None, :])
    area[:, 0] = 0.0
    area[:, -1] = 0.0
    tmask3 = (np.arange(grid.km)[:, None, None] < kmt[None])
    dvol = (np.asarray(grid.dzt)[:, None, None] * area[None]) * tmask3
    areab = np.einsum("rji,ji->r", hmask, area * (kmt > 0))
    volbk = np.einsum("rji,kji->rk", hmask, dvol)
    volbt = volbk.sum(axis=1)

    def tn(x):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    return Regions(
        hregnm=tuple(hregnm), vregnm=tuple(vregnm),
        mskhr=torch.as_tensor(mskhr, device=device),
        mskvr=torch.as_tensor(mskvr, device=device),
        hmask=tn(hmask), vmask=tn(vmask), areab=tn(areab), volbk=tn(volbk),
        volbt=tn(volbt), dvol=tn(dvol))
