"""Topography, land/sea masks, and island (land-mass) labeling.

Topography of the PyTorch port (source/common/topog.F, isleperim.F).  The
reference's interactive flood-fill + kmt-repair machinery becomes a small
host-side NumPy/SciPy pass producing:

- ``kmt``/``kmu``: number of ocean levels at T/U cells (0 = land),
- ``tmask``/``umask``: (km, jmt, imt) {0,1} masks,
- ``hr``/``h``: reciprocal/total depth at U cells (emode.h analogs),
- a dense island labeling: ``land_map`` (label per land mass, 0 = ocean)
  and ``perim_id`` (island index per ocean perimeter cell, -1 elsewhere)
  with per-island counts.  The dense index maps replace the reference's
  iperm/jperm/iofs perimeter lists (isleperim.F:1-829): island segment
  sums are reductions over the cells of one perimeter id.

All one-time host-side NumPy work; the model turns the outputs into
device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import ndimage

from .grid import Grid


@dataclass(frozen=True)
class Topography:
    kmt: np.ndarray        # (jmt, imt) int
    kmu: np.ndarray        # (jmt, imt) int
    tmask: np.ndarray      # (km, jmt, imt) float {0,1}
    umask: np.ndarray      # (km, jmt, imt) float {0,1}
    h: np.ndarray          # (jmt, imt) depth at U cells [cm]
    hr: np.ndarray         # (jmt, imt) 1/depth at U cells, 0 on land
    ht: np.ndarray         # (jmt, imt) depth at T cells [cm]
    # island machinery
    nisle: int
    land_map: np.ndarray   # (jmt, imt) int, land mass label 1..nisle, 0=ocean
    perim_id: np.ndarray   # (jmt, imt) int, island index 0..nisle-1 or -1
    perim_count: np.ndarray  # (nisle,) number of perimeter cells per island
    imain: int             # index (0-based) of largest land mass, psi normalized there


def _cyclic_wrap(a: np.ndarray) -> np.ndarray:
    """Apply zonal cyclic condition to boundary columns (util.F:789-815)."""
    a = a.copy()
    a[..., 0] = a[..., -2]
    a[..., -1] = a[..., 1]
    return a


def idealized_kmt(grid: Grid, kind: str = "world") -> np.ndarray:
    """Generate an idealized kmt field (the O_idealized_kmt path).

    kind:
      "box"   — flat-bottom closed basin (classic Bryan-Cox box)
      "world" — flat-bottom aqua-planet with two meridional continents and
                a circumpolar channel; exercises islands + cyclic seam
    """
    jmt, imt, km = grid.jmt, grid.imt, grid.km
    kmt = np.full((jmt, imt), km, dtype=np.int32)
    # solid meridional walls
    kmt[0, :] = 0
    kmt[-1, :] = 0
    if kind == "box":
        # a closed basin: zonal walls override the cyclic condition
        kmt[:, 0] = 0
        kmt[:, -1] = 0
        return kmt
    elif kind == "world":
        # "antarctica": polar land attached to the southern boundary row
        ant_top = max(1, jmt // 16)
        kmt[:ant_top + 1, :] = 0
        # circumpolar channel of >= 2 ocean rows, then the continents
        j_ant = ant_top + 3
        # "americas": a meridional continent spanning most latitudes
        i1 = imt // 4
        i2 = i1 + max(2, imt // 16)
        kmt[j_ant:-1, i1:i2] = 0
        # "eurasia/africa": second continent, different latitude span
        i3 = (2 * imt) // 3
        i4 = i3 + max(2, imt // 12)
        kmt[max(j_ant, jmt // 3):-1, i3:i4] = 0
        # an island in the remaining ocean
        jc, ic = (2 * jmt) // 3, imt // 2
        kmt[jc:jc + 2, ic:ic + 2] = 0
    else:
        raise ValueError(kind)
    if grid.cyclic:
        kmt = _cyclic_wrap(kmt)
    return kmt


def kmt_from_depth(grid: Grid, depth_cm: np.ndarray,
                   min_levels: int = 2) -> np.ndarray:
    """Convert a T-cell depth field [cm] to kmt (topog.F behavior):
    number of whole levels shallower than the depth; ocean columns get at
    least ``min_levels`` levels; depths < half the first level are land."""
    kmt = np.searchsorted(grid.zw, depth_cm, side="right").astype(np.int32)
    shallow = depth_cm < 0.5 * grid.zw[0]
    kmt = np.where(shallow, 0, np.maximum(kmt, min_levels))
    kmt[0, :] = 0
    kmt[-1, :] = 0
    if grid.cyclic:
        kmt = _cyclic_wrap(kmt)
    return kmt


def _label_land(kmt: np.ndarray, cyclic: bool):
    """8-connected land-mass labeling with cyclic-seam merging
    (isleperim.F `expand` flood fill equivalent)."""
    land = kmt == 0
    structure = np.ones((3, 3), dtype=bool)   # diagonal adjacency connects
    labels, n = ndimage.label(land, structure=structure)
    if cyclic and n > 1:
        # merge labels connected across the zonal seam: interior columns
        # 1 and imt-2 are physically adjacent (boundary columns mirror them)
        parent = np.arange(n + 1)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

        left = labels[:, 1]
        right = labels[:, -2]
        jmt = labels.shape[0]
        for j in range(jmt):
            for dj in (-1, 0, 1):
                jj = j + dj
                if 0 <= jj < jmt and left[j] > 0 and right[jj] > 0:
                    union(left[j], right[jj])
        remap = np.zeros(n + 1, dtype=labels.dtype)
        roots = sorted({find(x) for x in range(1, n + 1)})
        for new, root in enumerate(roots, start=1):
            remap[root] = new
        for x in range(1, n + 1):
            remap[x] = remap[find(x)]
        labels = remap[labels]
        n = len(roots)
    return labels, n


def set_kmt_region(kmt: np.ndarray, grid: Grid, alat1: float,
                   slon1: float, elon1: float, alat2: float,
                   slon2: float, elon2: float, num: int) -> np.ndarray:
    """Set kmt = ``num`` inside the parallelogram with vertices
    (alat1, slon1), (alat1, elon1), (alat2, slon2), (alat2, elon2)
    (source/mom/setkmp.F:1-63), the topography edit that carves
    idealized basins and straits.  The longitude bounds interpolate
    linearly between the two latitude rows.  Returns a modified copy."""
    yt = np.asarray(grid.yt)
    xt = np.asarray(grid.xt) % 360.0
    j1 = int(np.argmin(np.abs(yt - alat1)))
    j2 = int(np.argmin(np.abs(yt - alat2)))
    js, je = min(j1, j2), max(j1, j2)
    out = np.array(kmt)
    denom = max(je - js, 1)
    for j in range(js, je + 1):
        w = (j - js) / denom
        slon = slon1 + w * (slon2 - slon1)
        elon = elon1 + w * (elon2 - elon1)
        i1 = int(np.argmin(np.abs(xt - slon % 360.0)))
        i2 = int(np.argmin(np.abs(xt - elon % 360.0)))
        is_, ie = min(i1, i2), max(i1, i2)
        out[j, is_:ie + 1] = num
    return out


def make_topography(grid: Grid, kmt: np.ndarray) -> Topography:
    jmt, imt, km = grid.jmt, grid.imt, grid.km
    kmt = np.asarray(kmt, dtype=np.int32)

    # kmu: B-grid U cell exists only where all 4 surrounding T cells do
    kmu = np.zeros_like(kmt)
    kmu[:-1, :-1] = np.minimum.reduce([
        kmt[:-1, :-1], kmt[:-1, 1:], kmt[1:, :-1], kmt[1:, 1:]])
    if grid.cyclic:
        kmu = _cyclic_wrap(kmu)

    kk = np.arange(km)[:, None, None]
    tmask = (kk < kmt[None]).astype(np.float64)
    umask = (kk < kmu[None]).astype(np.float64)

    # depth and reciprocal depth at U cells (setmom.F hr/h)
    h = np.einsum("k,kji->ji", grid.dzt, umask)
    with np.errstate(divide="ignore"):
        hr = np.where(h > 0, 1.0 / np.maximum(h, 1e-30), 0.0)
    ht = np.einsum("k,kji->ji", grid.dzt, tmask)

    # island labeling + perimeters.  Land masses whose ocean perimeters
    # COLLIDE (separated by a 1-cell channel) are MERGED into one
    # constraint: a shared perimeter cell cannot satisfy two island
    # integrals, and the reference handles such geometries by editing
    # kmt until they vanish (isleperim.F kmt-repair); constraining both
    # masses to one psi constant is the equivalent no-net-transport
    # condition through the unresolvable channel.
    land_map, nisle = _label_land(kmt, grid.cyclic)
    ocean = kmt > 0

    def perimeter_of(mask):
        grown = ndimage.binary_dilation(mask, structure=np.ones((3, 3)))
        if grid.cyclic:
            seamL = ndimage.binary_dilation(
                mask[:, -2:-1], structure=np.ones((3, 1)))[:, 0]
            seamR = ndimage.binary_dilation(
                mask[:, 1:2], structure=np.ones((3, 1)))[:, 0]
            grown[:, 1] |= seamL
            grown[:, -2] |= seamR
        perim = grown & ocean
        # each physical cell appears exactly once: the duplicated cyclic
        # boundary columns must not carry perimeter entries, or island
        # segment sums double-count and the CG island equations break
        perim[:, 0] = False
        perim[:, -1] = False
        return perim

    for _ in range(nisle):
        perim_id = np.full((jmt, imt), -1, dtype=np.int32)
        merge = {}
        for isle in range(1, nisle + 1):
            perim = perimeter_of(land_map == isle)
            clash = np.unique(perim_id[perim & (perim_id >= 0)])
            for other in clash:
                merge[isle] = int(other) + 1
            perim_id[perim] = isle - 1
        if not merge:
            break
        for a, b in merge.items():
            land_map[land_map == a] = b
        # compact labels 1..n
        labels = np.unique(land_map[land_map > 0])
        relab = np.zeros(land_map.max() + 1, dtype=np.int32)
        relab[labels] = np.arange(1, labels.size + 1)
        land_map = np.where(land_map > 0, relab[land_map], 0)
        nisle = labels.size
    counts = np.bincount(perim_id[perim_id >= 0], minlength=max(nisle, 1))

    sizes = np.bincount(land_map[land_map > 0], minlength=nisle + 1)
    imain = int(np.argmax(sizes[1:])) if nisle > 0 else -1

    return Topography(
        kmt=kmt, kmu=kmu, tmask=tmask, umask=umask,
        h=h, hr=hr, ht=ht,
        nisle=nisle, land_map=land_map, perim_id=perim_id,
        perim_count=counts.astype(np.int32), imain=imain,
    )
