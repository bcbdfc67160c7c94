"""Convective adjustment: complete (O_fullconvect) and the standard
alternating-pair scheme, torch.

``convct_ncon`` ports the standard scheme of ``uvic_tpu.ops.convection``
(convect.F:1-97): ``ncon`` passes of pair mixing in alternating parity,
vectorized over all columns.  ``convct_full`` ports ``convct_full`` (convct2,
convect.F:99-311, Rahmstorf 1993): every level starts as its own region,
adjacent regions merge wherever their thickness-weighted means are
statically unstable at the interface, and the merging iterates to a
fixed point.  Mixing is linear averaging with fixed weights, so the
result is a per-cell matrix M[k, l] (the normalised region membership)
applied to every tracer.

``apply_region_means`` is the CUDA kernel that applies M
(``csrc/convect_apply.cu``, replacing the Pallas kernel
``_apply_region_means_pallas``: M read once per call into registers,
tracer tiles staged in shared memory by asynchronous copies);
``region_means_launch`` gives its geometry and
``apply_region_means_ref`` is its plain PyTorch version.  Stability
comparisons use the EOS coefficients of the upper level of the lower
region (convect.F:201-204,232-235).
"""

from __future__ import annotations

import torch

from ..cuda import LIBRARY, check_cuda, launch, ptr
from .eos import dens

MAX_KM = 64             # csrc/convect_apply.cu MAX_KM: M's row in registers
MAX_THREADS = 512       # csrc/convect_apply.cu MAX_THREADS
STAGES = 8              # csrc/convect_apply.cu STAGES: slots of the ring


def _region_means(ts, label, w):
    """Thickness-weighted mean of each level's region, from the original
    profile. label[k] = index of the region's top level (non-decreasing)."""
    same = (label[:, None] == label[None, :]).to(ts.dtype)  # (k,l,j,i)
    wfull = torch.broadcast_to(w, ts.shape[1:])
    sum_tw = torch.einsum("kl...,nl...->nk...", same, ts * w)
    sum_w = torch.einsum("kl...,l...->k...", same, wfull)
    return sum_tw / sum_w


def _pair_density(eos_c, eos_to, eos_so, t, s):
    """Densities of levels k and k+1 both referenced to level k+1's
    coefficients, for all k (statec, state.F:64-131)."""
    c_dn = eos_c[1:][:, None, None, :]
    to_dn = eos_to[1:][:, None, None]
    so_dn = eos_so[1:][:, None, None]
    return (dens(c_dn, t[:-1] - to_dn, s[:-1] - so_dn),
            dens(c_dn, t[1:] - to_dn, s[1:] - so_dn))


def convct_ncon(ts, kmt, eos_c, eos_to, eos_so, dztxcl, ncon: int):
    """Standard convection scheme: ``ncon`` passes of alternating-parity
    pair mixing (convect.F:52-89).  ts is (nt, km, jmt, imt) with
    T = ts[0], S = ts[1]; returns the adjusted tracers."""
    km = ts.shape[1]
    w = dztxcl.reshape(km, 1, 1)
    kk = torch.arange(km - 1, device=ts.device).reshape(km - 1, 1, 1)
    below_ocean = kk + 1 < kmt[None]

    def one_phase(ts, parity):
        rho_up, rho_dn = _pair_density(eos_c, eos_to, eos_so, ts[0], ts[1])
        unstable = (rho_up > rho_dn) & (kk % 2 == parity) & below_ocean
        mixed = (w[:-1] * ts[:, :-1] + w[1:] * ts[:, 1:]) / (w[:-1] + w[1:])
        # a level is either the upper or the lower member of a pair in one
        # parity phase, never both: apply both writes as one select
        pad = torch.zeros_like(unstable[:1])
        as_up = torch.cat([unstable, pad], dim=0)[None]
        as_dn = torch.cat([pad, unstable], dim=0)[None]
        padm = mixed[:, :1]
        mix_up = torch.cat([mixed, padm], dim=1)
        mix_dn = torch.cat([padm, mixed], dim=1)
        return torch.where(as_up, mix_up, torch.where(as_dn, mix_dn, ts))

    for _ in range(ncon):
        for parity in (0, 1):
            ts = one_phase(ts, parity)
    return ts


def _stable_labels(ts, kmt, eos_c, eos_to, eos_so, dztxcl):
    """Fixed-point region labels of the complete-removal scheme:
    label[k] = top level index of the statically-stable mixed region
    containing level k.

    A column needs at most km-1 merges, and once the labels stop changing
    a pass is the identity, so exactly km passes reach the fixed point
    that ``uvic_tpu``'s data-dependent ``while_loop`` (max km trips)
    stops at, with no host-side convergence check."""
    km = ts.shape[1]
    w = dztxcl.reshape(km, 1, 1)
    idx = torch.arange(km, device=ts.device).reshape(km, 1, 1)
    ocean = idx < kmt[None]
    to = eos_to[:, None, None]
    so = eos_so[:, None, None]
    cc = eos_c[:, None, None, :]
    label = torch.broadcast_to(idx, ts.shape[1:]).clone()
    for _ in range(km):
        means = _region_means(ts[:2], label, w)    # (2, km, j, i)
        # interface above level s (s = region start > 0): upper region
        # mean is at s-1, lower at s; reference coefficients of level s
        mt_up = torch.cat([means[0, :1], means[0, :-1]], dim=0)
        ms_up = torch.cat([means[1, :1], means[1, :-1]], dim=0)
        rho_up = dens(cc, mt_up - to, ms_up - so)
        rho_dn = dens(cc, means[0] - to, means[1] - so)
        unstable = (rho_up > rho_dn) & ocean & (idx > 0)
        new_start = (label == idx) & ~unstable
        new_start[0] = True
        label = torch.cummax(torch.where(new_start, idx, -1), dim=0).values
    return label


def region_reference(mnorm):
    """(km, jmt, imt) index of each level's reference level: the first l
    with M[k, l] != 0, the top of the level's mixed region (k itself where
    the row is zero, on land)."""
    nz = mnorm != 0
    km = mnorm.shape[0]
    own = torch.arange(km, device=mnorm.device).reshape(km, 1, 1)
    return torch.where(nz.any(1), nz.to(mnorm.dtype).argmax(1),
                       own.expand(mnorm.shape[1:]).clone())


def apply_region_means_ref(ts, mnorm, ocean):
    """Plain version of the kernel, in its summation order: on ocean
    cells out[n, k] = r + sum_l M[k, l] (ts[n, l] - r), with r the
    tracer at the top of k's region (``region_reference``); ts
    elsewhere.  With M's rows summing to one this is sum_l M[k, l]
    ts[n, l], but a row's float32 sum misses one by a rounding, the same
    in a column at every step, which applied to the whole value drifts
    the mixed tracers (~8e-8 K a step in the flagship's mean SST);
    against r it weighs only the spread within the region, and every
    level of a region computes the same numbers, so that the region
    stays homogeneous."""
    lref = region_reference(mnorm)
    r = torch.gather(ts, 1, lref[None].expand(ts.shape[0], -1, -1, -1))
    out = mnorm[:, 0][None] * (ts[:, 0][:, None] - r)
    for l in range(1, ts.shape[1]):
        out = out + mnorm[:, l][None] * (ts[:, l][:, None] - r)
    return torch.where(ocean[None] > 0, r + out, ts)


def region_means_launch(nt, km, jmt, imt):
    """(blocks, columns per block, slots, dynamic shared-memory bytes) of
    the region-mean kernel: a block per tile of ``columns`` cells of the
    plane at every level (columns x km threads, at most MAX_THREADS) and
    a ring of ``slots`` tracer tiles (STAGES, fewer when nt is smaller),
    each held column by column at the kernel's column stride."""
    if not 1 <= km <= MAX_KM:
        raise ValueError(f"apply_region_means: {km} levels, the kernel "
                         f"takes 1 to {MAX_KM}")
    cols = next(c for c in (32, 16, 8) if c * km <= MAX_THREADS)
    slots = min(nt, STAGES)
    return (-(-jmt * imt // cols), cols, slots,
            4 * slots * cols * column_stride(km))


def column_stride(km):
    """Floats between two columns of a staged tile (csrc/convect_apply.cu
    stride<KMAX>, KMAX = km rounded up to a multiple of 4): 4 mod 8, so
    that the 16-byte loads of 8 lanes fall in distinct banks."""
    kmax = -(-km // 4) * 4
    return kmax if kmax % 8 == 4 else kmax + 4


def region_means_blocks_per_sm(nt, km, cols):
    """Blocks of the region-mean kernel one SM of the card holds at once."""
    n = LIBRARY.get().uvic_region_means_blocks_per_sm(nt, km, cols)
    if n < 0:
        raise RuntimeError(f"uvic_region_means_blocks_per_sm: CUDA error {-n}")
    return n


def apply_region_means(ts, mnorm, ocean):
    """Apply the region-mixing matrix to all tracers.

    ts (nt, km, jmt, imt), mnorm (km, km, jmt, imt), ocean (km, jmt, imt).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes 1 to MAX_KM levels (ValueError otherwise).
    """
    if ts.device.type == "cpu":
        return apply_region_means_ref(ts, mnorm, ocean)
    nt, km, jmt, imt = ts.shape
    check_cuda("apply_region_means", dict(
        ts=(ts, None), mnorm=(mnorm, (km, km, jmt, imt)),
        ocean=(ocean, (km, jmt, imt))))
    _, cols, _, smem = region_means_launch(nt, km, jmt, imt)
    out = torch.empty_like(ts)
    launch("uvic_region_means_apply", ptr(ts), ptr(mnorm), ptr(ocean),
           ptr(out), nt, km, jmt * imt, cols, smem)
    apply_region_means.launches += 1
    return out


apply_region_means.launches = 0


def region_mixing_matrix(ts, kmt, eos_c, eos_to, eos_so, dztxcl):
    """M[k, l, j, i]: weight of level l in the mixed value of level k."""
    km = ts.shape[1]
    label = _stable_labels(ts, kmt, eos_c, eos_to, eos_so, dztxcl)
    same = (label[:, None] == label[None, :]).to(ts.dtype)
    wfull = torch.broadcast_to(dztxcl.reshape(km, 1, 1), ts.shape[1:])
    sum_w = torch.einsum("kl...,l...->k...", same, wfull)
    return same * wfull[None] / sum_w[:, None]


def convct_full(ts, kmt, eos_c, eos_to, eos_so, dztxcl):
    """Complete convective adjustment (convct2 fixed point): every
    column's final profile is statically stable.  ts is
    (nt, km, jmt, imt) with T = ts[0], S = ts[1]."""
    km = ts.shape[1]
    idx = torch.arange(km, device=ts.device).reshape(km, 1, 1)
    ocean = torch.broadcast_to((idx < kmt[None]).to(ts.dtype),
                               ts.shape[1:]).contiguous()
    mnorm = region_mixing_matrix(ts, kmt, eos_c, eos_to, eos_so, dztxcl)
    return apply_region_means(ts.contiguous(), mnorm.contiguous(), ocean)


def convct_brine(ts, cbf, cba, cba0, kmt, eos_c, eos_to, eos_so, dztxcl,
                 c2dtts, zw0, dtxcel0=1.0):
    """Brine-rejection convection (convect_brine.F:1-101,
    O_convect_brine), as ``uvic_tpu.ops.convection.convct_brine``.

    Under each ice category nc the category's brine salt flux ``cbf[nc]``
    [salt-unit cm/s] enters the surface level (the reference's
    density-contrast spreading depth is off, cont=0, convect_brine.F:45),
    complete convection runs on the perturbed profile, and the result is
    the area-weighted mean of the convected profiles; the ice-free part
    ``cba0`` convects unperturbed.  Each of the 1 + ncat convections
    applies its region means through ``apply_region_means`` (the kernel
    on the card): three an ocean step with the coupler's two categories.

    ts   : (nt, km, jmt, imt) tracers at tau+1 (before convection)
    cbf  : (ncat, jmt, imt) per-category brine fluxes (index 0 = open
           water / lead ice growth)
    cba  : (ncat, jmt, imt) per-category area weights
    cba0 : (jmt, imt) ice-free weight; cba0 + sum(cba) = 1
    zw0  : depth of the bottom of level 1 [cm]
    """
    out = cba0[None, None] * convct_full(ts, kmt, eos_c, eos_to, eos_so,
                                         dztxcl)
    fac = c2dtts * dtxcel0 / zw0
    for nc in range(cbf.shape[0]):
        tsp = ts.clone()
        tsp[1, 0] = ts[1, 0] + fac * cbf[nc]
        out = out + cba[nc][None, None] * convct_full(
            tsp, kmt, eos_c, eos_to, eos_so, dztxcl)
    return out


def convection_extent(ts, kmt, eos_c, eos_to, eos_so, dztxcl, dzt):
    """Diagnostic: (depth_cm, nregions) of convective mixing per column
    (mom_tavg.F O_save_convection rows).

    depth_cm  : thickness of the surface-connected mixed region
    nregions  : number of distinct stable regions above the bottom (a
                fully stratified column returns its ocean level count)
    """
    km = ts.shape[1]
    label = _stable_labels(ts, kmt, eos_c, eos_to, eos_so, dztxcl)
    idx = torch.arange(km, device=ts.device).reshape(km, 1, 1)
    ocean = idx < kmt[None]
    in_surf = (label == 0) & ocean
    depth = torch.sum(in_surf * dzt.reshape(km, 1, 1), dim=0)
    nreg = torch.sum((label == idx) & ocean, dim=0)
    return depth, nreg
