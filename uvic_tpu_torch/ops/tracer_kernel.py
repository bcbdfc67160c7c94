"""Fused FCT tracer step: CUDA kernel wrapper and its plain version.

Counterpart of ``uvic_tpu/ops/pallas_tracer.py`` (the Pallas kernel
``_kernel`` built by ``make_fct_tracer_step``) and of the FCT path of
``uvic_tpu.models.ocean.kernels.tracer_step``.  One call updates every
tracer: FCT dlm1 advection, harmonic horizontal diffusion (flux form
when isopycnal mixing is on), explicit vertical diffusion with
surface/bottom fluxes, the Redi/GM tendency from the 18-slot weight
stack, the source add, the aidif implicit vertical solve and the
setbcx (cyclic, or solid zonal walls).  Reference: source/mom/tracer.F:678-916,
tracer_adv_flx.F:376-1005, invtri.F:1-115.

``TracerStepConsts`` packs the static grid factors once, in the layout
the kernel reads; ``fct_tracer_step`` launches the kernel
(``csrc/tracer_step.cu``: one launch, a block per row and tracer) for
CUDA tensors and takes ``fct_tracer_step_ref`` for CPU tensors;
``tracer_launch`` gives the launch's blocks, threads and shared memory.
"""

from __future__ import annotations

import torch

from ..cuda import LIBRARY, check_cuda, launch, ptr
from .advection import fct_flux
from .stencil import DN, E, N, S, UP, W, setbcx
from .tridiag import invtri_columns

MAX_THREADS = 256           # csrc/tracer_step.cu MAXNT
SMEM_LIMIT = 232448         # bytes of shared memory a block may use


def tracer_launch(nt, km, jmt, imt):
    """(blocks, threads per block, dynamic shared-memory bytes per block)
    of the tracer kernel: a block per (row, tracer), two threads per
    column, and the rolling window of csrc/tracer_step.cu SMEM_ROWS."""
    ncol = -(-imt // 32) * 32
    rows = (5 * (5 + 2 * 4 + 3 * 2)   # tm1, t_tau, tmask, vet/vnt/vbt rings
            + 3 + 2 + 2 * 23          # dcb, source, weight rings
            + 6 * 3                   # jif on rows j-1..j+1
            + 2 * 16                  # fluxes of two levels
            + 2 * 2 * (1 + 3 + 1)     # ratios x, y, z of two levels
            + 2)                      # the second half's tendency terms
    return jmt * nt, 2 * ncol, 4 * (rows * imt + 2 * km * ncol)


class TracerStepConsts:
    """Static factors of the tracer step.

    kfac (6, km): row 0 twodt (filled per call by ``kfac_at`` for the
    plain version; the kernel reads twodt_k itself), 1 dzt2r, 2 dztr,
    3 dzwr at cell bottoms, 4 dztur, 5 dztlr.
    jif (6, jmt, imt): cstdxt2r, cstdyt2r, cstdxtr, ah*cstdxur, and
    (yA, yB) = (ah*csu*dyur, 1/(cst*dyt)) in the flux form, else
    (ahc_north, ahc_south).
    cyclic: the zonal boundary condition (setbcx) of the grid.
    """

    def __init__(self, g, ah, aidif, ydiff_fluxform, has_iso, cyclic=True):
        if has_iso and not ydiff_fluxform:
            raise ValueError("iso weights require flux-form y-diffusion")
        km = g.dzt.shape[0]
        jmt, imt = g.cstdxt2r.shape
        self.aidif = float(aidif)
        self.ydiff_fluxform = bool(ydiff_fluxform)
        self.has_iso = bool(has_iso)
        self.cyclic = bool(cyclic)
        self.kfac = torch.stack([torch.zeros_like(g.dzt2r), g.dzt2r,
                                 g.dztr, g.dzwr[1:], g.dztur, g.dztlr])

        def rows(v):
            return torch.broadcast_to(v[:, None], (jmt, imt))

        if ydiff_fluxform:
            ya, yb = rows(ah * g.csu * g.dyur), rows(1.0 / (g.cst * g.dyt))
        else:
            ya, yb = rows(g.ahc_north), rows(g.ahc_south)
        self.jif = torch.stack([g.cstdxt2r, rows(g.cstdyt2r), g.cstdxtr,
                                ah * g.cstdxur, ya, yb]).contiguous()

    def kfac_at(self, twodt_k):
        kf = self.kfac.clone()
        kf[0] = twodt_k
        return kf


def _iso_tendency(tm, isow, tmask, yb, cstdxtr, dztr):
    """Redi/GM flux divergence from the weight stack (the tracer-side
    half of ``iso_weight_pack``, isopyc.F:889-1065)."""
    tE, tN, tDN = E(tm), N(tm), DN(tm)

    def vd0(f):           # UP(f) - f (weights zero at k=0)
        return UP(f) - f

    def vd1(f):           # f - DN(f) (weights zero at km-1)
        return f - DN(f)

    w = isow[:, None]
    fe = (w[16] * (tE - tm) - w[0] * vd0(tm) - w[1] * vd1(tm)
          - w[2] * vd0(tE) - w[3] * vd1(tE))
    fn = (w[17] * (tN - tm) - w[4] * vd0(tm) - w[5] * vd1(tm)
          - w[6] * vd0(tN) - w[7] * vd1(tN))
    fb = -(w[8] * (tm - W(tm)) + w[9] * (tE - tm)
           + w[10] * (tDN - W(tDN)) + w[11] * (E(tDN) - tDN)
           + w[12] * (tm - S(tm)) + w[13] * (tN - tm)
           + w[14] * (tDN - S(tDN)) + w[15] * (N(tDN) - tDN))
    return ((fe * E(tmask) - W(fe) * W(tmask)) * cstdxtr
            + (fn * N(tmask) - S(fn) * S(tmask)) * yb
            + (UP(fb) - fb) * dztr)


def blocks_per_sm(km, imt):
    """Blocks of the tracer kernel one SM of the card holds at once."""
    n = LIBRARY.get().uvic_fct_tracer_blocks_per_sm(km, imt)
    if n < 0:
        raise RuntimeError(f"uvic_fct_tracer_blocks_per_sm: CUDA error {-n}")
    return n


def fct_tracer_step_ref(consts, t_tau, tm1, vet, vnt, vbt, diff_cbt, stf,
                        btf, source, twodt_k, tmask, kmt, isow=None):
    """Plain PyTorch version of the fused tracer step (any dtype).
    Arguments as ``fct_tracer_step``."""
    km = t_tau.shape[1]
    kf = consts.kfac_at(twodt_k)
    twodt, dzt2r, dztr, dzwr_b = (kf[r].reshape(km, 1, 1) for r in range(4))
    cstdxt2r, cstdyt2r, cstdxtr, ah_cstdxur, ya, yb = consts.jif
    aidif = consts.aidif

    fe, fn, fb = fct_flux(t_tau, tm1, vet, vnt, vbt, tmask, twodt,
                          cstdxt2r, cstdyt2r, dzt2r, consts.cyclic)
    tend = -((fe - W(fe)) * cstdxt2r + (fn - S(fn)) * cstdyt2r
             + (UP(fb) - fb) * dzt2r)

    # harmonic horizontal diffusion (tracer.F:691-798)
    diff_fe = ah_cstdxur * (E(tm1) - tm1)
    tend = tend + (diff_fe * E(tmask) - W(diff_fe) * W(tmask)) * cstdxtr
    if consts.ydiff_fluxform:
        diff_fn = ya * (N(tm1) - tm1)
        tend = tend + (diff_fn * N(tmask) - S(diff_fn) * S(tmask)) * yb
    else:
        tend = tend + (ya * N(tmask) * (N(tm1) - tm1)
                       - yb * S(tmask) * (tm1 - S(tm1)))

    # explicit vertical diffusion through cell bottoms (tracer.F:787-798)
    diff_fb = diff_cbt * dzwr_b * (tm1 - DN(tm1))
    diff_fb[:, -1] = 0.0
    levels = torch.arange(km, device=tm1.device).reshape(km, 1, 1)
    is_bot = (levels == (kmt - 1)[None])[None]
    diff_fb = torch.where(is_bot, btf[:, None], diff_fb)
    fb_above = UP(diff_fb)
    fb_above[:, 0] = stf
    tend = tend + (fb_above - diff_fb) * dztr * (1.0 - aidif)

    if isow is not None:
        tend = tend + _iso_tendency(tm1, isow, tmask, yb, cstdxtr, dztr)
    if source is not None:
        tend = tend + source
    t_new = tm1 + twodt * tend * tmask

    # implicit part of the vertical diffusion (tracer.F:899, ivdift:1691)
    if aidif > 0.0:
        t_new = invtri_columns(t_new, stf, btf, diff_cbt, kf[0], kmt, tmask,
                               kf[2], kf[4], kf[5], aidif)
    return setbcx(t_new, consts.cyclic)


def fct_tracer_step(consts, t_tau, tm1, vet, vnt, vbt, diff_cbt, stf, btf,
                    source, twodt_k, tmask, kmt, isow=None):
    """One tracer timestep for all tracers, with the zonal boundary
    condition of ``consts.cyclic``.

    t_tau, tm1, source : (nt, km, jmt, imt); source may be None
    vet/vnt/vbt        : (km, jmt, imt) total advective velocities
    diff_cbt, tmask    : (km, jmt, imt)
    stf, btf           : (nt, jmt, imt) surface/bottom fluxes
    twodt_k            : (km,) leapfrog interval x dtxcel
    kmt                : (jmt, imt) int
    isow               : (18, km, jmt, imt) Redi/GM weight stack or None
    returns t at tau+1 (before convection/filtering).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 only).
    """
    if t_tau.device.type == "cpu":
        return fct_tracer_step_ref(consts, t_tau, tm1, vet, vnt, vbt,
                                   diff_cbt, stf, btf, source, twodt_k,
                                   tmask, kmt, isow)
    nt, km, jmt, imt = t_tau.shape
    if (isow is not None) != consts.has_iso:
        raise ValueError("fct_tracer_step: isow does not match consts")
    f4, f3, f2 = t_tau.shape, (km, jmt, imt), (nt, jmt, imt)
    check_cuda("fct_tracer_step", dict(
        t_tau=(t_tau, f4), tm1=(tm1, f4), source=(source, f4),
        vet=(vet, f3), vnt=(vnt, f3), vbt=(vbt, f3), diff_cbt=(diff_cbt, f3),
        tmask=(tmask, f3), stf=(stf, f2), btf=(btf, f2),
        isow=(isow, (18,) + f3), twodt_k=(twodt_k, (km,)),
        kfac=(consts.kfac, (6, km)),
        jif=(consts.jif, (6, jmt, imt))))
    check_cuda("fct_tracer_step", dict(kmt=(kmt, (jmt, imt))),
               dtype=torch.int32)
    _, threads, smem = tracer_launch(nt, km, jmt, imt)
    if threads > MAX_THREADS or smem > SMEM_LIMIT:
        raise ValueError(f"fct_tracer_step: {imt} columns need {threads} "
                         f"threads and {smem} bytes of shared memory")
    out = torch.empty_like(t_tau)
    launch("uvic_fct_tracer_step", ptr(t_tau), ptr(tm1), ptr(vet), ptr(vnt),
           ptr(vbt), ptr(tmask), ptr(diff_cbt), ptr(stf), ptr(btf),
           ptr(source), ptr(isow), ptr(twodt_k), ptr(consts.kfac),
           ptr(consts.jif), ptr(kmt),
           ptr(out), nt, km, jmt, imt, consts.aidif,
           int(consts.ydiff_fluxform), int(consts.cyclic))
    fct_tracer_step.launches += 1
    return out


fct_tracer_step.launches = 0
