"""The rank-decomposed ocean step with ONE aggregated halo exchange.

Port of ``uvic_tpu.parallel.shard_step`` onto ``torch.distributed``.
Each rank holds one block of the (y, x) mesh (``mesh.RankMesh``).  All
stencil-consuming state is packed into a single array, halo-exchanged
once per step (``halo.pack_exchange``), and the port's unchanged
whole-domain functions (full velocities, ``adv_vel``, isopycnal/GM,
tidal kv, the generic ``tracer_step``, ``clinic_step``) run on the
halo-padded local block.  The halo covers the stencil composition depth
(``required_halo``), so every kept cell computes the global answer; the
frame computes garbage and is cropped.

The phases that the reference runs on the global array under GSPMD get
the communication they need here:

- the sources (NPZD/MOBI, shortwave, geothermal heat) and convection
  (full, ncon, brine) are column-local: each rank runs them on its block
  (convection's region-mean apply, B3, on the card);
- the high-latitude filters take whole rows: the filtered rows of a
  block are gathered along its x ring, filtered, and each rank keeps
  its own columns;
- the ghost and image columns of the window are copied from the real
  columns they mirror (``setbcx`` and ``halo.pad_window`` on the global
  array) by an exchange between the first and the last rank of each x
  ring, and the rows beyond the wall are zeroed: before convection, as
  ``tracer_step`` and ``clinic_step`` leave the global fields, and after
  the filters;
- the barotropic solve runs REPLICATED: the forcing ``zu`` is gathered
  from every rank and ``tropic_step`` (its CG, B2, on the card) runs
  identically everywhere, as the reference does (a sharded CG would
  issue hundreds of latency-bound reductions, and the near-null modes
  of the streamfunction operator amplify reduction-order differences).
  psi0, psi1, ptd and ptdb stay replicated between steps.

The core takes the generic ``tracer_step`` (never the fused tracer
step, B1), as the reference's does: its fused Pallas step exists only
on a (1, 1) mesh.  The step is eager; host-staged messages cannot be
captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from ..checks import ConfigError
from ..config import BarotropicMode, Convection
from ..core.state import OceanState
from ..models.ocean.kernels import adv_vel, clinic_step, tracer_step
from ..models.ocean.model import eos_state_from
from ..models.ocean.tropic import ext_mode_velocity, tropic_step
from ..ops.convection import convct_brine, convct_full, convct_ncon
from ..ops.stencil import setbcx
from .halo import (BAG_AXES, ExtendedStatics, crop, pack, pack_exchange,
                   pad_zeros, unpack)
from .mesh import gather_field, local_block, padded_window

# message tags of the filters' row gathers and the column fix-up
TAG_FILT_T, TAG_FILT_U, TAG_IMAGES, TAG_GHOST = 11, 12, 13, 14


class ShardedOceanStep:
    """Wraps an ``OceanModel`` with the rank-decomposed step.

    Support matrix (the reference's ``ShardedOceanStep`` refuses the
    same options; the port raises ``ConfigError`` naming them):

    | concern            | supported               | refused           |
    |--------------------|-------------------------|-------------------|
    | barotropic         | streamfunction, 5-point | surface pressure, |
    |                    | (acor)                  | free surface,     |
    |                    |                         | 9-point           |
    | vmix               | const / bryan_lewis     | ppmix             |
    |                    | (+tidal_kv)             |                   |
    | hmix               | const / aniso /         | smagnl            |
    |                    | biharmonic              |                   |
    | tracer advection   | centered/upstream/FCT   | quicker           |
    | isopycnal/GM       | small-angle, full tensor|                   |
    | domain             | cyclic                  | walls             |
    | mixing step        | forward                 | Euler-backward    |

    ``halo=None`` derives the width from the configured stencil depth
    (``required_halo``).  Polar bottom drag, Neptune, the full tensor and
    brine convection are computed as ``OceanModel._step`` computes them
    (the reference's sharded core leaves the first three out).
    Euler-backward mixing and the 9-point operator, which the
    reference's sharded step takes without a word but computes otherwise
    than its ``_step``, are refused.
    """

    @staticmethod
    def required_halo(cfg) -> int:
        """Halo width from the configured stencil composition depth —
        the size.h:80-100 jmw law recast for one aggregated exchange
        per FULL step (every kernel between exchanges consumes stencil
        cells from the same padded block, so depths ADD):

          full_velocity(ext-mode diag diff)          1
          adv_vel (vet/vnt -> vbt -> veu/vnu/vbu)    2
          advective flux + divergence                2  (FCT: +2 for
                                                        the low-order
                                                        solution feeding
                                                        the delimiters)
          isopycnal slopes -> isoflux divergence     2  (when enabled)
          clinic grad_p/metric/diffusion             2
          biharmonic del^2 o del^2                   +2 (when enabled)
        """
        w = 1 + 2 + 2 + 2          # velocity/adv_vel/flux/clinic chain
        if cfg.tracer_advection == "fct":
            w += 2                 # low-order solution pre-pass
        if cfg.isopycmix:
            w += 2                 # slope quadruples + isoflux
        if cfg.hmix == "biharmonic":
            w += 2                 # second Laplacian pass
        return w

    def __init__(self, model, mesh, halo: int | None = None):
        cfg = model.cfg.ocean
        refused = [name for name, on in (
            (f"barotropic={cfg.barotropic}",
             cfg.barotropic != BarotropicMode.STREAM_FUNCTION),
            ("vmix=ppmix", cfg.vmix == "ppmix"),
            ("cyclic=False (walls)", not model.cyclic),
            ("hmix=smagnl", cfg.hmix == "smagnl"),
            ("tracer_advection=quicker", cfg.tracer_advection == "quicker"),
            ("eb (Euler-backward mixing)", cfg.eb),
            # the checkerboard deflation leaves psi's ghost columns other
            # than the real columns they stand for, which the window's
            # periodic images cannot reproduce
            ("sf_npt=9", cfg.sf_npt == 9)) if on]
        if refused:
            raise ConfigError("the sharded ocean step does not take: "
                              + ", ".join(refused))
        if halo is None:
            halo = self.required_halo(cfg)
        self.m = model
        self.mesh = mesh
        g = model.params.grid
        self.ny, self.nx = mesh.shape
        self.w = w = halo
        # divisibility lift: pad the window to mesh multiples — x pad
        # columns are periodic images, y pad rows lie beyond the wall
        self.jmt, self.imt = g.jmt, g.imt
        self.jmt_p, self.imt_p = padded_window(g.jmt, g.imt, mesh.shape)
        self.gx = 2 + (self.imt_p - g.imt)
        self.ly, self.lx = ly, lx = (self.jmt_p // self.ny,
                                     self.imt_p // self.nx)
        if self.ny > 1 and halo > ly:
            raise ValueError(f"halo {halo} > local rows {ly}")
        if self.nx > 1 and halo + self.gx > lx:
            raise ValueError(f"halo {halo} + ghosts {self.gx} > local "
                             f"cols {lx}")

        # ---- extended static constants (one-time host work) ----------
        arrays = {k: getattr(model.g, k) for k in BAG_AXES
                  if hasattr(model.g, k)}
        axes = {k: BAG_AXES[k] for k in arrays}
        extra = {
            "tmask": ("yx", model.tmask, "zero"),
            "umask": ("yx", model.umask, "zero"),
            "kmt": ("yx", model.kmt, "zero"),
            "kmu": ("yx", model.kmu, "zero"),
            "diff_cbt": ("yx", model.diff_cbt, "clamp"),
            "visc_cbu": ("yx", model.visc_cbu, "clamp"),
            "addisop": ("y", model.addisop, "clamp"),
            "tlat_deg": ("yx", model.tlat_deg, "clamp"),
            "tidal_edr": ("yx", model.tidal_edr, "zero"),
            "aniso_vce": ("yx", model.aniso_visc[0]
                          if model.aniso_visc else None, "clamp"),
            "aniso_vcn": ("yx", model.aniso_visc[1]
                          if model.aniso_visc else None, "clamp"),
            # OceanModel._step's polar-enhanced drag and Neptune flow
            "cdbot2d": ("yx", model.cdbot2d, "clamp"),
            "unep": ("yx", model.unep, "zero"),
            "full_tensor_band": ("scalar",
                                 getattr(model.g, "full_tensor_band", None),
                                 None),
        }
        fills = {}
        for k, (kind, a, fill) in extra.items():
            arrays[k] = a
            axes[k] = kind if a is not None else "skip"
            if fill:
                fills[k] = fill
        self.stat = ExtendedStatics(arrays, axes, g.jmt, g.imt, self.ny,
                                    self.nx, w, fills, jmt_p=self.jmt_p,
                                    imt_p=self.imt_p)
        self.bag = self.stat.bag(mesh.iy, mesh.ix)
        # the rank's (ly, lx) block for the column-local phases
        self.tmask = crop(self.bag.tmask, w)
        self.umask = crop(self.bag.umask, w)
        self.kmt = crop(self.bag.kmt, w).contiguous()

        def block(a):
            return None if a is None else self.local(a)
        self.bhf = block(model.bhf)
        self.tlat_rad = block(getattr(model, "tlat_rad", None))
        # rows of the block beyond the wall (zeroed after each step)
        self.wall_row = max(0, min(ly, g.jmt - mesh.iy * ly))
        self.filt_t = self._local_filter(model.filt_t)
        self.filt_u = self._local_filter(model.filt_u)
        self.last_cg_iters = None

    # ------------------------------------------------------------------
    def local(self, a):
        """This rank's block of a global (..., jmt, imt) field."""
        return local_block(a, self.mesh, self.jmt, self.imt)

    def gather(self, a):
        """The global (..., jmt, imt) field of the ranks' blocks."""
        return gather_field(a, self.mesh, self.jmt, self.imt)

    def _local_filter(self, filt):
        """(local row indices, their matrices) of a ``ZonalFilter``'s rows
        that lie in this rank's latitude band, or None."""
        if filt is None:
            return None
        r0 = self.mesh.iy * self.ly
        rows = filt.rows
        sel = torch.nonzero((rows >= r0) & (rows < r0 + self.ly)).flatten()
        if sel.numel() == 0:
            return None
        return rows[sel] - r0, filt.mats[..., sel, :, :]

    def _filter_rows(self, f, filt, tag):
        """A high-latitude filter on the block: the filtered rows are
        gathered along the x ring into whole rows, each row's matrix is
        applied, and the rank keeps its own columns (image columns are
        left to ``_fix_columns``)."""
        if filt is None:
            return f
        rows, mats = filt
        parts = self.mesh.row_gather(f[..., rows, :].contiguous(), tag) \
            if self.nx > 1 else [f[..., rows, :]]
        full = torch.cat(parts, dim=-1)[..., :self.imt]
        out = torch.matmul(mats, full[..., None])[..., 0]
        c0 = self.mesh.ix * self.lx
        c1 = min(c0 + self.lx, self.imt)
        f = f.clone()
        f[..., rows, :c1 - c0] = out[..., c0:c1]
        return f

    def _fix_columns(self, fields):
        """The window's ghost and image columns (positions 0 and imt-1 ..
        imt_p-1) copied from the real columns they mirror, as
        ``setbcx`` and ``pad_window`` give them on the global array, and
        the rows beyond the wall zeroed; one exchange between the first
        and the last rank of the x ring."""
        packed, meta = pack(fields)
        imt, gx, lx, nx = self.imt, self.gx, self.lx, self.nx
        if nx == 1:
            packed[..., 0] = packed[..., imt - 2]
            packed[..., imt - 1:] = packed[..., 1:gx]
        elif self.mesh.ix in (0, nx - 1):
            mesh = self.mesh
            first = mesh.rank_of(mesh.iy, 0)
            last = mesh.rank_of(mesh.iy, nx - 1)
            if mesh.ix == 0:
                src = packed[..., 1:gx]
                got, = mesh.exchange([(src, last, TAG_IMAGES)],
                                     [(packed[..., :1], last, TAG_GHOST)])
                packed[..., :1] = got
            else:
                src = packed[..., lx - gx:lx - gx + 1]
                got, = mesh.exchange([(src, first, TAG_GHOST)],
                                     [(packed[..., lx - gx + 1:], first,
                                       TAG_IMAGES)])
                packed[..., lx - gx + 1:] = got
        packed[..., self.wall_row:, :] = 0.0
        return unpack(packed, meta)

    def full_velocity(self, ui, psi):
        """Internal + external mode on the halo-padded block (``ui`` and
        ``psi`` padded by the step's halo), masked; no ``setbcx``: the
        padded block's periodic neighbours give the ghost columns the
        values the global field's ``setbcx`` gives them."""
        bag = self.bag
        uext, vext = ext_mode_velocity(psi, bag.hr, bag.dxu2r, bag.dyu2r,
                                       bag.csur)
        return torch.stack([(ui[0] + uext[None]) * bag.umask,
                            (ui[1] + vext[None]) * bag.umask])

    # ------------------------------------------------------------------
    def _core(self, c2dtts, c2dtuv, t_tau, tm1, u_int, um1_int,
              psi0, psi1, smf, stf, btf, source):
        """Per-rank body: pad, run the whole-domain functions on the
        padded block, crop.  Returns (t_new before convection,
        u_int_new, zu) on the (ly, lx) block."""
        m, w, bag = self.m, self.w, self.bag
        cfg = m.cfg.ocean
        tmask, umask = bag.tmask, bag.umask
        kmt, kmu = bag.kmt, bag.kmu

        # ONE exchange for everything the stencil cascade reads
        t_tau, tm1, u_int, um1_int, psi0, psi1 = pack_exchange(
            [t_tau, tm1, u_int, um1_int, self.local(psi0),
             self.local(psi1)], w, self.mesh, gx=self.gx)
        smf = pad_zeros(smf, w)
        stf = pad_zeros(stf, w)
        btf = pad_zeros(btf, w)
        if source is not None:
            source = pad_zeros(source, w)

        u_tau = self.full_velocity(u_int, psi0)
        u_tm1 = self.full_velocity(um1_int, psi1)
        vet, vnt, vbt, veu, vnu, vbu = adv_vel(u_tau[0], u_tau[1], bag,
                                               True)

        if cfg.cdbot != 0.0:
            kb = torch.clamp(kmu - 1, min=0).long()
            ub = torch.gather(u_tm1, 1,
                              kb[None, None].expand(2, 1, -1, -1))[:, 0]
            uvmag = torch.sqrt(ub[0] ** 2 + ub[1] ** 2)
            bmf = bag.cdbot2d[None] * ub * uvmag[None] * (kmu > 0)[None]
        else:
            bmf = torch.zeros_like(smf)

        diff_cbt, visc_cbu = bag.diff_cbt, bag.visc_cbu
        iso = None
        aidif = 0.0
        vet_t, vnt_t, vbt_t = vet, vnt, vbt
        if cfg.isopycmix:
            from ..models.ocean.isopyc import compute_isopyc
            iso = compute_isopyc(tm1, tmask, kmt, m.eos_c, m.eos_to,
                                 m.eos_so, bag, cfg, True,
                                 addisop=bag.addisop)
            if cfg.tidal_kv:
                from ..models.ocean.vmix import tidal_kv_diff
                drodzb0 = iso.alphai * iso.ddzt[0] + iso.betai * iso.ddzt[1]
                diff_cbt = tidal_kv_diff(drodzb0, kmt, m.tidal_zw,
                                         bag.tlat_deg, bag.tidal_edr,
                                         diff_cbt)
            diff_cbt = diff_cbt + iso.K33
            if cfg.gent_mcwilliams:
                vet_t = vet + iso.vetiso
                vnt_t = vnt + iso.vntiso
                vbt_t = vbt + iso.vbtiso
            aidif = cfg.aidif

        hmix_t = hmix_u = None
        if cfg.hmix == "biharmonic":
            hmix_t = ("biharmonic", cfg.ahbi)
            hmix_u = ("biharmonic", cfg.ambi)
        if m.aniso_visc is not None and hmix_u is None:
            hmix_u = ("aniso", bag.aniso_vce, bag.aniso_vcn)

        t_new = tracer_step(
            t_tau, tm1, vet_t, vnt_t, vbt_t, stf, btf, source, diff_cbt,
            kmt, tmask, bag, c2dtts, cfg.tracer_advection, aidif, True,
            iso=iso, hmix=hmix_t, fct_variant=cfg.fct_variant,
            fct3d=cfg.fct_3d)

        rho = eos_state_from(m.eos_c, m.eos_to, m.eos_so, t_tau)
        u_int_new, zu = clinic_step(
            u_tau, u_tm1, rho, veu, vnu, vbu, smf, bmf, visc_cbu, kmu,
            umask, bag, c2dtuv, True, hmix=hmix_u, unep=bag.unep)
        return crop(t_new, w), crop(u_int_new, w), crop(zu, w)

    # ------------------------------------------------------------------
    def _sources(self, tm1, forcing, leapfrog, scan, c2dtts):
        """The column-local sources of the tracer step on the block:
        bgc (NPZD/MOBI) and penetrative shortwave, as ``_step`` takes
        them for the same ``scan``; zero beyond the wall."""
        m = self.m
        source = None
        if m.npzd is not None:
            args = (tm1, self.kmt, self.tmask, forcing.swr, forcing.aice,
                    forcing.hice, forcing.hsno, self.tlat_rad, forcing.relyr)
            if scan:
                source = m.npzd[True].sources(*args, c2dtts=c2dtts)
            else:
                source = m.npzd[leapfrog].sources(*args)
        if m.divpen is not None:
            ki = 5.0e-2
            psw = forcing.swr * 2.389e-8 * (1.0 + forcing.aice * (
                torch.exp(-ki * (forcing.hice + forcing.hsno)) - 1.0))
            sw_src = psw[None] * m.divpen[:, None, None] * self.tmask
            if source is None:
                source = torch.zeros_like(tm1)
                source[0] = sw_src
            else:
                source = source.clone()
                source[0] = source[0] + sw_src
        if source is not None:
            source[..., self.wall_row:, :] = 0.0
        return source

    def step(self, state: OceanState, forcing, leapfrog: bool = True,
             scan: bool = False):
        """One step on this rank's block: ``state`` and ``forcing`` as
        ``mesh.shard_pytree`` cuts them (the barotropic fields
        replicated); every rank calls it together.  The counterpart of
        ``OceanModel._step``; ``scan`` takes the bgc sources as
        ``_step(..., scan=True)`` does (the leapfrog instance with the
        step's interval, the coupled segment's ocean step)."""
        m = self.m
        cfg = m.cfg.ocean
        if leapfrog:
            c2dtts, c2dtuv, c2dtsf = 2 * cfg.dtts, 2 * cfg.dtuv, 2 * cfg.dtsf
            tm1, t_tau = state.tm1, state.t
            um1_int, u_int = state.um1, state.u
            psi0, psi1 = state.psi0, state.psi1
        else:
            c2dtts, c2dtuv, c2dtsf = cfg.dtts, cfg.dtuv, cfg.dtsf
            tm1, t_tau = state.t, state.t
            um1_int, u_int = state.u, state.u
            psi0, psi1 = state.psi0, state.psi0

        smf = forcing.smf * self.umask[0][None]
        stf = forcing.stf * self.tmask[0][None]
        btf = forcing.btf * self.tmask[0][None]
        if self.bhf is not None:
            btf[0] = btf[0] - self.bhf * self.tmask[0]
        source = self._sources(tm1, forcing, leapfrog, scan, c2dtts)

        t_new, u_int_new, zu = self._core(
            c2dtts, c2dtuv, t_tau, tm1, u_int, um1_int, psi0, psi1, smf,
            stf, btf, source)

        # the ghost columns the global field has here (tracer_step's and
        # clinic_step's setbcx), then column-local convection on the block
        t_new, u_int_new = self._fix_columns([t_new, u_int_new])
        if cfg.convect_brine and forcing.cbf is not None:
            cba0 = torch.clamp(1.0 - forcing.cba.sum(0), min=0.0) \
                * self.tmask[0]
            t_new = convct_brine(
                t_new, forcing.cbf, forcing.cba, cba0, self.kmt, m.eos_c,
                m.eos_to, m.eos_so, m.dztxcl, c2dtts,
                float(m.params.grid.zw[0]))
        elif cfg.convection == Convection.FULL:
            t_new = convct_full(t_new, self.kmt, m.eos_c, m.eos_to,
                                m.eos_so, m.dztxcl)
        else:
            t_new = convct_ncon(t_new, self.kmt, m.eos_c, m.eos_to,
                                m.eos_so, m.dztxcl, cfg.ncon)
        t_new = self._filter_rows(t_new, self.filt_t, TAG_FILT_T)
        u_int_new = self._filter_rows(u_int_new, self.filt_u, TAG_FILT_U)
        t_new, u_int_new = self._fix_columns([t_new, u_int_new])

        # the barotropic solve, replicated: zu from every rank, with the
        # ghost columns clinic_step's setbcx gives the global field
        zu = setbcx(self.gather(zu), True)
        solver, solve_c2dtsf = m.barotropic_solver(leapfrog)
        psi0n, psi1n, ptd, ptdb, iters, conv = tropic_step(
            zu, psi0, psi1, state.ptd, state.ptdb, m.isl, m.g.dxu, m.g.dyu,
            m.g.csu, c2dtsf, cfg.tolrsf, cfg.mxscan, leapfrog, solver, True,
            filt=m.filt_sf, npt=cfg.sf_npt, solve_c2dtsf=solve_c2dtsf)
        self.last_cg_iters = iters
        return OceanState(
            tm1=t_tau, t=t_new, um1=u_int, u=u_int_new,
            psi0=psi0n, psi1=psi1n, ptd=ptd, ptdb=ptdb,
            ubar=state.ubar, ubarm1=state.ubarm1,
            itt=state.itt + 1,
            nconv=state.nconv + (~conv).to(torch.int32))


def run_sharded(mesh, cfg, state, forcing, schedule, halo=None, root=0):
    """A rank's whole run, the function ``launch.spawn`` calls: build the
    ocean of ``cfg`` on the mesh's device, cut the global ``state`` and
    ``forcing`` (dicts of NumPy arrays under the field names of
    ``convert.ocean_state_to_numpy`` and ``make_forcing``) into this
    rank's blocks, take one step per entry of ``schedule`` (True: a
    leapfrog step) and gather.

    Returns a dict: ``state`` (the global NumPy fields on ``root``, None
    elsewhere), ``barotropic`` (this rank's replicated psi0, psi1, ptd,
    ptdb), ``blocks`` (this rank's blocks of t and u, ghost and image
    columns included), ``step_s`` (wall seconds of each step, the card synchronised),
    ``exchange_s`` (seconds of each step in messages; the first step's
    include the wait for the slowest rank's start), ``messages``,
    ``transport``, ``launches`` (each kernel wrapper's count over the
    steps) and ``cg_iters``."""
    import time

    import numpy as np

    from ..convert import ocean_state_from_numpy, ocean_state_to_numpy
    from ..models.ocean.model import make_forcing, make_ocean
    from ..ops.cg_kernel import congrad_launch
    from ..ops.convection import apply_region_means
    from ..ops.tracer_kernel import fct_tracer_step
    from .mesh import gather_pytree, shard_pytree

    m = make_ocean(cfg, device=mesh.device)
    ss = ShardedOceanStep(m, mesh, halo=halo)
    jmt, imt = ss.jmt, ss.imt

    def tn(x):
        return torch.as_tensor(np.asarray(x), dtype=m.dtype,
                               device=mesh.device)

    s = shard_pytree(ocean_state_from_numpy(state, mesh.device, m.dtype),
                     mesh, jmt, imt)
    f = make_forcing(**{k: (v if k == "relyr" else tn(v))
                        for k, v in forcing.items()})
    f = shard_pytree(f, mesh, jmt, imt)
    counters = (fct_tracer_step, apply_region_means, congrad_launch)
    names = ("fct_tracer_step", "apply_region_means", "congrad")
    for c in counters:
        c.launches = 0
    msg0 = mesh.messages
    step_s, exchange_s, iters = [], [], []
    cuda = mesh.device.type == "cuda"
    for leapfrog in schedule:
        if cuda:
            torch.cuda.synchronize(mesh.device)
        t0, ex0 = time.perf_counter(), mesh.exchange_s
        s = ss.step(s, f, leapfrog=bool(leapfrog))
        if cuda:
            torch.cuda.synchronize(mesh.device)
        step_s.append(time.perf_counter() - t0)
        exchange_s.append(mesh.exchange_s - ex0)
        iters.append(int(ss.last_cg_iters))
    launches = {n: c.launches for n, c in zip(names, counters)}
    messages = mesh.messages - msg0
    full = gather_pytree(s, mesh, jmt, imt, root=root)
    return dict(
        state=None if full is None else ocean_state_to_numpy(full),
        barotropic={k: getattr(s, k).cpu().numpy()
                    for k in ("psi0", "psi1", "ptd", "ptdb")},
        blocks={k: getattr(s, k).cpu().numpy() for k in ("t", "u")},
        step_s=step_s, exchange_s=exchange_s, messages=messages,
        transport=mesh.transport, launches=launches, cg_iters=iters)

