"""The rank-decomposed ocean step with ONE aggregated halo exchange.

Port of ``uvic_tpu.parallel.shard_step`` onto ``torch.distributed``.
Each rank holds one block of the (y, x) mesh (``mesh.RankMesh``).  All
stencil-consuming state is packed into a single array, halo-exchanged
once per step (``halo.pack_exchange_ring``), and the port's unchanged
whole-domain functions (full velocities, ``adv_vel``, the mixing
coefficients, isopycnal/GM, tidal kv, the generic ``tracer_step``,
``clinic_step``) run on the halo-padded local block.  The halo covers
the stencil composition depth (``halo_width``), so every kept cell
computes the global answer; the frame computes garbage and is cropped.

The step takes every option of ``OceanModel._step`` and computes it as
``_step`` computes it; the reference runs them on the global array under
GSPMD (``uvic_tpu.parallel.mesh.shard_step``), and its explicit sharded
core refuses five of them.  The phases get the communication they need:

- the sources (NPZD/MOBI, shortwave, geothermal heat) and convection
  (full, ncon, brine) are column-local: each rank runs them on its block
  (convection's region-mean apply, B3, on the card);
- the high-latitude filters (FIR or Fourier) take whole rows: the
  filtered rows of a block are gathered along its x ring, filtered, and
  each rank keeps its own columns;
- the ghost and image columns of the window are copied from the real
  columns they mirror (``setbcx`` and ``halo.pad_window`` on the global
  array; zeroed at walls) by an exchange between the first and the last
  rank of each x ring, and the rows beyond the wall are zeroed: before
  convection, as ``tracer_step`` and ``clinic_step`` leave the global
  fields, and after the filters;
- the barotropic solve runs REPLICATED: the forcing ``zu`` is gathered
  from every rank and ``tropic_step`` or ``surface_pressure_step`` (the
  CG, B2, on the card) runs identically everywhere on the whole field,
  with the filter of the surface-pressure forcing on whole rows, as the
  reference does (a sharded CG would issue hundreds of latency-bound
  reductions, and the near-null modes of the operators amplify
  reduction-order differences).  psi0, psi1, ptd, ptdb, ubar and ubarm1
  stay replicated between steps, and the external-mode velocity is
  computed on the whole field and cut to each rank's padded block.

The core takes the generic ``tracer_step`` (never the fused tracer
step, B1), as the reference's does: its fused Pallas step exists only
on a (1, 1) mesh.  The step is eager; host-staged messages cannot be
captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import BarotropicMode, Convection
from ..core.state import OceanState
from ..models.ocean.kernels import adv_vel, clinic_step, tracer_step
from ..models.ocean.model import eos_state_from
from ..models.ocean.tropic import ext_mode_velocity, tropic_step
from ..ops.convection import convct_brine, convct_full, convct_ncon
from ..ops.stencil import BlockColumns, setbcx
from .halo import (BAG_AXES, BlockCut, ExtendedStatics, crop, extend_x,
                   extend_y, pack, pack_exchange_ring, pad_zeros, unpack,
                   x_images)
from .mesh import REPLICATED, gather_field, local_block, padded_window

# message tags of the filters' row gathers and the column fix-up
TAG_FILT_T, TAG_FILT_U, TAG_IMAGES, TAG_GHOST = 11, 12, 13, 14


class ShardedOceanStep:
    """Wraps an ``OceanModel`` with the rank-decomposed step.

    Support matrix: every option of ``OceanModel``, computed as its
    ``_step`` computes it, with the communication each takes (beyond the
    one packed halo exchange of t, tm1, u and um1 a step):

    | concern            | options                  | communication      |
    |--------------------|--------------------------|--------------------|
    | barotropic         | streamfunction (5- or    | zu gathered, the   |
    |                    | 9-point, acor), surface  | solve replicated;  |
    |                    | pressure, implicit free  | the external-mode  |
    |                    | surface                  | velocity cut from  |
    |                    |                          | the whole field    |
    | vmix               | const / bryan_lewis /    | none (ppmix on the |
    |                    | ppmix (+tidal_kv)        | padded block)      |
    | hmix               | const / aniso / smagnl / | none (padded       |
    |                    | biharmonic, Neptune      | block)             |
    | tracer advection   | centered / upstream /    | none (padded       |
    |                    | FCT dlm1, dlm2, fct_3d / | block)             |
    |                    | QUICKER                  |                    |
    | isopycnal/GM       | small-angle, full tensor,| none (padded       |
    |                    | dm_taper                 | block)             |
    | sources            | bgc, shortwave, gthflx,  | none (column-local)|
    |                    | dtxcel_deep              |                    |
    | convection         | full, ncon, brine        | none (column-local)|
    | filters            | FIR, Fourier             | rows gathered on   |
    |                    |                          | the x ring         |
    | domain             | cyclic, walls            | ghost and image    |
    |                    |                          | columns: first and |
    |                    |                          | last rank of a ring|
    | mixing step        | forward, Euler-backward  | EB: two passes,    |
    |                    |                          | each its exchange  |
    |                    |                          | and solve          |

    ``halo=None`` derives the width from the configured stencil depth
    (``halo_width``).  The padded block holds what the whole field's
    rolls read: its x images follow the ring of imt columns
    (``halo.x_images(..., ring=True)``, ``halo.exchange_pad_ring``), on
    which the ghost columns 0 and imt-1 are columns of their own, and
    ``setbcx`` acts on the block's columns that stand for them as on
    the whole field's (``ops.stencil.BlockColumns``: copied from the
    columns they duplicate, or zeroed at walls).  So the step computes
    what the whole field's step computes also where the state's ghost
    columns are not the columns they duplicate (a state that no step
    has made yet; the 9-point operator's psi).  The stored blocks keep
    ``mesh.local_block``'s layout.
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

        The reference's law; ``halo_width`` widens it for the options
        its sharded core refuses."""
        w = 1 + 2 + 2 + 2          # velocity/adv_vel/flux/clinic chain
        if cfg.tracer_advection == "fct":
            w += 2                 # low-order solution pre-pass
        if cfg.isopycmix:
            w += 2                 # slope quadruples + isoflux
        if cfg.hmix == "biharmonic":
            w += 2                 # second Laplacian pass
        return w

    @staticmethod
    def halo_width(cfg, cyclic: bool) -> int:
        """The halo the step takes by default: ``required_halo`` widened
        for what the reference's sharded core does not take:

          a cyclic window: setbcx copies the column two     +2
          to the west of column 0 (imt-2) and two to the
          east of column imt-1 (1)
          QUICKER: its flux reads two cells upstream        +1
          Smagorinsky: strain -> face coefficients          +2
          the 3-D FCT delimiter: a second limiter pass      +2

        (ppmix's coefficients read two cells of the padded block and
        enter the step column by column; the surface-pressure modes and
        the 9-point operator take the external velocity cut from the
        whole field; Euler-backward's second pass exchanges anew.)"""
        w = ShardedOceanStep.required_halo(cfg)
        if cyclic:
            w += 2
        if cfg.tracer_advection == "quicker":
            w += 1
        if cfg.hmix == "smagnl":
            w += 2
        if cfg.tracer_advection == "fct" and cfg.fct_3d:
            w += 2
        return w

    def __init__(self, model, mesh, halo: int | None = None):
        cfg = model.cfg.ocean
        if halo is None:
            halo = self.halo_width(cfg, model.cyclic)
        self.m = model
        self.mesh = mesh
        g = model.params.grid
        self.cyclic = bool(model.cyclic)
        self.ny, self.nx = mesh.shape
        self.w = w = halo
        # divisibility lift: pad the window to mesh multiples — x pad
        # columns are periodic images in the stored blocks, y pad rows
        # lie beyond the wall; gx: the window's trailing ghost and image
        # columns, pad: its columns beyond imt
        self.jmt, self.imt = g.jmt, g.imt
        self.jmt_p, self.imt_p = padded_window(g.jmt, g.imt, mesh.shape)
        self.pad = self.imt_p - g.imt
        self.gx = 2 + self.pad
        self.ly, self.lx = ly, lx = (self.jmt_p // self.ny,
                                     self.imt_p // self.nx)
        if self.ny > 1 and halo > ly:
            raise ValueError(f"halo {halo} > local rows {ly}")
        if self.nx > 1 and (halo + self.pad > lx or self.gx > lx):
            raise ValueError(f"halo {halo} + pad columns {self.pad} > "
                             f"local cols {lx}")
        # the window positions of this rank's padded block
        x0 = mesh.ix * lx - w
        pos = np.arange(x0, x0 + lx + 2 * w)

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
            # the Smagorinsky metric term's sine
            "sine": ("y", model.sine, "clamp"),
        }
        fills = {}
        for k, (kind, a, fill) in extra.items():
            arrays[k] = a
            axes[k] = kind if a is not None else "skip"
            if fill:
                fills[k] = fill
        self.stat = ExtendedStatics(arrays, axes, g.jmt, g.imt, self.ny,
                                    self.nx, w, fills, jmt_p=self.jmt_p,
                                    imt_p=self.imt_p, ring=True)
        self.bag = self.stat.bag(mesh.iy, mesh.ix)
        if hasattr(model.g, "quicker"):
            self.bag.quicker = self._local_quicker(model.g.quicker, pos)
        # the zonal boundary condition of the block's whole-domain calls
        cols = x_images(pos, g.imt, ring=True)
        self.bc = BlockColumns(np.nonzero(cols == 0)[0],
                               np.nonzero(cols == g.imt - 1)[0], len(pos),
                               self.cyclic)
        # the padded block of a whole replicated field
        self.cut = BlockCut(g.jmt, g.imt, mesh.iy, mesh.ix, ly, lx, w,
                            model.device)
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

    def _local_quicker(self, qc, pos):
        """QUICKER's 1-D coefficients on the padded block: x at the
        block's window positions, y extended beyond the walls as the
        other y constants, z as they are."""
        w, ly, iy = self.w, self.ly, self.mesh.iy

        def ext(v, kind):
            h = v.detach().cpu().numpy()
            if kind == "x":
                e = extend_x(h, w, n_out=self.imt_p, ring=True)
                e = e[pos[0] + w:pos[-1] + w + 1]
            else:
                e = extend_y(h, w, n_out=self.jmt_p)[iy * ly:
                                                     iy * ly + ly + 2 * w]
            return torch.as_tensor(e, device=v.device)
        return {ax: {k: (ext(v, ax) if ax in ("x", "y") else v)
                     for k, v in d.items()} for ax, d in qc.items()}

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
        imt_p-1) as ``setbcx`` and ``pad_window`` give them on the global
        array — copied from the real columns they mirror, the ghost
        columns zeroed at walls — and the rows beyond the wall zeroed;
        one exchange between the first and the last rank of the x
        ring."""
        packed, meta = pack(fields)
        imt, gx, lx, nx = self.imt, self.gx, self.lx, self.nx
        mesh = self.mesh
        if nx == 1:
            packed[..., 0] = packed[..., imt - 2]
            packed[..., imt - 1:] = packed[..., 1:gx]
        elif mesh.ix in (0, nx - 1):
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
        if not self.cyclic:
            if mesh.ix == 0:
                packed[..., 0] = 0.0
            if mesh.ix == nx - 1:
                packed[..., lx - gx + 1] = 0.0
        packed[..., self.wall_row:, :] = 0.0
        return unpack(packed, meta)

    def ext_velocity(self, ext):
        """The external-mode velocity (2, ly+2w, lx+2w) on this rank's
        padded block, of the whole replicated ``ext`` (the streamfunction
        or, in the surface-pressure modes, ubar), as
        ``OceanModel.full_velocity`` forms it on the whole field, the
        zonal boundary condition included: each rank computes it whole
        and cuts its block, so the 9-point operator's ghost columns of
        psi, which need not equal the columns they stand for, enter as
        on the whole field."""
        m = self.m
        if m.sp_mode:
            uext, vext = ext[0], ext[1]
        else:
            uext, vext = ext_mode_velocity(ext, m.g.hr, m.g.dxu2r,
                                           m.g.dyu2r, m.g.csur)
        shape = (self.jmt, self.imt)
        ue = torch.stack([torch.broadcast_to(uext, shape),
                          torch.broadcast_to(vext, shape)])
        return self.cut(setbcx(ue, self.cyclic))

    def full_velocity(self, ui, ue):
        """Internal + external mode on the halo-padded block (``ui``
        padded by the step's halo, ``ue`` from ``ext_velocity``),
        masked, with the boundary columns of ``setbcx``."""
        bag = self.bag
        return setbcx(torch.stack([(ui[0] + ue[0][None]) * bag.umask,
                                   (ui[1] + ue[1][None]) * bag.umask]),
                      self.bc)

    # ------------------------------------------------------------------
    def _core(self, c2dtts, c2dtuv, t_tau, tm1, u_int, um1_int,
              ue_tau, ue_tm1, smf, stf, btf, source):
        """Per-rank body: pad, run the whole-domain functions on the
        padded block, crop.  Returns (t_new before convection,
        u_int_new, zu) on the (ly, lx) block."""
        m, w, bag, bc = self.m, self.w, self.bag, self.bc
        cfg = m.cfg.ocean
        tmask, umask = bag.tmask, bag.umask
        kmt, kmu = bag.kmt, bag.kmu

        # ONE exchange for everything the stencil cascade reads
        t_tau, tm1, u_int, um1_int = pack_exchange_ring(
            [t_tau, tm1, u_int, um1_int], w, self.mesh, self.pad)
        smf = pad_zeros(smf, w)
        stf = pad_zeros(stf, w)
        btf = pad_zeros(btf, w)
        if source is not None:
            source = pad_zeros(source, w)

        u_tau = self.full_velocity(u_int, ue_tau)
        u_tm1 = self.full_velocity(um1_int, ue_tm1)
        vet, vnt, vbt, veu, vnu, vbu = adv_vel(u_tau[0], u_tau[1], bag, bc)

        if cfg.cdbot != 0.0:
            kb = torch.clamp(kmu - 1, min=0).long()
            ub = torch.gather(u_tm1, 1,
                              kb[None, None].expand(2, 1, -1, -1))[:, 0]
            uvmag = torch.sqrt(ub[0] ** 2 + ub[1] ** 2)
            bmf = bag.cdbot2d[None] * ub * uvmag[None] * (kmu > 0)[None]
        else:
            bmf = torch.zeros_like(smf)

        if cfg.vmix == "ppmix":
            from ..models.ocean.vmix import ppmix_coefficients
            diff_cbt, visc_cbu = ppmix_coefficients(
                tm1, u_tm1, tmask, umask, m.eos_c, m.eos_to, m.eos_so, bag,
                cyclic=bc)
        else:
            diff_cbt, visc_cbu = bag.diff_cbt, bag.visc_cbu
        iso = None
        aidif = 0.0
        vet_t, vnt_t, vbt_t = vet, vnt, vbt
        if cfg.isopycmix:
            from ..models.ocean.isopyc import compute_isopyc
            iso = compute_isopyc(tm1, tmask, kmt, m.eos_c, m.eos_to,
                                 m.eos_so, bag, cfg, bc,
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
        if cfg.hmix == "smagnl":
            from ..models.ocean.hmix import (smag_tracer_coefficients,
                                             smagnl_coefficients)
            strain, am_lam, am_phi = smagnl_coefficients(u_tm1, bag, bc)
            cet, cnt = smag_tracer_coefficients(am_lam, am_phi,
                                                cfg.smag_diff_back)
            hmix_t = ("smagnl", cet, cnt)
            hmix_u = ("smagnl", strain, am_lam, am_phi, bag.sine)
        elif cfg.hmix == "biharmonic":
            hmix_t = ("biharmonic", cfg.ahbi)
            hmix_u = ("biharmonic", cfg.ambi)
        if m.aniso_visc is not None and hmix_u is None:
            hmix_u = ("aniso", bag.aniso_vce, bag.aniso_vcn)

        t_new = tracer_step(
            t_tau, tm1, vet_t, vnt_t, vbt_t, stf, btf, source, diff_cbt,
            kmt, tmask, bag, c2dtts, cfg.tracer_advection, aidif, bc,
            iso=iso, hmix=hmix_t, fct_variant=cfg.fct_variant,
            fct3d=cfg.fct_3d)

        rho = eos_state_from(m.eos_c, m.eos_to, m.eos_so, t_tau)
        u_int_new, zu = clinic_step(
            u_tau, u_tm1, rho, veu, vnu, vbu, smf, bmf, visc_cbu, kmu,
            umask, bag, c2dtuv, bc, hmix=hmix_u, unep=bag.unep)
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
        ``OceanModel.step`` (a mixing step of an ``eb`` model is
        Euler-backward: two passes) and, with ``scan``, of
        ``OceanModel._step(..., scan=True)``: the bgc sources as
        ``run_scan`` takes them (the leapfrog instance with the step's
        interval, the coupled segment's ocean step) and a forward
        mixing step, as the reference's ``run_scan``."""
        if not leapfrog and not scan and self.m.cfg.ocean.eb:
            return self._step_eb(state, forcing)
        return self._step(state, forcing, leapfrog=leapfrog, scan=scan)

    def _step_eb(self, state: OceanState, forcing) -> OceanState:
        """Euler-backward mixing step as ``OceanModel._step_eb``: a
        forward predictor pass whose tau+1 fields, exchanged anew, are
        the tau arguments of a corrector pass."""
        s1 = self._step(state, forcing, leapfrog=False, eb_pass=1)
        if self.m.sp_mode:
            mid = OceanState(
                tm1=state.t, t=s1.t, um1=state.u, u=s1.u,
                psi0=s1.psi0, psi1=s1.psi1, ptd=s1.ptd, ptdb=state.ptdb,
                ubar=s1.ubar, ubarm1=s1.ubarm1, itt=state.itt,
                nconv=s1.nconv)
        else:
            mid = OceanState(
                tm1=state.t, t=s1.t, um1=state.u, u=s1.u,
                psi0=s1.psi0, psi1=state.psi0, ptd=state.ptd,
                ptdb=state.ptdb, ubar=state.ubar, ubarm1=state.ubarm1,
                itt=state.itt, nconv=s1.nconv)
        s2 = self._step(mid, forcing, leapfrog=False, eb_pass=2)
        return dataclasses.replace(s2, tm1=state.t, um1=state.u,
                                   itt=state.itt + 1)

    def _step(self, state: OceanState, forcing, *, leapfrog: bool,
              scan: bool = False, eb_pass: int = 0) -> OceanState:
        """``OceanModel._step`` on the block (``eb_pass`` 1/2: the passes
        of an Euler-backward mixing step, taken with ``leapfrog``
        False)."""
        m = self.m
        cfg = m.cfg.ocean
        if eb_pass == 2:
            c2dtts, c2dtuv, c2dtsf = cfg.dtts, cfg.dtuv, cfg.dtsf
            tm1, t_tau = state.tm1, state.t
            um1_int, u_int = state.um1, state.u
            psi0, psi1 = state.psi0, state.psi1
            ub_tm1 = state.ubarm1
        elif leapfrog:
            c2dtts, c2dtuv, c2dtsf = 2 * cfg.dtts, 2 * cfg.dtuv, 2 * cfg.dtsf
            tm1, t_tau = state.tm1, state.t
            um1_int, u_int = state.um1, state.u
            psi0, psi1 = state.psi0, state.psi1
            ub_tm1 = state.ubarm1
        else:
            c2dtts, c2dtuv, c2dtsf = cfg.dtts, cfg.dtuv, cfg.dtsf
            tm1, t_tau = state.t, state.t
            um1_int, u_int = state.u, state.u
            psi0, psi1 = state.psi0, state.psi0
            ub_tm1 = state.ubar
        ext_tau, ext_tm1 = ((state.ubar, ub_tm1) if m.sp_mode
                            else (psi0, psi1))
        ue_tau = self.ext_velocity(ext_tau)
        ue_tm1 = ue_tau if ext_tm1 is ext_tau \
            else self.ext_velocity(ext_tm1)

        smf = forcing.smf * self.umask[0][None]
        stf = forcing.stf * self.tmask[0][None]
        btf = forcing.btf * self.tmask[0][None]
        if self.bhf is not None:
            btf[0] = btf[0] - self.bhf * self.tmask[0]
        source = self._sources(tm1, forcing, leapfrog, scan, c2dtts)

        t_new, u_int_new, zu = self._core(
            c2dtts, c2dtuv, t_tau, tm1, u_int, um1_int, ue_tau, ue_tm1,
            smf, stf, btf, source)

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
        zu = setbcx(self.gather(zu), self.cyclic)
        solver, solve_c2dtsf = m.barotropic_solver(leapfrog)
        if m.sp_mode:
            from ..models.ocean.surfpress import surface_pressure_step
            alph, gam_b, theta = m.sp_consts
            fs = m.barotropic == BarotropicMode.IMPLICIT_FREE_SURFACE
            if m.filt_zu is not None:
                zu = m.filt_zu(zu)
            ps0n, ps1n, pguess, ubar_n, iters = surface_pressure_step(
                zu, state.psi0, state.psi1, psi1, state.ptd, state.ubar,
                ub_tm1, solver, m.g, m.umask[0], m.sp_omask, c2dtsf,
                cfg.dtsf, cfg.tolrfs if fs else cfg.tolrsp, leapfrog,
                free_surface=fs, alph=alph, gam=gam_b, theta=theta,
                acor=cfg.acor, cori=m.g.cori[0], eb_pass=eb_pass,
                cyclic=m.cyclic)
            self.last_cg_iters = iters
            return OceanState(
                tm1=t_tau, t=t_new, um1=u_int, u=u_int_new,
                psi0=ps0n, psi1=ps1n, ptd=pguess, ptdb=state.ptdb,
                ubar=ubar_n,
                ubarm1=state.ubarm1 if eb_pass == 2 else state.ubar,
                itt=state.itt + 1,
                nconv=state.nconv + (iters >= cfg.mxscan).to(torch.int32))
        psi0n, psi1n, ptd, ptdb, iters, conv = tropic_step(
            zu, psi0, psi1, state.ptd, state.ptdb, m.isl, m.g.dxu, m.g.dyu,
            m.g.csu, c2dtsf, cfg.tolrsf, cfg.mxscan, leapfrog, solver,
            m.cyclic, filt=m.filt_sf, euler2=eb_pass == 2,
            save_ptd=eb_pass != 1, npt=cfg.sf_npt,
            solve_c2dtsf=solve_c2dtsf)
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
    elsewhere), ``barotropic`` (this rank's replicated fields, ``mesh.
    REPLICATED``), ``blocks`` (this rank's blocks of t and u, ghost and image
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
        barotropic={k: getattr(s, k).cpu().numpy() for k in REPLICATED},
        blocks={k: getattr(s, k).cpu().numpy() for k in ("t", "u")},
        step_s=step_s, exchange_s=exchange_s, messages=messages,
        transport=mesh.transport, launches=launches, cg_iters=iters)

