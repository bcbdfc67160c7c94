"""The rank-decomposed coupled segment.

The counterpart of the reference's coupled segment on a sharded state
(``CoupledModel.run_segment`` of a state cut by ``shard_pytree``,
``__graft_entry__.dryrun_multichip`` part 2): there XLA partitions the
whole segment program over the mesh.  Here each rank holds one block of
the (y, x) mesh (``mesh.RankMesh``):

- the ocean steps on its block through ``ShardedOceanStep`` (with
  ``scan=True``, as the coupler steps the ocean);
- the 2-D components run REPLICATED on every rank: the EMBM atmosphere
  with its BiCGSTAB solves, the EVP and thermodynamic sea ice, the MTLM
  land and the sediments.  They are small, global-elliptic or
  latency-bound, as the barotropic solve is; decomposing them is speed
  work that has not been done.

The segment keeps ``CoupledModel.schedule`` and its stage names; only
what each stage reads of the ocean changes:

- ``head``: the surface layer of every tracer and of ``u`` is gathered
  once; every rank computes sst, frzpt and the surface currents on the
  whole grid (psi is replicated);
- ``atm``: unchanged, replicated;
- ``mid``: the land update is unchanged; the sediments' bottom water (a
  2-D slice) is gathered; gosbc builds the forcing on the whole grid and
  each rank takes its block (``local_block``: the ghost and image
  columns, zero rows beyond the wall), as ``run_sharded`` cuts a
  forcing.  No 3-D field of the ocean is gathered in the segment;
- ``ocean``: ``ShardedOceanStep.step(..., scan=True)``; the per-step
  means that read neighbours (the advective and diffusive fluxes, the
  face velocities) come from one more halo exchange of the new
  temperature and velocity, the external-mode velocity from the
  replicated field, as the unsharded stage forms it;
- ``tail``: the bolus velocities from ``compute_isopyc`` on a
  halo-padded block; the convection extent on the block (column-local);
  the 2-D means replicated.

The segment's records (``last_tavg``, ``last_acc``, ``last_forcing``,
``seg_cg_iters``, ``seg_trips``) stay on each rank: the block for the
ocean's 3-D means (and its surface-tracer means and convection extent),
whole otherwise; ``gather_tavg`` joins them for I/O and tests.

The segment is eager: host-staged gloo messages cannot be captured in a
CUDA graph.
"""

from __future__ import annotations

import hashlib

import torch
from torch.profiler import record_function

from ..coupler.driver import (CoupledModel, bolus_means, bottom_water,
                              pack_state, run_stages, step_means,
                              unpack_state)
from ..models.ocean.kernels import adv_vel
from ..models.ocean.model import make_forcing
from ..ops.stencil import E
from .halo import crop, pack_exchange_ring
from .mesh import (REPLICATED, gather_coupled, gather_field,
                   gather_pytree, shard_coupled, shard_pytree)
from .shard_step import ShardedOceanStep


class ShardedCoupledModel:
    """Wraps a ``CoupledModel`` with the rank-decomposed segment; every
    rank of ``mesh`` builds the same model and calls ``run_segment``
    together on its block state (``shard``).  ``halo`` as in
    ``ShardedOceanStep`` (None: derived from the configuration)."""

    def __init__(self, model: CoupledModel, mesh, halo: int | None = None):
        self.model = model
        self.mesh = mesh
        self.ss = ss = ShardedOceanStep(model.ocean, mesh, halo=halo)
        self.jmt, self.imt = ss.jmt, ss.imt
        self._sed_kb = ss.local(model._sed_kb) if model._sed_on else None
        self.last_acc = None
        self.last_forcing = None
        self.last_tavg = None
        self.last_nep_kgC_s = None

    @property
    def acc_names(self):
        return self.model.acc_names

    @property
    def forcing_names(self):
        return self.model.forcing_names

    # the segment's records, as CoupledModel keeps them
    _finish = CoupledModel._finish

    # ------------------------------------------------------------------
    def shard(self, state):
        """This rank's block state of a whole ``CoupledState``."""
        return shard_coupled(state, self.mesh, self.jmt, self.imt)

    def gather(self, state, root: int | None = None):
        """The whole ``CoupledState`` of the ranks' block states (on
        ``root`` only with ``root``, None elsewhere)."""
        return gather_coupled(state, self.mesh, self.jmt, self.imt, root)

    def gather_tavg(self, tavg=None, root: int | None = None):
        """The whole time means of the ranks' ``tavg`` (by default
        ``last_tavg``): the block means joined, the whole ones as they
        are."""
        tavg = self.last_tavg if tavg is None else tavg
        return gather_pytree(dict(tavg), self.mesh, self.jmt, self.imt,
                             root=root)

    # ------------------------------------------------------------------
    def schedule(self, host):
        return self.model.schedule(host)

    def segment_inputs(self) -> dict:
        return self.model.segment_inputs()

    def stage(self, name, flag, ws, host):
        """The entries one stage changes (a profiler range names it)."""
        with record_function("stage_" + name):
            if name == "atm":
                return self.model.stage_atm(ws, host, flag)
            if name == "ocean":
                return self.stage_ocean(ws, host, flag)
            return getattr(self, "stage_" + name)(ws, host)

    def stage_head(self, ws, host):
        """``CoupledModel.stage_head`` on the gathered surface layer."""
        state = unpack_state(ws, host)
        o = state.ocean
        nt = o.t.shape[0]
        surf = gather_field(torch.cat([o.t[:, 0], o.u[:, 0]]), self.mesh,
                            self.jmt, self.imt).contiguous()
        # the full velocity of the surface level (its level 0; the lower
        # levels broadcast from it are not used)
        u0 = self.model.ocean.full_velocity(surf[nt:, None], o.psi0)[:, 0]
        out = self.model.head_fields(ws, state, surf[:nt], u0[0], u0[1])
        out["ocean_surf"] = surf[:nt]
        return out

    def stage_mid(self, ws, host):
        """``CoupledModel.stage_mid`` on the surface layer gathered at the
        head and the gathered bottom water; the whole forcing kept, each
        rank's block of it (``block/*``) for the ocean steps."""
        m = self.model
        state = unpack_state(ws, host)
        bottom = None
        if m._sed_on:
            bottom = gather_field(bottom_water(state.ocean.t, self._sed_kb),
                                  self.mesh, self.jmt, self.imt)
        out = m.mid_fields(ws, state, ws["ocean_surf"], bottom)
        whole = {k: out["forcing/" + k] for k in m.forcing_names}
        out.update({"block/" + k: v for k, v in shard_pytree(
            whole, self.mesh, self.jmt, self.imt).items()})
        return out

    def stage_ocean(self, ws, host, leapfrog):
        """One step on the block and its per-step means: those that read
        neighbours on the block padded by one exchange of the new
        temperature and velocity, with the external-mode velocity of the
        replicated ``psi0`` (as ``CoupledModel.stage_ocean`` passes it to
        ``full_velocity`` in every mode)."""
        m, ss = self.model, self.ss
        state = unpack_state(ws, host)
        forcing = make_forcing(**{k: ws["block/" + k]
                                  for k in m.forcing_names})
        oc = ss.step(state.ocean, forcing, leapfrog=leapfrog, scan=True)
        w, bag = ss.w, ss.bag
        tT, ui = pack_exchange_ring([oc.t[0], oc.u], w, self.mesh, ss.pad)
        uf = ss.full_velocity(ui, ss.ext_velocity(oc.psi0))
        vet, vnt, vbt, *_ = adv_vel(uf[0], uf[1], bag, ss.bc)
        tav = step_means(tT, E(tT), uf, vet, vnt, vbt, bag, bag.diff_cbt,
                         m.cfg.ocean.ah)
        return m.ocean_fields(ws, host, oc,
                              {k: crop(v, w) for k, v in tav.items()},
                              ss.last_cg_iters)

    def stage_tail(self, ws, host):
        """``CoupledModel.stage_tail`` on the block: the bolus velocities
        of the halo-padded block, the convection extent of the block."""
        m, ss = self.model, self.ss
        om, cfg = m.ocean, m.cfg.ocean
        t = unpack_state(ws, host).ocean.t
        out = m.tail_means(ws)
        if cfg.isopycmix and cfg.gent_mcwilliams:
            from ..models.ocean.isopyc import compute_isopyc
            w, bag = ss.w, ss.bag
            tp, = pack_exchange_ring([t[:2]], w, self.mesh, ss.pad)
            iso = compute_isopyc(tp, bag.tmask, bag.kmt, om.eos_c, om.eos_to,
                                 om.eos_so, bag, cfg, ss.bc,
                                 addisop=bag.addisop)
            out.update({k: crop(v, w)
                        for k, v in bolus_means(iso, bag.diff_cbt).items()})
        if cfg.convection == "full":
            out.update(m.convection_means(t, ss.kmt))
        return out

    # ------------------------------------------------------------------
    def run_segment(self, block_state):
        """One coupled segment on this rank's block state (every rank
        together); the records as ``CoupledModel.run_segment`` keeps
        them, the ocean's 3-D means on the block."""
        return run_stages(self, block_state)

    def run(self, block_state, nseg: int):
        """``nseg`` segments, ``relyr`` (the model's) advancing by a
        segment each, the transient forcing (when set) taken at each
        segment's year, as ``CoupledModel.run`` does eagerly."""
        m = self.model
        seg_days = m.cfg.time.segtim_days
        yrlen = 360.0 if m.cfg.time.eqyear else 365.0
        for _ in range(nseg):
            if m.transient is not None:
                m._update_transient()
            block_state = self.run_segment(block_state)
            m.relyr += seg_days / yrlen
        return block_state


def replicated_digest(block_state) -> str:
    """A digest of every field that each rank holds whole: the
    atmosphere, ice, land, CPTS and sediment states and the ocean's
    replicated barotropic fields (ranks that agree bitwise give the same
    digest)."""
    h = hashlib.sha256()
    for k, v in sorted(pack_state(block_state).items()):
        if not k.startswith("ocean/") or k[6:] in REPLICATED:
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()
