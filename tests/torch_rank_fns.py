"""Rank functions of the tests of ``uvic_tpu_torch.parallel``.

``launch.spawn`` runs them in fresh processes, which import this module
by name: it imports the port and nothing of JAX.
"""

import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed

from uvic_tpu_torch.convert import ocean_state_from_numpy
from uvic_tpu_torch.coupler.driver import CoupledModel, pack_state
from uvic_tpu_torch.diag.conservation import ConservationAudit
from uvic_tpu_torch.diag.tsi import TsiDiagnostics
from uvic_tpu_torch.models.ocean.model import make_forcing, make_ocean
from uvic_tpu_torch.parallel.halo import (exchange_pad, pack_exchange,
                                          pack_exchange_ring)
from uvic_tpu_torch.parallel.mesh import (RankMesh, gather_coupled,
                                          gather_pytree, local_block,
                                          make_mesh, shard_coupled,
                                          shard_pytree)
from uvic_tpu_torch.parallel.shard_segment import (ShardedCoupledModel,
                                                   replicated_digest)
from uvic_tpu_torch.parallel.shard_step import ShardedOceanStep


def block(a, mesh):
    """The rank's block of a global array that the mesh divides."""
    ny, nx = mesh.shape
    ly, lx = a.shape[-2] // ny, a.shape[-1] // nx
    return torch.as_tensor(a[..., mesh.iy * ly:(mesh.iy + 1) * ly,
                             mesh.ix * lx:(mesh.ix + 1) * lx])


def halo_rounds(mesh, exchanges, packs, fields, jmt, imt, bad_shape):
    """On the 8 ranks of ``mesh``, meshes of other shapes over the same
    ranks: each of ``exchanges`` (shape, w, gx, array) through
    ``exchange_pad`` and each of ``packs`` (shape, w, gx, arrays)
    through ``pack_exchange``, the rank's padded blocks; ``fields`` cut
    by ``shard_pytree`` and joined by ``gather_pytree`` (on every rank,
    and on rank 0 only); the error of ``make_mesh(bad_shape)``."""
    out = dict(exchange=[], pack=[])
    for shape, w, gx, a in exchanges:
        m = make_mesh(shape, device="cpu")
        out["exchange"].append(exchange_pad(block(a, m), w, m, gx).numpy())
    for shape, w, gx, arrays in packs:
        m = make_mesh(shape, device="cpu")
        got = pack_exchange([block(a, m) for a in arrays], w, m, gx)
        out["pack"].append([g.numpy() for g in got])
    tree = {k: torch.as_tensor(v) for k, v in fields.items()}
    cut = shard_pytree(tree, mesh, jmt, imt)
    out["blocks"] = {k: v.numpy() for k, v in cut.items()}
    out["gathered"] = {k: v.numpy() for k, v in
                       gather_pytree(cut, mesh, jmt, imt).items()}
    root = gather_pytree(cut, mesh, jmt, imt, root=0)
    out["root_only"] = None if root is None else sorted(root)
    try:
        make_mesh(bad_shape, device="cpu")
        out["bad_mesh"] = None
    except ValueError as e:
        out["bad_mesh"] = str(e)
    out["transport"] = mesh.transport
    return out


def call_all(mesh, calls):
    """Several rank functions on one set of ranks: ``calls`` is a list
    of (function, keyword arguments); returns the list of results."""
    return [fn(mesh, **kw) for fn, kw in calls]


def call_on_meshes(mesh, meshes):
    """Several meshes on one set of ranks: ``meshes`` is a list of
    (shape, calls); for each, ``make_mesh(shape)`` over the world's first
    ny*nx ranks (None on the others, which skip its calls) and
    ``call_all`` on it.  Returns one entry a shape: the calls' results,
    None on a rank off that mesh."""
    out = []
    for shape, calls in meshes:
        m = make_mesh(shape, device=mesh.device)
        out.append(None if m is None else call_all(m, calls))
    return out


def scan_mixing_step(mesh, cfg, state, forcing):
    """One mixing step of ``ShardedOceanStep.step(..., scan=True)`` from
    the global ``state`` and ``forcing`` (NumPy, ``convert``'s and
    ``make_forcing``'s names): the gathered tracers on rank 0, None
    elsewhere."""
    m = make_ocean(cfg, device="cpu")
    g = m.params.grid
    ss = ShardedOceanStep(m, mesh)
    s = shard_pytree(ocean_state_from_numpy(state, "cpu", m.dtype), mesh,
                     g.jmt, g.imt)
    f = shard_pytree(make_forcing(**{k: torch.as_tensor(v)
                                     for k, v in forcing.items()}),
                     mesh, g.jmt, g.imt)
    t = gather_pytree(ss.step(s, f, leapfrog=False, scan=True), mesh,
                      g.jmt, g.imt, root=0)
    return None if t is None else t.t.numpy()


def coupled_numpy(state, tavg=None, forcing=None):
    """A ``CoupledState`` (and a segment's time means and forcing) as
    one dict of NumPy arrays under the workspace's names, with the
    host counters."""
    out = {k: v.cpu().numpy() for k, v in pack_state(state).items()}
    for prefix, d in (("tavg/", tavg), ("forcing/", forcing)):
        out.update({prefix + k: v.cpu().numpy()
                    for k, v in (d or {}).items() if v is not None})
    out.update(itt=state.ocean.itt, nats=state.atm.nats)
    return out


def coupled_segment(mesh, cfg, itt=None, halo=None):
    """One ``ShardedCoupledModel`` segment of ``cfg`` from the model's
    ``init_state`` (the ocean's ``itt`` set when given): on rank 0 the
    gathered state, time means and forcing (``coupled_numpy``), and on
    every rank its ``replicated_digest``, CG iterations and BiCGSTAB
    trips."""
    m = CoupledModel(cfg, device=mesh.device)
    state = m.init_state()
    if itt is not None:
        state.ocean.itt = itt
    sm = ShardedCoupledModel(m, mesh, halo=halo)
    out = sm.run_segment(sm.shard(state))
    whole = sm.gather(out, root=0)
    tavg = sm.gather_tavg(root=0)
    return dict(
        state=None if whole is None else coupled_numpy(
            whole, tavg, sm.last_forcing),
        digest=replicated_digest(out), cg_iters=sm.seg_cg_iters.numpy(),
        trips=sm.seg_trips.numpy())


def transient_forcing():
    """A transient forcing with changes within the first two segments
    of the small configuration's calendar (years 0 to 0.028), the port's
    twin of ``tests/test_torch_forcing.py``'s."""
    from uvic_tpu_torch.io.forcing import TransientForcing, TransientSeries
    S = TransientSeries
    return TransientForcing(
        co2=S(np.array([0.0, 0.03]), np.array([280.0, 1120.0])),
        solar=S.constant(1.368e6),
        volcanic=S(np.array([0.0, 0.01, 0.02]), np.array([0.0, 3e4, 0.0])),
        c14=S.constant(0.0),
        sulph=S(np.array([0.0, 0.03]), np.array([0.01, 0.05])),
        agg=S(np.array([0.0, 0.03]), np.array([0.0, 2e3])),
        landice=S(np.array([0.0, 0.03]), np.array([0.4, 1.0])))


def coupled_model(cfg, device, t0=None, transient=False, awind_clim=None):
    """A ``CoupledModel`` of ``cfg`` and its ``init_state(t0)``, with the
    transient forcing of ``transient_forcing`` and the anomalous-wind
    climatology ``awind_clim`` when asked for."""
    m = CoupledModel(cfg, device=device)
    state = m.init_state(t0)
    if transient:
        m.set_transient_forcing(transient_forcing())
    if awind_clim is not None:
        m.awind.set_climatology(awind_clim)
    return m, state


def coupled_run(mesh, cfg, t0=None, nseg=1, transient=False,
                awind_clim=None):
    """``nseg`` segments of ``ShardedCoupledModel.run`` from
    ``coupled_model``'s state: on rank 0 the gathered state, time means
    and forcing after the last (``coupled_numpy``), and on every rank
    its ``replicated_digest``, and each segment's CG iterations and
    BiCGSTAB trips."""
    m, state = coupled_model(cfg, mesh.device, t0, transient, awind_clim)
    sm = ShardedCoupledModel(m, mesh)
    block = sm.shard(state)
    cg_iters, trips = [], []
    for _ in range(nseg):
        block = sm.run(block, 1)
        cg_iters.append(sm.seg_cg_iters.numpy())
        trips.append(sm.seg_trips.numpy())
    whole = sm.gather(block, root=0)
    tavg = sm.gather_tavg(root=0)
    return dict(
        state=None if whole is None else coupled_numpy(
            whole, tavg, sm.last_forcing),
        digest=replicated_digest(block), cg_iters=cg_iters, trips=trips)


def coupled_roundtrip(mesh, cfg):
    """A coupled state cut by ``shard_coupled`` and joined by
    ``gather_coupled`` (on rank 0), with the ocean's block shapes and
    whether the other components stayed the same objects."""
    m = CoupledModel(cfg, device="cpu")
    state = m.init_state()
    cut = shard_coupled(state, mesh, m.grid.jmt, m.grid.imt)
    back = gather_coupled(cut, mesh, m.grid.jmt, m.grid.imt, root=0)
    return dict(
        whole=None if back is None else coupled_numpy(back),
        ref=coupled_numpy(state), t_block=tuple(cut.ocean.t.shape),
        psi_block=tuple(cut.ocean.psi0.shape),
        same=[getattr(cut, k) is getattr(state, k)
              for k in ("atm", "ice", "land", "sed", "cpts")])


def diag_rows(mesh, cfg, state, atm_ice=None):
    """The deterministic tsi row and audit inventories of the rank's
    block of ``state`` (NumPy, ``convert``'s names); ``atm_ice`` (the
    atmosphere's ``at``, the ice's ``aice`` and ``hice``) whole."""
    m = make_ocean(cfg, device="cpu")
    g = m.params.grid
    s = shard_pytree(ocean_state_from_numpy(state, "cpu", m.dtype), mesh,
                     g.jmt, g.imt)
    atm = ice = None
    if atm_ice is not None:
        at, aice, hice = (torch.as_tensor(a) for a in atm_ice)
        atm, ice = SimpleNamespace(at=at), SimpleNamespace(aice=aice,
                                                           hice=hice)
    row = TsiDiagnostics(m, deterministic=True).compute(s, atm, ice,
                                                        mesh=mesh)
    inv = ConservationAudit(m, deterministic=True).inventories(s, mesh=mesh)
    return dict(row=row, inventories=inv)


def raise_on(mesh, rank):
    """Raise on ``rank``; the others return."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} raises on purpose")
    return mesh.rank


def hang_on(mesh, rank):
    """Hang on ``rank``; the others return."""
    if mesh.rank == rank:
        time.sleep(3600)
    return mesh.rank



def raise_after_peers_die(mesh, rank):
    """The launcher's blame race, forced: ``rank`` closes its connections
    at once, so that its peers, waiting on it in a gather, die of the
    transport first; it raises only a second later."""
    if mesh.rank == rank:
        torch.distributed.destroy_process_group()
        time.sleep(1.0)
        raise ValueError(f"rank {rank} raises on purpose")
    mesh.all_gather(torch.zeros(1))
    return mesh.rank


def part_of_the_world(mesh, shape, big, field):
    """On a world larger than ``shape``: ``make_mesh(shape)``, None on
    the ranks beyond it; on its ranks, a gather, an exchange with the x
    neighbours and ``gather_pytree(..., root=0)`` of ``field`` through
    the mesh's group; the error of ``make_mesh(big)``.  Every rank then
    waits for the others at a barrier of the world."""
    m = make_mesh(shape, device="cpu")
    out = dict(idle=m is None)
    if m is not None:
        out["rank"] = m.rank
        out["gathered"] = [int(t) for t in
                           m.all_gather(torch.tensor([m.rank]))]
        east, west = m.x_neighbours()
        got = m.exchange([(torch.tensor([10 + m.rank]), east, 7)],
                         [(torch.tensor([0]), west, 7)])
        out["from_west"] = int(got[0])
        jmt, imt = field.shape
        cut = shard_pytree({"a": torch.as_tensor(field)}, m, jmt, imt)
        root = gather_pytree(cut, m, jmt, imt, root=0)
        out["root"] = None if root is None else root["a"].numpy()
    try:
        make_mesh(big, device="cpu")
        out["big"] = None
    except ValueError as e:
        out["big"] = str(e)
    torch.distributed.barrier()
    return out


def with_one_tag(mesh, fn, **kw):
    """``fn(mesh, **kw)`` with every message of ``RankMesh.exchange``
    under one tag: gloo then pairs a rank's sends and receives by peer
    and posting order alone, as NCCL does.  Returns (the result, the
    messages sent under the one tag)."""
    exchange = RankMesh.exchange
    sent = []

    def one_tag(self, sends, recvs):
        sent.append(len(sends))
        return exchange(self, [(t, peer, 0) for t, peer, _ in sends],
                        [(t, peer, 0) for t, peer, _ in recvs])
    RankMesh.exchange = one_tag
    try:
        return fn(mesh, **kw), sum(sent)
    finally:
        RankMesh.exchange = exchange


def ring_blocks(mesh, fields, w):
    """The rank's blocks of the global (..., jmt, imt) ``fields`` padded
    through ``pack_exchange_ring`` (pad: the window's columns beyond
    imt on this mesh), as NumPy."""
    jmt, imt = fields[0].shape[-2:]
    pad = -(-imt // mesh.shape[1]) * mesh.shape[1] - imt
    blocks = [local_block(torch.as_tensor(a), mesh, jmt, imt)
              for a in fields]
    return [b.numpy() for b in pack_exchange_ring(blocks, w, mesh, pad)]
