"""The (y, x) mesh of ranks, and global fields cut into rank blocks.

Port of ``uvic_tpu.parallel.mesh`` onto ``torch.distributed``.  One
rank (one process) holds one block of a ``(ny, nx)`` mesh over the
trailing ``(jmt, imt)`` axes: rank r sits at ``(iy, ix) = divmod(r,
nx)``.  Its x neighbours are cyclic (the zonal ring), its y neighbours
walled (None beyond the first and last latitude band).

The caller's process group decides the backend, and with it the
transport of every message (``RankMesh.transport``):

- ``nccl``: device tensors, one card per rank, card to card;
- ``gloo`` with CPU tensors: the ranks' tensors as they are;
- ``gloo`` with CUDA tensors: every message is copied to the host, sent,
  and copied back to the card (``host_staged``); gloo's point-to-point
  calls take CPU tensors only.  This is how several ranks share one
  card, where NCCL refuses two ranks on one GPU.

NCCL ignores tags: it matches the messages between two ranks by the
order in which each posts them.  Every exchange of the port posts its
messages so that this order alone pairs each send with its receive (a
rank posts its messages to one peer in the order that peer posts its
receives from it), so the tags only name the messages for gloo.

A ``(1, 1)`` mesh needs no process group: every exchange stays local.
A mesh may use part of the process group (``make_mesh``): on a world
larger than ny*nx, ranks 0..ny*nx-1 form the mesh on a group of their
own, and the others idle, as the reference's run lays a (2, 3) mesh over
8 devices and 6 of them take part.

The reference lets XLA partition any step function over its mesh
(``mesh.shard_step``, GSPMD); PyTorch has no counterpart that would
partition the port's hand-written kernels, so the port shards the
ocean step explicitly (``shard_step.ShardedOceanStep``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from .halo import crop_window, pad_window

# barotropic fields: replicated on every rank between steps (the
# barotropic solve runs identically on every rank)
REPLICATED = frozenset(("psi0", "psi1", "ptd", "ptdb", "ubar", "ubarm1"))


class RankMesh:
    """This rank's place in the mesh and the messages it exchanges.

    ``exchange_s`` sums the seconds spent in exchanges and gathers,
    host staging included (on a card, from the end of the work queued
    before them to the end of the messages).  ``device`` names the
    rank's card (``cuda:<index>``; a bare ``cuda`` is the current
    card).  ``group`` is the process group of the mesh's ranks
    (None: the default group, which then holds exactly them); ``rank``
    and every peer are ranks of the mesh, which are the group's."""

    def __init__(self, shape, device, axis_names=("y", "x"),
                 rank: int = 0, backend: str | None = None, group=None):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.size = self.shape[0] * self.shape[1]
        self.rank = int(rank)
        self.iy, self.ix = divmod(self.rank, self.shape[1])
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = backend
        self.group = group
        self.host_staged = backend == "gloo" and self.device.type == "cuda"
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl process group needs ranks on cuda")
        self.exchange_s = 0.0
        self.messages = 0

    @property
    def transport(self) -> str:
        if self.backend is None:
            return "local (one rank)"
        if self.host_staged:
            return "gloo, CUDA tensors staged through the host"
        return f"{self.backend}, {self.device.type} tensors"

    def rank_of(self, iy: int, ix: int) -> int:
        return iy * self.shape[1] + ix % self.shape[1]

    def x_neighbours(self):
        """(east, west) ranks on the cyclic x ring."""
        return (self.rank_of(self.iy, self.ix + 1),
                self.rank_of(self.iy, self.ix - 1))

    def y_neighbours(self):
        """(north, south) ranks on the walled y line; None at a wall."""
        ny = self.shape[0]
        return (self.rank_of(self.iy + 1, self.ix) if self.iy + 1 < ny
                else None,
                self.rank_of(self.iy - 1, self.ix) if self.iy > 0 else None)

    def _global(self, rank: int) -> int:
        """The process group's global rank of the mesh's ``rank``."""
        return rank if self.group is None \
            else dist.get_global_rank(self.group, rank)

    def _clock(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def exchange(self, sends, recvs) -> list:
        """One round of point-to-point messages.  ``sends``: (tensor,
        peer, tag); ``recvs``: (tensor of the message's shape and dtype,
        peer, tag).  Returns the received tensors on the mesh's device,
        in the order of ``recvs``.  The k-th receive from a peer takes
        the k-th message that peer sends this rank in its round (NCCL
        matches by that order; gloo by peer and tag)."""
        t0 = self._clock()
        stage = self.host_staged
        ops, outs = [], []
        for t, peer, tag in sends:
            buf = t.cpu().contiguous() if stage else t.contiguous()
            ops.append(dist.P2POp(dist.isend, buf, self._global(peer),
                                  self.group, tag=tag))
        for like, peer, tag in recvs:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if stage else self.device)
            ops.append(dist.P2POp(dist.irecv, buf, self._global(peer),
                                  self.group, tag=tag))
            outs.append(buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if stage:
            outs = [o.to(self.device) for o in outs]
        self.messages += len(sends)
        self.exchange_s += self._clock() - t0
        return outs

    def all_gather(self, t) -> list:
        """Every rank's ``t`` (same shape on all), in rank order."""
        if self.backend is None:
            return [t]
        t0 = self._clock()
        buf = t.cpu().contiguous() if self.host_staged else t.contiguous()
        outs = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(outs, buf, group=self.group)
        if self.host_staged:
            outs = [o.to(self.device) for o in outs]
        self.messages += self.size - 1
        self.exchange_s += self._clock() - t0
        return outs

    def row_gather(self, t, tag: int) -> list:
        """The ``t`` of every rank in this rank's x ring (same shape on
        all), in x order: messages to and from each peer of the ring."""
        nx = self.shape[1]
        peers = [self.rank_of(self.iy, ix) for ix in range(nx)
                 if ix != self.ix]
        got = self.exchange([(t, p, tag) for p in peers],
                            [(t, p, tag) for p in peers])
        got.insert(self.ix, t)
        return got


def make_mesh(shape=(1, 1), axis_names=("y", "x"), device=None):
    """This process's rank in a ``shape`` mesh over the default process
    group.  Without a process group only the (1, 1) mesh exists.
    ``device``: the rank's device, ``cuda`` unless the caller asks for
    another.

    The mesh may use part of the group, as the reference's run lays a
    (2, 3) mesh over 8 devices, of which 6 take part: on a world larger
    than ny*nx, ranks 0..ny*nx-1 form the mesh on a group of their own
    (``dist.new_group``, which every rank of the world joins), and the
    others get None: they do no work and should wait for the mesh's
    ranks at a barrier of the world before they leave.  A mesh larger
    than the world raises.

    The mesh's ranks then meet at a barrier of its group, so that no
    batch of point-to-point messages is the group's first call (NCCL
    needs every rank of a group in a first call of that kind)."""
    device = resolve_device(device)
    n = int(np.prod(shape))
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world < n:
            raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the "
                             f"process group has {world}")
        group = dist.new_group(list(range(n))) if world > n else None
        rank = dist.get_rank()
        if rank >= n:
            return None
        dist.barrier(group=group)
        return RankMesh(shape, device, axis_names, rank,
                        dist.get_backend(), group)
    if n != 1:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks and a "
                         "process group; none is initialised")
    return RankMesh(shape, device, axis_names)


def padded_window(jmt: int, imt: int, shape):
    """(jmt_p, imt_p): the window padded to multiples of the mesh."""
    ny, nx = shape
    return -(-jmt // ny) * ny, -(-imt // nx) * nx


def local_block(a, mesh: RankMesh, jmt: int, imt: int):
    """This rank's block of the padded window of a global (..., jmt, imt)
    field: periodic x images, zero rows beyond the wall."""
    jmt_p, imt_p = padded_window(jmt, imt, mesh.shape)
    ly, lx = jmt_p // mesh.shape[0], imt_p // mesh.shape[1]
    a = pad_window(a, jmt_p, imt_p)
    return a[..., mesh.iy * ly:(mesh.iy + 1) * ly,
             mesh.ix * lx:(mesh.ix + 1) * lx].contiguous()


def _is_spatial(name, a, jmt, imt):
    return (torch.is_tensor(a) and a.ndim >= 2 and name not in REPLICATED
            and tuple(a.shape[-2:]) == (jmt, imt))


def shard_pytree(tree, mesh: RankMesh, jmt: int, imt: int):
    """A dataclass (an ``OceanState``, a ``SurfaceForcing``) or a dict of
    global fields with this rank's block of every (..., jmt, imt) tensor
    in place of the global field; scalars, 0-D and 1-D tensors and the
    barotropic fields (``REPLICATED``) stay as they are."""
    def cut(name, a):
        return local_block(a, mesh, jmt, imt) \
            if _is_spatial(name, a, jmt, imt) else a
    if isinstance(tree, dict):
        return {k: cut(k, v) for k, v in tree.items()}
    return dataclasses.replace(tree, **{
        f.name: cut(f.name, getattr(tree, f.name))
        for f in dataclasses.fields(tree)})


def gather_field(a, mesh: RankMesh, jmt: int, imt: int):
    """The global (..., jmt, imt) field of the ranks' blocks ``a``."""
    ny, nx = mesh.shape
    blocks = mesh.all_gather(a.contiguous())
    rows = [torch.cat(blocks[iy * nx:(iy + 1) * nx], dim=-1)
            for iy in range(ny)]
    return crop_window(torch.cat(rows, dim=-2), jmt, imt)


def gather_pytree(tree, mesh: RankMesh, jmt: int, imt: int,
                  root: int | None = None):
    """Inverse of ``shard_pytree`` (the counterpart of ``jax.device_get``
    of a sharded array): the global fields assembled on every rank, or,
    with ``root``, on that rank of the mesh only (None elsewhere).  Every
    rank takes part either way.  A tensor whose block is not (ly, lx) — replicated
    barotropic fields, scalars — is taken as it is."""
    jmt_p, imt_p = padded_window(jmt, imt, mesh.shape)
    ly, lx = jmt_p // mesh.shape[0], imt_p // mesh.shape[1]

    def join(name, a):
        if (torch.is_tensor(a) and a.ndim >= 2 and name not in REPLICATED
                and tuple(a.shape[-2:]) == (ly, lx)):
            return gather_field(a, mesh, jmt, imt)
        return a
    if isinstance(tree, dict):
        out = {k: join(k, v) for k, v in tree.items()}
    else:
        out = dataclasses.replace(tree, **{
            f.name: join(f.name, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return out if root is None or mesh.rank == root else None


def shard_coupled(state, mesh: RankMesh, jmt: int, imt: int):
    """A ``CoupledState`` with its ocean cut as ``shard_pytree`` cuts an
    ``OceanState`` (psi0, psi1, ptd and ptdb replicated); the
    atmosphere, ice, land, CPTS and sediment states stay whole on every
    rank, and the host counters (``itt``, ``nats``) are the same on
    every rank."""
    return dataclasses.replace(
        state, ocean=shard_pytree(state.ocean, mesh, jmt, imt))


def gather_coupled(state, mesh: RankMesh, jmt: int, imt: int,
                   root: int | None = None):
    """Inverse of ``shard_coupled``: the ocean joined by
    ``gather_pytree`` (on every rank, or on ``root`` only, None
    elsewhere), the other components as they are."""
    ocean = gather_pytree(state.ocean, mesh, jmt, imt, root=root)
    return None if ocean is None else dataclasses.replace(state,
                                                          ocean=ocean)
