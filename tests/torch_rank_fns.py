"""Rank functions of the tests of ``uvic_tpu_torch.parallel``.

``launch.spawn`` runs them in fresh processes, which import this module
by name: it imports the port and nothing of JAX.
"""

import time

import torch

from uvic_tpu_torch.parallel.halo import exchange_pad, pack_exchange
from uvic_tpu_torch.parallel.mesh import (gather_pytree, make_mesh,
                                          shard_pytree)
from uvic_tpu_torch.parallel.shard_step import run_sharded


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


def run_sharded_jobs(mesh, jobs):
    """Several ``run_sharded`` runs on one set of ranks (one process
    start and one process group for them all): ``jobs`` is a list of
    dicts of its keyword arguments; returns the list of their results."""
    return [run_sharded(mesh, **job) for job in jobs]


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

