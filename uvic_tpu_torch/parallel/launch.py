"""Start the ranks of a mesh on this machine and collect their results.

``spawn(fn, mesh_shape, backend, device, timeout_s, *args)`` starts
``ny*nx`` processes with the ``spawn`` start method (never ``fork``:
the parent may already hold a CUDA context), joins them into one
process group through a ``file://`` store in a temporary directory (no
port to race for when several test workers spawn at once), and calls
``fn(mesh, *args)`` on each rank, ``mesh`` its ``RankMesh``.  ``fn``
must be importable by name (a module-level function).  The ranks'
return values come back in rank order.  Each rank runs its host work
(PyTorch on the CPU, NumPy's BLAS) on one thread: eight ranks of eight
threads each on an eight-core host spend their time spinning.

A rank that raises fails the whole run: the others are killed and
``spawn`` raises ``RankFailed`` with that rank's traceback.  A run that
outlives ``timeout_s`` is killed and raises ``TimeoutError``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback

from .. import resolve_device


_ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
               "MKL_NUM_THREADS": "1"}


class RankFailed(RuntimeError):
    """A rank of ``spawn`` raised or died."""


def _entry(rank, world, mesh_shape, backend, device, tmp, timeout_s):
    """The rank's main function (the target of each spawned process)."""
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        import torch
        import torch.distributed as dist

        from .mesh import make_mesh
        torch.set_num_threads(1)
        if device.startswith("cuda"):
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "store"),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = make_mesh(mesh_shape, device=device)
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, mesh_shape, backend: str = "gloo", device=None,
          timeout_s: float = 300.0, *args) -> list:
    """Run ``fn(mesh, *args)`` on the ranks of a ``mesh_shape`` mesh;
    ``device`` is each rank's device (``cuda`` unless asked otherwise).
    Returns the ranks' results in rank order."""
    device = str(resolve_device(device))
    world = int(mesh_shape[0]) * int(mesh_shape[1])
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="uvic_ranks_") as tmp:
        # the call goes through a file: a large argument written down the
        # start pipe would hold each start until its rank had read it
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_entry, name=f"rank{r}",
                             args=(r, world, tuple(mesh_shape), backend,
                                   device, tmp, timeout_s))
                 for r in range(world)]
        saved = {k: os.environ.get(k) for k in _ONE_THREAD}
        os.environ.update(_ONE_THREAD)    # read by BLAS as a rank starts
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout_s
        try:
            _join(procs, deadline, tmp, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10.0)
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _join(procs, deadline, tmp, timeout_s):
    """Wait for every rank; raise at the first failure or at the
    deadline."""
    waiting = {p.sentinel: p for p in procs}
    while waiting:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                f"ranks {sorted(int(p.name[4:]) for p in waiting.values())}"
                f" still running after {timeout_s:g} s")
        for s in multiprocessing.connection.wait(list(waiting), left):
            p = waiting.pop(s)
            p.join()
            if p.exitcode != 0:
                rank = int(p.name[4:])
                path = os.path.join(tmp, f"error_{rank}.txt")
                text = ""
                if os.path.exists(path):
                    with open(path) as f:
                        text = f.read()
                raise RankFailed(f"rank {rank} exited with code "
                                 f"{p.exitcode}\n{text}")
