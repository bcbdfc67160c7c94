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
``spawn`` raises ``RankFailed`` with that rank's traceback.  No rank
enters ``fn`` before every rank has connected, and the rank blamed is
one whose own code failed: a rank that raises makes its peers die of
the transport (``Connection closed by peer``), sometimes before it has
exited itself, so on a failure ``spawn`` waits up to
``FAILURE_GRACE_S`` for another rank's traceback and names a rank that
died of the transport only if none other failed.  A run that outlives
``timeout_s`` is killed and raises ``TimeoutError``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import re
import tempfile
import time
import traceback

from .. import resolve_device


_ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
               "MKL_NUM_THREADS": "1"}


# seconds a failure waits for the other ranks' tracebacks
FAILURE_GRACE_S = 5.0
# what a rank's traceback says when it died because a peer went away
TRANSPORT = re.compile(r"Connection closed by peer|Connection reset by "
                       r"peer|connectFullMesh|Broken pipe")


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
            # every rank has connected before one can fail in fn
            dist.barrier()
            mesh = make_mesh(mesh_shape, device=device)
            out = fn(mesh, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # written whole, then renamed: the parent may read it at once
        path = os.path.join(tmp, f"error_{rank}.txt")
        with open(path + ".part", "w") as f:
            f.write(traceback.format_exc())
        os.replace(path + ".part", path)
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
    """Wait for every rank; raise at the first failure (``_blame``) or at
    the deadline."""
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
                raise _blame(procs, p, tmp)


def _error_text(tmp, p):
    """The traceback that the rank of process ``p`` wrote, or None."""
    path = os.path.join(tmp, f"error_{int(p.name[4:])}.txt")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def _blame(procs, first, tmp):
    """``RankFailed`` for the rank whose own code failed: ``first`` (the
    first rank seen to exit non-zero) unless its traceback is the
    transport's; then the first other rank whose traceback is not,
    waited for up to ``FAILURE_GRACE_S``; else ``first``."""
    order = [first] + [p for p in procs if p is not first]
    end = time.monotonic() + FAILURE_GRACE_S
    while True:
        texts = [(p, _error_text(tmp, p)) for p in order]
        own = [(p, t) for p, t in texts
               if t is not None and not TRANSPORT.search(t)]
        if own or time.monotonic() >= end \
                or not any(p.is_alive() for p in procs):
            break
        time.sleep(0.05)
    p, text = own[0] if own else texts[0]
    p.join(FAILURE_GRACE_S)
    return RankFailed(f"rank {int(p.name[4:])} exited with code "
                      f"{p.exitcode}\n{text or ''}")
