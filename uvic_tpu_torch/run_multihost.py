"""Multi-process launcher of the rank-decomposed ocean step (the twin of
``scripts/run_multihost.py``).

    # one process per rank, the same command on every host:
    python -m uvic_tpu_torch.run_multihost --coordinator HOST0:1234 \\
        --num-processes 4 --process-id $RANK [--mesh 2,2] [--steps 20]

    # under torchrun, which sets RANK, WORLD_SIZE, MASTER_ADDR and
    # MASTER_PORT:
    torchrun --nproc-per-node 4 -m uvic_tpu_torch.run_multihost --mesh 2,2

    # N gloo ranks on this host's CPU (a check without a card):
    python -m uvic_tpu_torch.run_multihost --cpu-mesh 8

    # one process, no process group:
    python -m uvic_tpu_torch.run_multihost --steps 5

Each process is one rank of the (y, x) mesh and holds one block of the
standard 102x102x19 grid (``ModelConfig()`` in float32); the ranks step
it through ``parallel.shard_step.ShardedOceanStep`` (one halo exchange
a step, the barotropic solve replicated), where the JAX script lets XLA
partition the step (GSPMD).  The mesh is chosen as the JAX script
chooses it from the same arguments, the ranks standing for its devices:
``--mesh`` when it divides the grid, else (and without ``--mesh``) the
largest divisible mesh of at most as many ranks.  The ranks run on the
card (``--device cpu`` to ask otherwise; ``--cpu-mesh`` runs on the
CPU) and talk through the process group's backend (``--backend``,
gloo by default: with CUDA tensors its messages are staged through the
host; nccl takes one card per rank).

Rank 0 prints the steps' time and a state checksum and, with ``--out``,
writes them as JSON: processes, global_devices (ranks of the mesh, one
device each), local_devices (devices of one process), mesh, steps,
ms_per_step, checksum_t0, checksum_ke, nan.  A NaN, or a failing rank,
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

JMT = IMT = 102        # the standard grid (size.h:27)


def choose_mesh(mesh_arg, ndev, jmt=JMT, imt=IMT):
    """The JAX script's mesh choice (``scripts/run_multihost.py``):
    ``mesh_arg`` ("ny,nx") when it divides (jmt, imt), else the largest
    divisible mesh of at most ``ndev`` ranks; (1, 1) by default without
    ``mesh_arg`` on one rank."""
    shape = tuple(int(v) for v in mesh_arg.split(",")) if mesh_arg \
        else (1, 1)

    def largest(divisible):
        best = (1, 1)
        for ny in (1, 2, 3, 6):
            for nx in (1, 2, 3, 6, 17):
                if ny * nx <= ndev and ny * nx > best[0] * best[1] \
                        and (not divisible
                             or (jmt % ny == 0 and imt % nx == 0)):
                    best = (ny, nx)
        return best
    if jmt % shape[0] or imt % shape[1]:
        best = largest(True)
        print(f"mesh {shape} does not divide ({jmt},{imt}); using {best}",
              flush=True)
        return best
    if not mesh_arg:
        return largest(False)
    return shape


def rank_run(mesh, steps):
    """One rank's run: the cold-start state of ``ModelConfig()`` in
    float32, a first sharded leapfrog step, then ``steps`` timed ones.
    Returns the JSON fields on rank 0 (None elsewhere)."""
    from .config import ModelConfig
    from .models.ocean.model import make_forcing, make_ocean
    from .parallel.mesh import gather_pytree, shard_pytree
    from .parallel.shard_step import ShardedOceanStep

    m = make_ocean(ModelConfig().replace(dtype="float32"),
                   device=mesh.device)
    g = m.params.grid
    t0 = np.zeros((m.nt, g.km, g.jmt, g.imt))
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None]
    t0 *= np.asarray(m.params.topo.tmask)
    yu = np.asarray(g.yu)
    taux = np.sin(np.deg2rad(yu * 3))[:, None] * np.ones((1, g.imt))
    smf = torch.as_tensor(np.stack([taux / 1.035, np.zeros_like(taux)]),
                          dtype=m.dtype, device=mesh.device)
    stf = torch.zeros((m.nt, g.jmt, g.imt), dtype=m.dtype,
                      device=mesh.device)
    ss = ShardedOceanStep(m, mesh)
    state = shard_pytree(m.init_state(t0), mesh, g.jmt, g.imt)
    forcing = shard_pytree(make_forcing(smf, stf), mesh, g.jmt, g.imt)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    state = ss.step(state, forcing, leapfrog=True)
    sync()
    ex0 = mesh.exchange_s
    t_start = time.perf_counter()
    for _ in range(steps):
        state = ss.step(state, forcing, leapfrog=True)
    sync()
    dt_step = (time.perf_counter() - t_start) / max(steps, 1)
    exchange_ms = (mesh.exchange_s - ex0) / max(steps, 1) * 1e3
    full = gather_pytree(state, mesh, g.jmt, g.imt, root=0)
    if full is None:
        return None
    return dict(
        ms_per_step=round(dt_step * 1e3, 2),
        exchange_ms_per_step=round(exchange_ms, 2),
        transport=mesh.transport,
        nan=bool(torch.isnan(full.t).any()),
        checksum_t0=float(torch.sum(full.t[0], dtype=torch.float32)),
        checksum_ke=float(torch.sum(full.u ** 2, dtype=torch.float32)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (one process per rank)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--mesh", default=None,
                   help="ny,nx (default: the largest divisible mesh of "
                        "the ranks)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--cpu-mesh", type=int, default=0,
                   help="spawn N gloo ranks on this host's CPU")
    p.add_argument("--out", default=None,
                   help="write a JSON artifact (rank 0): mesh, ranks, "
                        "ms/step, state checksum")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--device", default=None,
                   help="the ranks' device (default cuda; cpu with "
                        "--cpu-mesh)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    from .parallel.launch import spawn
    from .parallel.mesh import make_mesh

    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.cpu_mesh:
        ndev, processes, device = args.cpu_mesh, None, "cpu"
    elif args.coordinator is not None:
        ndev = processes = args.num_processes
        device = args.device
    elif torchrun:
        ndev = processes = int(os.environ["WORLD_SIZE"])
        device = args.device
    else:
        ndev, processes, device = 1, 1, args.device
    shape = choose_mesh(args.mesh, ndev)
    n = shape[0] * shape[1]
    print(f"mesh {shape} over {n} of {ndev} rank(s)", flush=True)

    if args.cpu_mesh:
        out = spawn(rank_run, shape, args.backend, device, 1800.0,
                    args.steps)[0]
        processes = n
    elif processes == 1:
        out = rank_run(make_mesh(shape, device=device), args.steps)
    else:
        if args.coordinator is not None:
            init, rank = f"tcp://{args.coordinator}", args.process_id
        else:
            init, rank = "env://", int(os.environ["RANK"])
        if device is None and torch.cuda.is_available():
            device = f"cuda:{rank % torch.cuda.device_count()}"
        dist.init_process_group(args.backend, init_method=init,
                                world_size=processes, rank=rank)
        try:
            out = rank_run(make_mesh(shape, device=device), args.steps)
        finally:
            dist.destroy_process_group()
    if out is None:
        return 0
    print(f"{args.steps} sharded steps: {out['ms_per_step']:.2f} ms/step "
          f"({out['exchange_ms_per_step']:.2f} ms in messages, "
          f"{out['transport']}), nan={out['nan']} "
          f"checksum={out['checksum_t0']!r}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(
                processes=processes, global_devices=n, local_devices=1,
                mesh=list(shape), steps=args.steps,
                ms_per_step=out["ms_per_step"],
                checksum_t0=out["checksum_t0"],
                checksum_ke=out["checksum_ke"], nan=out["nan"]), f)
    return 1 if out["nan"] else 0


if __name__ == "__main__":
    sys.exit(main())
