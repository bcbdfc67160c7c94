"""Multi-process launcher of the rank-decomposed ocean step (the twin of
``scripts/run_multihost.py``).

    # one process per rank, the same command on every host:
    python -m uvic_tpu_torch.run_multihost --coordinator HOST0:1234 \\
        --num-processes 4 --process-id $RANK [--mesh 2,2] [--steps 20]

    # under torchrun, which sets RANK, WORLD_SIZE, LOCAL_WORLD_SIZE,
    # MASTER_ADDR and MASTER_PORT (one launcher a host; here two
    # launchers of four ranks on one host, the wire path of two hosts):
    python -m torch.distributed.run --nnodes 2 --nproc-per-node 4 \\
        --node-rank $I --rdzv-backend c10d --rdzv-endpoint HOST0:1234 \\
        -m uvic_tpu_torch.run_multihost --mesh 2,3

    # four cards, one rank a card, device tensors card to card (the
    # mesh defaults to (2, 2), as the JAX script's for four devices):
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m uvic_tpu_torch.run_multihost --backend nccl

    # one launcher that spawns N ranks on this host (--cpu-mesh N: gloo
    # ranks on the CPU, a check without a card):
    python -m uvic_tpu_torch.run_multihost --spawn 8 --mesh 2,3
    python -m uvic_tpu_torch.run_multihost --cpu-mesh 8

    # one process, no process group:
    python -m uvic_tpu_torch.run_multihost --steps 5

Each rank of the (y, x) mesh is one process and holds one block of the
standard 102x102x19 grid (``ModelConfig()`` in float32); the ranks step
it through ``parallel.shard_step.ShardedOceanStep`` (one halo exchange
a step, the barotropic solve replicated), where the JAX script lets XLA
partition the step (GSPMD).  The mesh is chosen as the JAX script
chooses it from the same arguments, the ranks standing for its devices:
``--mesh`` when it divides the grid, else (and without ``--mesh``) the
largest divisible mesh of at most as many ranks.  The mesh may use part
of the process group, as the JAX script's does ("6 of the 8 devices
participate" in ``scripts/make_multihost_artifact.py``): ranks
0..ny*nx-1 form the mesh on a group of their own, the others do no work
and exit 0 once every rank has finished (``parallel.mesh.make_mesh``).
A launcher that spawns its ranks (``--spawn``, ``--cpu-mesh``) starts
only the mesh's.  The ranks run on the card (``--device cpu`` to ask
otherwise; ``--cpu-mesh`` runs on the CPU), each on the card of its
global rank modulo the host's cards (``parallel.launch.rank_card``),
and talk through the process group's backend (``--backend``, gloo by
default: with CUDA tensors its messages are staged through the host;
nccl takes one card per rank and moves device tensors card to card).

Rank 0 prints the steps' time and a state checksum and, with ``--out``,
writes them as JSON under the JAX script's keys, which map onto the
port so: a JAX process is a launcher (a ``torchrun`` node, the
``--spawn`` process, or a process of ``--coordinator``), a JAX device a
rank process.

- ``processes``: launchers;
- ``global_devices``: ranks in the world (idle ones included);
- ``local_devices``: ranks of one launcher (``LOCAL_WORLD_SIZE`` under
  ``torchrun``, the ranks spawned, else 1);
- ``mesh``, ``steps``, ``ms_per_step``, ``checksum_t0``,
  ``checksum_ke``, ``nan``: as the JAX script's.

With ``--status-dir DIR`` every rank also writes ``DIR/rank<R>.json``:
its rank, the world, whether it was on the mesh, the code it exits with
and, on the mesh, its card, the kernels' launches over the steps and
its step and message times; the mesh's rank 0 adds a SHA-256 digest of
the gathered state.
A NaN, or a failing rank, exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
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


# the gathered state's fields that --status-dir's digest covers
DIGEST_FIELDS = ("t", "tm1", "u", "um1", "psi0", "psi1", "ptd", "ptdb")


def cold_start(device):
    """The JAX script's model and start on ``device``: ``ModelConfig()``
    in float32, the exponential temperature profile at rest, a sin(3
    lat) zonal wind stress and no tracer fluxes.  (model, state,
    forcing), whole."""
    from .config import ModelConfig
    from .models.ocean.model import make_forcing, make_ocean
    m = make_ocean(ModelConfig().replace(dtype="float32"), device=device)
    g = m.params.grid
    t0 = np.zeros((m.nt, g.km, g.jmt, g.imt))
    t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None]
    t0 *= np.asarray(m.params.topo.tmask)
    yu = np.asarray(g.yu)
    taux = np.sin(np.deg2rad(yu * 3))[:, None] * np.ones((1, g.imt))
    smf = torch.as_tensor(np.stack([taux / 1.035, np.zeros_like(taux)]),
                          dtype=m.dtype, device=device)
    stf = torch.zeros((m.nt, g.jmt, g.imt), dtype=m.dtype, device=device)
    return m, m.init_state(t0), make_forcing(smf, stf)


def state_digest(state) -> str:
    """SHA-256 of a whole state's DIGEST_FIELDS, as --status-dir gives
    it: equal digests, bitwise equal states."""
    sha = hashlib.sha256()
    for k in DIGEST_FIELDS:
        sha.update(getattr(state, k).cpu().numpy().tobytes())
    return sha.hexdigest()


def rank_run(mesh, steps):
    """One rank's run: the cold start (``cold_start``) cut into the
    rank's blocks, a first sharded leapfrog step, then ``steps`` timed
    ones.  Returns the rank's card, the kernels' launches over all the
    steps, its step and message times and messages a step; on rank 0
    also the JSON fields and the gathered state's digest."""
    from .ops.cg_kernel import congrad_launch
    from .ops.convection import apply_region_means
    from .ops.tracer_kernel import fct_tracer_step
    from .parallel.mesh import gather_pytree, shard_pytree
    from .parallel.shard_step import ShardedOceanStep

    m, start, whole_forcing = cold_start(mesh.device)
    g = m.params.grid
    ss = ShardedOceanStep(m, mesh)
    state = shard_pytree(start, mesh, g.jmt, g.imt)
    forcing = shard_pytree(whole_forcing, mesh, g.jmt, g.imt)
    counters = {"fct_tracer_step": fct_tracer_step,
                "apply_region_means": apply_region_means,
                "congrad": congrad_launch}
    for c in counters.values():
        c.launches = 0

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    state = ss.step(state, forcing, leapfrog=True)
    sync()
    ex0, msg0 = mesh.exchange_s, mesh.messages
    t_start = time.perf_counter()
    for _ in range(steps):
        state = ss.step(state, forcing, leapfrog=True)
    sync()
    dt_step = (time.perf_counter() - t_start) / max(steps, 1)
    exchange_ms = (mesh.exchange_s - ex0) / max(steps, 1) * 1e3
    out = dict(
        ms_per_step=round(dt_step * 1e3, 2),
        exchange_ms_per_step=round(exchange_ms, 2),
        messages_per_step=(mesh.messages - msg0) / max(steps, 1),
        transport=mesh.transport, card=str(mesh.device),
        launches={k: c.launches for k, c in counters.items()})
    full = gather_pytree(state, mesh, g.jmt, g.imt, root=0)
    if full is None:
        return out
    return dict(
        out, nan=bool(torch.isnan(full.t).any()),
        checksum_t0=float(torch.sum(full.t[0], dtype=torch.float32)),
        checksum_ke=float(torch.sum(full.u ** 2, dtype=torch.float32)),
        digest=state_digest(full))


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
    p.add_argument("--spawn", type=int, default=0,
                   help="N ranks' worth of mesh: spawn the mesh's ranks "
                        "on this host, each on --device")
    p.add_argument("--cpu-mesh", type=int, default=0,
                   help="--spawn N with the ranks on the CPU (gloo)")
    p.add_argument("--out", default=None,
                   help="write a JSON artifact (rank 0): mesh, ranks, "
                        "ms/step, state checksum")
    p.add_argument("--status-dir", default=None,
                   help="every rank writes DIR/rank<R>.json: its place, "
                        "exit code and (rank 0) launches and digest")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                   help="nccl: one card a rank, device tensors card to "
                        "card")
    p.add_argument("--device", default=None,
                   help="the ranks' device (default cuda; cpu with "
                        "--cpu-mesh)")
    return p.parse_args(argv)


def write_status(status_dir, rank, **fields):
    """``status_dir/rank<rank>.json`` (``--status-dir``)."""
    if status_dir:
        os.makedirs(status_dir, exist_ok=True)
        with open(os.path.join(status_dir, f"rank{rank}.json"), "w") as f:
            json.dump(dict(rank=rank, **fields), f)


def main(argv=None):
    args = parse(argv)
    from . import resolve_device
    from .parallel.launch import init_group, rank_card, spawn
    from .parallel.mesh import make_mesh

    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.cpu_mesh or args.spawn:
        ndev = args.cpu_mesh or args.spawn
        device = "cpu" if args.cpu_mesh else args.device
    elif args.coordinator is not None:
        ndev, device = args.num_processes, args.device
    elif torchrun:
        ndev, device = int(os.environ["WORLD_SIZE"]), args.device
    else:
        ndev, device = 1, args.device
    shape = choose_mesh(args.mesh, ndev)
    n = shape[0] * shape[1]
    print(f"mesh {shape} over {n} of {ndev} rank(s)", flush=True)

    if args.cpu_mesh or args.spawn:
        # the launcher starts the mesh's ranks only
        outs = spawn(rank_run, shape, args.backend, device, 1800.0,
                     args.steps)
        out = outs[0]
        processes, world, local = 1, n, n
        # every spawned rank exited 0, or spawn would have raised
        for rank, o in enumerate(outs):
            write_status(args.status_dir, rank, world=n, on_mesh=True,
                         code=0, **_rank_status(o))
    elif ndev == 1:
        out = rank_run(make_mesh(shape, device=device), args.steps)
        processes = world = local = 1
        write_status(args.status_dir, 0, world=1, on_mesh=True,
                     code=int(out["nan"]), **_rank_status(out))
    else:
        world = ndev
        if args.coordinator is not None:
            init, rank = f"tcp://{args.coordinator}", args.process_id
            processes, local = world, 1
        else:
            init, rank = "env://", int(os.environ["RANK"])
            local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
            processes = int(os.environ.get("GROUP_WORLD_SIZE",
                                           world // local))
        device = str(resolve_device(device))
        if device.startswith("cuda"):
            device = rank_card(rank)
        init_group(args.backend, rank, world, device, init_method=init)
        try:
            mesh = make_mesh(shape, device=device)
            if mesh is None:
                print(f"rank {rank} of {world}: not on the {shape} mesh, "
                      "idle", flush=True)
                out = None
            else:
                out = rank_run(mesh, args.steps)
            # the run ends when every rank has finished
            dist.barrier()
        finally:
            dist.destroy_process_group()
        code = 1 if out is not None and out.get("nan") else 0
        write_status(args.status_dir, rank, world=world,
                     on_mesh=mesh is not None, code=code,
                     **({} if out is None else _rank_status(out)))
    if out is None or "digest" not in out:
        return 0    # idle, or a rank of the mesh other than its rank 0
    print(f"{args.steps} sharded steps: {out['ms_per_step']:.2f} ms/step "
          f"({out['exchange_ms_per_step']:.2f} ms in messages, "
          f"{out['transport']}), nan={out['nan']} "
          f"checksum={out['checksum_t0']!r}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(
                processes=processes, global_devices=world,
                local_devices=local, mesh=list(shape), steps=args.steps,
                ms_per_step=out["ms_per_step"],
                checksum_t0=out["checksum_t0"],
                checksum_ke=out["checksum_ke"], nan=out["nan"]), f)
    return 1 if out["nan"] else 0


def _rank_status(out):
    return {k: out[k] for k in ("launches", "digest", "ms_per_step",
                                "exchange_ms_per_step", "messages_per_step",
                                "transport", "card") if k in out}


if __name__ == "__main__":
    sys.exit(main())
