"""The multi-process bootstrap, run for real (the twin of
``scripts/make_multihost_artifact.py``).

    python3 -m uvic_tpu_torch.make_multihost_artifact [steps]
        [--device cpu|cuda] [--backend gloo|nccl] [--out PATH]

Runs ``uvic_tpu_torch.run_multihost`` twice on this machine with the
same (2, 3) mesh (the largest divisor of the 102-point grid within 8
ranks) and the same step count, on the standard 102x102x19 grid in
float32 at full width:

1. a single launch: one launcher spawns the mesh's six ranks
   (``--cpu-mesh 8`` on the CPU, ``--spawn 8`` on the card), and
2. two launchers of four ranks each, joined into one world of eight
   through ``python3 -m torch.distributed.run --nnodes 2
   --nproc-per-node 4 --rdzv-backend c10d`` (the rendezvous and the
   ranks' messages go over TCP: the wire path a second host takes).  Six
   ranks, spanning the two launchers, form the mesh; the other two idle
   and exit 0.

It then checks that the two-launcher run formed 2 launchers x 4 ranks =
8 global ranks, holds ``checksum_t0`` and ``checksum_ke`` to the JAX
script's 1e-5 relative limit, prints the measured gaps (0 is expected:
the ranks do the same work in the same order), and writes the JAX
artifact's keys, plus ``device``, to ``--out`` (``MULTIHOST_torch.json``
by default).  Without ``--device`` the ranks run on the card; ``--device
cpu`` is the JAX script's ``JAX_PLATFORMS=cpu``.  Each rank runs the
congrad kernel (B2, the barotropic solve replicated) and the convection
apply (B3, on its block); the sharded step takes the generic tracer
step, as the reference's sharded core does, so not B1.

With ``--backend nccl`` (four cards or more, one rank a card, device
tensors card to card) the JAX artifact's two layouts are scaled to four
cards: the (2, 2) mesh from one launcher spawning its four ranks
against two ``torch.distributed.run`` launchers of two ranks, and a
(1, 3) mesh on three of the four ranks of two such launchers, the
fourth idle (exit 0), as the JAX script's 6 of 8 devices.  The three
runs' state digests are printed side by side (equal: the same bits),
and the record, ``MULTIHOST_torch_nccl.json`` by default, holds the
(1, 3) run under ``part_of_world`` beside the JAX keys.

The JAX keys map onto the port as ``run_multihost`` says: a process is
a launcher, a device a rank process.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple


class Layout(NamedTuple):
    """The runs of one backend: the mesh of the single launch and of the
    two launchers, the ranks of the world, and the mesh on part of that
    world when it is a run of its own (None: the two launchers' mesh
    already leaves ranks idle)."""
    mesh: tuple
    ranks: int
    part: tuple | None = None


LAYOUTS = {"gloo": Layout((2, 3), 8),                # 6 of 8 on the mesh
           "nccl": Layout((2, 2), 4, (1, 3))}        # one rank a card
MESH = LAYOUTS["gloo"].mesh
LAUNCHERS = 2
OUT = {"gloo": "MULTIHOST_torch.json", "nccl": "MULTIHOST_torch_nccl.json"}
REL_LIMIT = 1e-5         # the JAX script's limit on the checksums' gap
TIMEOUT_S = 900.0        # the JAX script's wait for each run
ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    """The launchers' environment: the package importable, one host
    thread a rank."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _wait(procs, logs, timeout_s):
    """Wait for every process; stop them all and raise if one fails or
    the time runs out.  Returns their exit codes."""
    deadline = time.monotonic() + timeout_s
    try:
        for p, log in zip(procs, logs):
            rc = p.wait(timeout=max(5.0, deadline - time.monotonic()))
            if rc != 0:
                raise RuntimeError(f"{' '.join(p.args)} exited with {rc}:\n"
                                   + Path(log).read_text()[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def _run_multihost(steps, device, out, status, mesh, backend):
    return ["-m", "uvic_tpu_torch.run_multihost", "--mesh",
            ",".join(map(str, mesh)), "--steps", str(steps), "--device",
            device, "--out", out, "--status-dir", status, "--backend",
            backend]


def _statuses(status):
    return {int(p.stem[4:]): json.loads(p.read_text())
            for p in Path(status).glob("rank*.json")}


def single_launch(steps, device, tmp, backend="gloo"):
    """One launcher spawning the mesh's ranks: (record, every rank's
    status)."""
    layout = LAYOUTS[backend]
    out, status = os.path.join(tmp, "single.json"), os.path.join(
        tmp, "single_status")
    log = os.path.join(tmp, "single.log")
    spawn = ["--cpu-mesh", str(layout.ranks)] if device == "cpu" \
        else ["--spawn", str(layout.ranks)]
    with open(log, "w") as f:
        p = subprocess.Popen(
            [sys.executable, *_run_multihost(steps, device, out, status,
                                             layout.mesh, backend),
             *spawn], env=_env(), stdout=f, stderr=subprocess.STDOUT)
    _wait([p], [log], TIMEOUT_S)
    return json.loads(Path(out).read_text()), _statuses(status)


def two_launchers(steps, device, tmp, backend="gloo", mesh=None,
                  name="two"):
    """Two ``torch.distributed.run`` launchers of half the layout's ranks
    each, one world (eight ranks over gloo, four over NCCL), on ``mesh``
    (the layout's by default): (record, every rank's status, the
    launchers' exit codes)."""
    layout = LAYOUTS[backend]
    mesh = layout.mesh if mesh is None else mesh
    out, status = os.path.join(tmp, f"{name}.json"), os.path.join(
        tmp, f"{name}_status")
    endpoint = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    for node in range(LAUNCHERS):
        log = os.path.join(tmp, f"{name}_launcher{node}.log")
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nnodes", str(LAUNCHERS),
               "--nproc-per-node", str(layout.ranks // LAUNCHERS),
               "--node-rank", str(node), "--rdzv-backend", "c10d",
               "--rdzv-endpoint", endpoint,
               # the first launcher hosts the rendezvous store
               "--rdzv-conf", f"is_host={int(node == 0)}",
               *_run_multihost(steps, device, out, status, mesh, backend)]
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, env=_env(), stdout=f,
                                          stderr=subprocess.STDOUT))
        logs.append(log)
    codes = _wait(procs, logs, TIMEOUT_S)
    return json.loads(Path(out).read_text()), _statuses(status), codes


def rel_gap(a: float, b: float) -> float:
    """|a - b| over |a| (the JAX script's measure)."""
    return abs(a - b) / max(abs(a), 1e-30)


def check_two_launchers(two, statuses, backend="gloo", mesh=None):
    """Raise unless the two-launcher run formed its launchers' ranks (2
    x 4 = 8 over gloo, 2 x 2 = 4 over NCCL) on ``mesh`` (the layout's by
    default), every rank reported, the ranks beyond the mesh idled, and
    every rank exits 0."""
    layout = LAYOUTS[backend]
    mesh = layout.mesh if mesh is None else mesh
    if (two["processes"], two["global_devices"], two["local_devices"]) \
            != (LAUNCHERS, layout.ranks, layout.ranks // LAUNCHERS):
        raise AssertionError(f"the two launchers formed {two}")
    if two["mesh"] != list(mesh):
        raise AssertionError(f"the two launchers' mesh {two['mesh']}")
    if sorted(statuses) != list(range(layout.ranks)):
        raise AssertionError(f"ranks that reported: {sorted(statuses)}")
    idle = [r for r, s in sorted(statuses.items()) if not s["on_mesh"]]
    if idle != list(range(mesh[0] * mesh[1], layout.ranks)) \
            or any(s["code"] for s in statuses.values()):
        raise AssertionError(f"ranks' status: {statuses}")


def checksum_gaps(single, other):
    """The checksums' relative gaps (the JAX script's measure); raise at
    REL_LIMIT or on a NaN."""
    gap = {k: rel_gap(single[f"checksum_{k}"], other[f"checksum_{k}"])
           for k in ("t0", "ke")}
    for k, g in gap.items():
        if not g < REL_LIMIT:
            raise AssertionError(f"checksum_{k}: gap {g!r} >= {REL_LIMIT}")
    if single["nan"] or other["nan"]:
        raise AssertionError("NaN in the state")
    return gap


def run_pair(steps, device, tmp, backend="gloo"):
    """The layout's runs and their checks.  Returns a dict: ``single``,
    ``two`` (the records), ``gap`` (relative, by checksum), ``statuses``
    (every rank of the two-launcher run), ``single_statuses`` (every rank
    of the single launch), ``launcher_codes``, ``seconds`` (of each run);
    over NCCL also ``part`` (the mesh on part of the world: record, every
    rank's status, gap, launchers' exit codes)."""
    layout = LAYOUTS[backend]
    t0 = time.perf_counter()
    single, single_statuses = single_launch(steps, device, tmp, backend)
    t1 = time.perf_counter()
    two, statuses, codes = two_launchers(steps, device, tmp, backend)
    t2 = time.perf_counter()
    check_two_launchers(two, statuses, backend)
    if single["mesh"] != list(layout.mesh):
        raise AssertionError(f"the single launch's mesh {single['mesh']}")
    out = dict(single=single, two=two, gap=checksum_gaps(single, two),
               statuses=statuses, single_statuses=single_statuses,
               launcher_codes=codes, seconds=[t1 - t0, t2 - t1])
    if layout.part is not None:
        part, part_statuses, part_codes = two_launchers(
            steps, device, tmp, backend, layout.part, "part")
        out["seconds"].append(time.perf_counter() - t2)
        check_two_launchers(part, part_statuses, backend, layout.part)
        out["part"] = dict(record=part, statuses=part_statuses,
                           gap=checksum_gaps(single, part),
                           launcher_codes=part_codes)
    return out


def device_name(device: str, backend: str = "gloo") -> str:
    if device == "cpu":
        return "cpu"
    import torch
    name = torch.cuda.get_device_name(0)
    if backend == "nccl":
        return f"cuda ({LAYOUTS[backend].ranks} x {name}, nccl)"
    return f"cuda ({name})"


def artifact(res, device, backend="gloo"):
    """The record of ``run_pair``'s runs: the JAX artifact's keys, the
    device and, over NCCL, ``part_of_world``."""
    art = dict(single=res["single"], two_process=res["two"],
               checksum_rel_diff=res["gap"], ok=True,
               device=device_name(device, backend))
    if "part" in res:
        art["part_of_world"] = dict(res["part"]["record"],
                                    checksum_rel_diff=res["part"]["gap"])
    return art


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("steps", type=int, nargs="?", default=10)
    p.add_argument("--device", default=None,
                   help="the ranks' device (default cuda)")
    p.add_argument("--backend", default="gloo", choices=sorted(LAYOUTS),
                   help="nccl: four cards, one rank a card")
    p.add_argument("--out", default=None,
                   help="the record (default MULTIHOST_torch.json, over "
                        "nccl MULTIHOST_torch_nccl.json)")
    args = p.parse_args(argv)
    from . import resolve_device
    device = resolve_device(args.device).type
    if args.backend == "nccl":
        import torch
        cards = torch.cuda.device_count() if device == "cuda" else 0
        if cards < LAYOUTS["nccl"].ranks:
            raise RuntimeError(f"--backend nccl takes "
                               f"{LAYOUTS['nccl'].ranks} cards, one a "
                               f"rank; {device} has {cards}")
    with tempfile.TemporaryDirectory(prefix="uvic_multihost_") as tmp:
        res = run_pair(args.steps, device, tmp, args.backend)
    st = res["statuses"]
    runs = {"single": res["single_statuses"], "two": st}
    if "part" in res:
        runs["part"] = res["part"]["statuses"]
    print(f"runs {[round(t, 1) for t in res['seconds']]} s ({', '.join(runs)}"
          f"; launchers' exit codes {res['launcher_codes']}); idle ranks' "
          f"exit codes " + json.dumps({name: {
              r: s["code"] for r, s in ranks.items() if not s["on_mesh"]}
              for name, ranks in runs.items()}), flush=True)
    print("state digests: " + json.dumps({name: ranks[0]["digest"]
                                          for name, ranks in runs.items()})
          + "; launches by rank: " + json.dumps({
              name: [s.get("launches") for _, s in sorted(ranks.items())]
              for name, ranks in runs.items()}), flush=True)
    print(f"checksum gaps (relative, limit {REL_LIMIT:g}): "
          f"t0 {res['gap']['t0']!r}, ke {res['gap']['ke']!r}", flush=True)
    art = artifact(res, device, args.backend)
    with open(args.out or OUT[args.backend], "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps(art, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
