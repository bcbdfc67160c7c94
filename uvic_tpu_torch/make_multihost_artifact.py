"""The multi-process bootstrap, run for real (the twin of
``scripts/make_multihost_artifact.py``).

    python3 -m uvic_tpu_torch.make_multihost_artifact [steps]
        [--device cpu|cuda] [--out PATH]

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

MESH = (2, 3)
RANKS = 8                # 6 of them on the mesh
LAUNCHERS = 2
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


def _run_multihost(steps, device, out, status):
    return ["-m", "uvic_tpu_torch.run_multihost", "--mesh",
            ",".join(map(str, MESH)), "--steps", str(steps), "--device",
            device, "--out", out, "--status-dir", status]


def _statuses(status):
    return {int(p.stem[4:]): json.loads(p.read_text())
            for p in Path(status).glob("rank*.json")}


def single_launch(steps, device, tmp):
    """One launcher spawning the mesh's ranks: (record, rank 0's
    status)."""
    out, status = os.path.join(tmp, "single.json"), os.path.join(
        tmp, "single_status")
    log = os.path.join(tmp, "single.log")
    spawn = ["--cpu-mesh", str(RANKS)] if device == "cpu" \
        else ["--spawn", str(RANKS)]
    with open(log, "w") as f:
        p = subprocess.Popen(
            [sys.executable, *_run_multihost(steps, device, out, status),
             *spawn], env=_env(), stdout=f, stderr=subprocess.STDOUT)
    _wait([p], [log], TIMEOUT_S)
    return json.loads(Path(out).read_text()), _statuses(status)[0]


def two_launchers(steps, device, tmp):
    """Two ``torch.distributed.run`` launchers of four ranks each, one
    world of eight: (record, every rank's status, the launchers' exit
    codes)."""
    out, status = os.path.join(tmp, "two.json"), os.path.join(
        tmp, "two_status")
    endpoint = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    for node in range(LAUNCHERS):
        log = os.path.join(tmp, f"launcher{node}.log")
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nnodes", str(LAUNCHERS),
               "--nproc-per-node", str(RANKS // LAUNCHERS),
               "--node-rank", str(node), "--rdzv-backend", "c10d",
               "--rdzv-endpoint", endpoint,
               # the first launcher hosts the rendezvous store
               "--rdzv-conf", f"is_host={int(node == 0)}",
               *_run_multihost(steps, device, out, status)]
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, env=_env(), stdout=f,
                                          stderr=subprocess.STDOUT))
        logs.append(log)
    codes = _wait(procs, logs, TIMEOUT_S)
    return json.loads(Path(out).read_text()), _statuses(status), codes


def rel_gap(a: float, b: float) -> float:
    """|a - b| over |a| (the JAX script's measure)."""
    return abs(a - b) / max(abs(a), 1e-30)


def check_two_launchers(two, statuses):
    """Raise unless the two-launcher run formed 2 launchers x 4 ranks =
    8 global ranks on the (2, 3) mesh, every rank reported, ranks 6 and
    7 idled, and every rank exits 0."""
    if (two["processes"], two["global_devices"], two["local_devices"]) \
            != (LAUNCHERS, RANKS, RANKS // LAUNCHERS):
        raise AssertionError(f"the two launchers formed {two}")
    if two["mesh"] != list(MESH):
        raise AssertionError(f"the two launchers' mesh {two['mesh']}")
    if sorted(statuses) != list(range(RANKS)):
        raise AssertionError(f"ranks that reported: {sorted(statuses)}")
    idle = [r for r, s in sorted(statuses.items()) if not s["on_mesh"]]
    if idle != list(range(MESH[0] * MESH[1], RANKS)) \
            or any(s["code"] for s in statuses.values()):
        raise AssertionError(f"ranks' status: {statuses}")


def run_pair(steps, device, tmp):
    """Both runs and their checks.  Returns a dict: ``single``, ``two``
    (the records), ``gap`` (relative, by checksum), ``statuses`` (every
    rank of the two-launcher run), ``single_status`` (rank 0 of the
    single launch), ``launcher_codes``, ``seconds`` (of each run)."""
    t0 = time.perf_counter()
    single, single_status = single_launch(steps, device, tmp)
    t1 = time.perf_counter()
    two, statuses, codes = two_launchers(steps, device, tmp)
    t2 = time.perf_counter()
    check_two_launchers(two, statuses)
    if single["mesh"] != list(MESH):
        raise AssertionError(f"the single launch's mesh {single['mesh']}")
    gap = {k: rel_gap(single[f"checksum_{k}"], two[f"checksum_{k}"])
           for k in ("t0", "ke")}
    for k, g in gap.items():
        if not g < REL_LIMIT:
            raise AssertionError(f"checksum_{k}: gap {g!r} >= {REL_LIMIT}")
    if single["nan"] or two["nan"]:
        raise AssertionError("NaN in the state")
    return dict(single=single, two=two, gap=gap, statuses=statuses,
                single_status=single_status, launcher_codes=codes,
                seconds=(t1 - t0, t2 - t1))


def device_name(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch
    return f"cuda ({torch.cuda.get_device_name(0)})"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("steps", type=int, nargs="?", default=10)
    p.add_argument("--device", default=None,
                   help="the ranks' device (default cuda)")
    p.add_argument("--out", default="MULTIHOST_torch.json")
    args = p.parse_args(argv)
    from . import resolve_device
    device = resolve_device(args.device).type
    with tempfile.TemporaryDirectory(prefix="uvic_multihost_") as tmp:
        res = run_pair(args.steps, device, tmp)
    st = res["statuses"]
    print(f"single launch {res['seconds'][0]:.1f} s, two launchers "
          f"{res['seconds'][1]:.1f} s (exit codes {res['launcher_codes']});"
          f" idle ranks' exit codes "
          f"{ {r: s['code'] for r, s in st.items() if not s['on_mesh']} }; "
          f"launches on the mesh's rank 0 {json.dumps(st[0]['launches'])}; "
          f"state digests equal: "
          f"{st[0]['digest'] == res['single_status']['digest']}", flush=True)
    print(f"checksum gaps (relative, limit {REL_LIMIT:g}): "
          f"t0 {res['gap']['t0']!r}, ke {res['gap']['ke']!r}", flush=True)
    art = dict(single=res["single"], two_process=res["two"],
               checksum_rel_diff=res["gap"], ok=True,
               device=device_name(device))
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps(art, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
