"""The multi-process bootstrap as the JAX artifact runs it, on the CPU.

- A mesh on part of the process group: three ``run_multihost
  --coordinator`` processes on a (1, 2) mesh exit 0, the third idle, and
  their checksums and state digest equal a two-rank run's bitwise;
  ``make_mesh`` on a world of 3 gives rank 2 None and the mesh's ranks a
  group of their own; a mesh larger than the world raises.
- ``python3 -m uvic_tpu_torch.make_multihost_artifact 2 --device cpu``
  (the twin of ``scripts/make_multihost_artifact.py``): a single launch
  of the (2, 3) mesh's six ranks and two ``torch.distributed.run``
  launchers of four ranks in one world of eight write the JAX artifact's
  record.  The single launch's checksums are held against the JAX
  package's ``scripts/run_multihost.py`` on the same mesh and step
  count, in float32 on the CPU, within the JAX script's 1e-5 relative
  limit.  The checksum is the float32 sum of the final state; the JAX
  script sums on XLA's CPU reduction, whose float32 rounding moves its
  printed checksum by more than 1e-5 away from the exact sum of its own
  state, so both states are summed here by the port's reduction (and in
  float64); the script's own checksum and its gap are printed.

The runs are subprocesses started together in one module fixture.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uvic_tpu_torch import make_multihost_artifact as art
from uvic_tpu_torch.parallel.launch import spawn

import torch_rank_fns
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 2
JAX_KEYS = {"processes", "global_devices", "local_devices", "mesh", "steps",
            "ms_per_step", "checksum_t0", "checksum_ke", "nan"}
# runs scripts/run_multihost.py as it is and keeps the state it waits on
# last (its final state) for the sums below
JAX_HARNESS = """
import runpy, sys
import jax
import numpy as np
kept = []
wait = jax.block_until_ready
def keep(x):
    kept.append(x)
    return wait(x)
jax.block_until_ready = keep
out = sys.argv[1]
sys.argv = ["scripts/run_multihost.py"] + sys.argv[2:]
runpy.run_path("scripts/run_multihost.py", run_name="__main__")
np.savez(out + ".npz", t0=np.asarray(kept[-1].t[0]),
         u=np.asarray(kept[-1].u))
"""


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
                **extra)


def _start(cmd, log, **env):
    with open(log, "w") as f:
        return subprocess.Popen(cmd, env=_env(**env), cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT)


def _finish(procs, logs, timeout=600):
    """Wait for every process (killing what outlives ``timeout``), then
    require exit code 0 of each."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, Path(log).read_text()[-3000:]


def _multihost(*argv):
    return [sys.executable, "-m", "uvic_tpu_torch.run_multihost", *argv]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    jax_out = str(tmp / "jax.json")
    jax = _start([sys.executable, "-c", JAX_HARNESS, jax_out, "--mesh",
                  "2,3", "--steps", str(STEPS), "--cpu-mesh", "8", "--out",
                  jax_out], tmp / "jax.log", JAX_PLATFORMS="cpu")
    port = art.free_port()
    coord = [_start(_multihost(
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "3",
        "--process-id", str(r), "--mesh", "1,2", "--steps", "1",
        "--device", "cpu", "--out", str(tmp / "coord.json"),
        "--status-dir", str(tmp / "coord")), tmp / f"coord{r}.log")
        for r in range(3)]
    pair = _start(_multihost(
        "--cpu-mesh", "2", "--mesh", "1,2", "--steps", "1", "--out",
        str(tmp / "pair.json"), "--status-dir", str(tmp / "pair")),
        tmp / "pair.log")
    artifact = tmp / "MULTIHOST_torch.json"
    try:
        assert art.main([str(STEPS), "--device", "cpu", "--out",
                         str(artifact)]) == 0
    finally:
        _finish([jax, *coord, pair],
                [tmp / "jax.log", *[tmp / f"coord{r}.log" for r in range(3)],
                 tmp / "pair.log"])

    def status(d):
        return {int(p.stem[4:]): json.loads(p.read_text())
                for p in (tmp / d).glob("rank*.json")}
    return dict(
        artifact=json.loads(artifact.read_text()),
        jax=json.loads(Path(jax_out).read_text()),
        jax_state=dict(np.load(jax_out + ".npz")),
        coord=json.loads((tmp / "coord.json").read_text()),
        coord_status=status("coord"),
        pair=json.loads((tmp / "pair.json").read_text()),
        pair_status=status("pair"))


def test_processes_beyond_the_mesh_idle_and_exit_0(runs):
    """Three processes, a (1, 2) mesh: every process exited 0 (the
    fixture checks), rank 2 idled, and the checksums and the gathered
    state's digest equal the two-rank run's bitwise."""
    st = runs["coord_status"]
    assert sorted(st) == [0, 1, 2]
    assert [st[r]["on_mesh"] for r in range(3)] == [True, True, False]
    assert all(s["code"] == 0 and s["world"] == 3 for s in st.values())
    c, p = runs["coord"], runs["pair"]
    assert (c["processes"], c["global_devices"], c["local_devices"],
            c["mesh"]) == (3, 3, 1, [1, 2])
    assert (p["processes"], p["global_devices"], p["local_devices"],
            p["mesh"]) == (1, 2, 2, [1, 2])
    for key in ("checksum_t0", "checksum_ke"):
        assert c[key] == p[key], key
    assert st[0]["digest"] == runs["pair_status"][0]["digest"]


@pytest.fixture(scope="module")
def part_world():
    field = np.arange(5 * 7, dtype=np.float64).reshape(5, 7)
    return field, spawn(torch_rank_fns.part_of_the_world, (1, 3), "gloo",
                        "cpu", 120.0, (1, 2), (2, 2), field)


def test_make_mesh_on_part_of_the_world(part_world):
    """A (1, 2) mesh on a world of 3: rank 2 idles; ranks 0 and 1 gather,
    exchange and join a field through the mesh's group, rooted at the
    mesh's rank 0."""
    field, res = part_world
    assert [r["idle"] for r in res] == [False, False, True]
    for rank, r in enumerate(res[:2]):
        assert r["rank"] == rank
        assert r["gathered"] == [0, 1]
        assert r["from_west"] == 10 + (1 - rank)
    np.testing.assert_array_equal(res[0]["root"], field)
    assert res[1]["root"] is None


def test_a_mesh_larger_than_the_world_raises(part_world):
    for r in part_world[1]:
        assert r["big"] == ("mesh (2, 2) needs 4 ranks, the process group "
                            "has 3")


def test_artifact_record(runs):
    a = runs["artifact"]
    assert set(a) == {"single", "two_process", "checksum_rel_diff", "ok",
                      "device"}
    assert a["ok"] is True and a["device"] == "cpu"
    two, single = a["two_process"], a["single"]
    assert set(two) == set(single) == JAX_KEYS
    assert (two["processes"], two["local_devices"],
            two["global_devices"]) == (2, 4, 8)
    assert (single["processes"], single["local_devices"],
            single["global_devices"]) == (1, 6, 6)
    assert two["mesh"] == single["mesh"] == [2, 3]
    assert two["steps"] == single["steps"] == STEPS
    assert not two["nan"] and not single["nan"]
    gap = a["checksum_rel_diff"]
    print(f"two launchers against one: checksum gaps {gap}")
    assert gap["t0"] <= 1e-5 and gap["ke"] <= 1e-5


def test_single_launch_checksums_match_the_jax_run(runs):
    single, j = runs["artifact"]["single"], runs["jax"]
    assert (j["mesh"], j["steps"], j["global_devices"]) == ([2, 3], STEPS,
                                                            8)
    t0 = torch.as_tensor(runs["jax_state"]["t0"])
    u = torch.as_tensor(runs["jax_state"]["u"])
    assert t0.dtype == u.dtype == torch.float32
    ref = {"t0": float(torch.sum(t0, dtype=torch.float32)),
           "ke": float(torch.sum(u ** 2, dtype=torch.float32))}
    exact = {"t0": float(t0.double().sum()),
             "ke": float((u.double() ** 2).sum())}
    gaps = {k: art.rel_gap(ref[k], single[f"checksum_{k}"]) for k in ref}
    exact_gaps = {k: art.rel_gap(exact[k], single[f"checksum_{k}"])
                  for k in ref}
    script_gaps = {k: art.rel_gap(exact[k], j[f"checksum_{k}"]) for k in ref}
    print(f"the port's single launch against the JAX run's state: {gaps}; "
          f"against its float64 sums: {exact_gaps}; the JAX script's own "
          f"float32 checksums against its float64 sums: {script_gaps}")
    for k, g in gaps.items():
        assert g <= 1e-5, (k, g)


def test_committed_artifact_is_a_whole_record():
    """MULTIHOST_torch.json at the repo root: the CPU run of this
    module's artifact at the default step count."""
    a = json.loads((ROOT / "MULTIHOST_torch.json").read_text())
    assert a["ok"] is True and a["device"] == "cpu"
    assert set(a["single"]) == set(a["two_process"]) == JAX_KEYS
    assert (a["two_process"]["processes"], a["two_process"]["local_devices"],
            a["two_process"]["global_devices"]) == (2, 4, 8)
    assert a["single"]["mesh"] == a["two_process"]["mesh"] == [2, 3]
    assert max(a["checksum_rel_diff"].values()) <= 1e-5
