"""``python -m uvic_tpu_torch.run_multihost`` (the twin of
``scripts/run_multihost.py``) and ``entry.dryrun_multichip`` on gloo CPU
ranks.

``--cpu-mesh N`` spawns the ranks of the mesh the JAX script would choose
for N devices, steps the standard grid (``ModelConfig()``, float32)
through ``ShardedOceanStep`` and writes the JAX script's JSON keys; the
temperature checksum of a (1, 1) run and of a (2, 2) run agree to
float32 round-off.  The same run under ``torchrun``'s environment (two
processes, ``env://``) writes the same checksum.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from uvic_tpu_torch import run_multihost
from uvic_tpu_torch.entry import dryrun_multichip
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

KEYS = {"processes", "global_devices", "local_devices", "mesh", "steps",
        "ms_per_step", "checksum_t0", "checksum_ke", "nan"}
ROOT = Path(__file__).resolve().parents[1]


def _run(tmp_path, name, *argv):
    out = tmp_path / f"{name}.json"
    assert run_multihost.main([*argv, "--steps", "2", "--out",
                               str(out)]) == 0
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    return {"cpu4": _run(tmp, "cpu4", "--cpu-mesh", "4"),
            "one": _run(tmp, "one", "--cpu-mesh", "1")}


def test_cpu_mesh_writes_the_reference_keys(runs):
    r = runs["cpu4"]
    assert set(r) == KEYS
    assert r["mesh"] == [2, 2]              # the JAX script's choice for 4
    # one launcher (a JAX process) that spawned four ranks (its devices)
    assert (r["processes"], r["global_devices"], r["local_devices"],
            r["steps"]) == (1, 4, 4, 2)
    assert r["nan"] is False and r["ms_per_step"] > 0


def test_checksums_of_one_and_four_ranks_agree(runs):
    one, four = runs["one"], runs["cpu4"]
    assert one["mesh"] == [1, 1]
    for key in ("checksum_t0", "checksum_ke"):
        assert four[key] == pytest.approx(one[key], rel=1e-6)


@pytest.mark.parametrize("mesh_arg,ndev,shape", [
    (None, 8, (1, 6)), (None, 4, (2, 2)), (None, 1, (1, 1)),
    ("2,4", 8, (1, 6)), ("2,3", 8, (2, 3)), ("1,17", 17, (1, 17)),
    ("4,4", 16, (2, 6))])
def test_mesh_choice_is_the_reference_choice(mesh_arg, ndev, shape):
    """scripts/run_multihost.py:85-108, case by case: a given mesh that
    divides 102x102 is kept; otherwise, and without one, the largest
    (divisible) mesh of at most ndev devices, searched in the same
    order."""
    assert run_multihost.choose_mesh(mesh_arg, ndev) == shape


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_torchrun_environment(tmp_path, runs):
    """Two processes with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT
    (what torchrun sets), on the CPU, a (1, 2) mesh."""
    port = str(_free_port())
    out = tmp_path / "env.json"
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=port,
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "uvic_tpu_torch.run_multihost",
             "--mesh", "1,2", "--steps", "2", "--device", "cpu", "--out",
             str(out)], env=env, cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text, _ = p.communicate(timeout=240)
        assert p.returncode == 0, text
    r = json.loads(out.read_text())
    assert (r["mesh"], r["processes"], r["nan"]) == ([1, 2], 2, False)
    assert r["checksum_t0"] == pytest.approx(runs["one"]["checksum_t0"],
                                             rel=1e-6)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip(n):
    """On a (2, 4) and a (1, 3) mesh: the small flagship, one sharded
    leapfrog step, and one rank-decomposed coupled MOBI segment, no NaN
    (a rank's failure would raise)."""
    dryrun_multichip(n, device="cpu")
