"""A rank's card, a kernel's card, and NCCL's failures, on the CPU.

- ``parallel.launch.rank_card``: a rank takes the card of its global
  rank modulo the host's cards and makes it current; two launchers of
  two ranks on a four-card host get four different cards (``LOCAL_RANK``
  would give cards 0 and 1 twice).  ``init_group`` binds an NCCL
  process group to the rank's card (``device_id``), and a mesh on a
  bare ``cuda`` names the current card.
- ``cuda.check_cuda`` refuses a tensor on a card other than the current
  one (the current-device query monkeypatched: no card here).
- ``launch.TRANSPORT`` names NCCL's ways of saying that a peer went
  away, and ``spawn``'s blame passes over them to the rank whose own
  code failed.
- ``make_multihost_artifact --backend nccl`` and ``chip_smoke.py
  --cards 4`` refuse a host with fewer than four cards, and the
  committed ``MULTIHOST_torch_nccl.json`` (the four-card run's record)
  is whole.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

import chip_smoke
from uvic_tpu_torch import cuda
from uvic_tpu_torch import make_multihost_artifact as art
from uvic_tpu_torch.parallel import launch
from uvic_tpu_torch.parallel.mesh import RankMesh

from torch_threads import torch_one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
JAX_KEYS = {"processes", "global_devices", "local_devices", "mesh", "steps",
            "ms_per_step", "checksum_t0", "checksum_ke", "nan"}


@pytest.fixture
def cards(monkeypatch):
    """The cards made current, in order (``torch.cuda.set_device``
    recorded instead of called)."""
    made = []
    monkeypatch.setattr(torch.cuda, "set_device", made.append)
    return made


def launcher_envs(launchers, per_launcher):
    """What ``torch.distributed.run`` sets in each rank of ``launchers``
    launchers of ``per_launcher`` ranks each."""
    world = launchers * per_launcher
    return [dict(RANK=str(node * per_launcher + local),
                 LOCAL_RANK=str(local), WORLD_SIZE=str(world),
                 LOCAL_WORLD_SIZE=str(per_launcher),
                 GROUP_RANK=str(node))
            for node in range(launchers) for local in range(per_launcher)]


@pytest.mark.parametrize("launchers,per_launcher,count,want", [
    (2, 2, 4, [0, 1, 2, 3]),              # two launchers, four cards
    (1, 4, 4, [0, 1, 2, 3]),              # one launcher, four cards
    (2, 4, 1, [0] * 8),                   # eight gloo ranks, one card
    (2, 4, 4, [0, 1, 2, 3, 0, 1, 2, 3]),  # eight ranks, four cards
])
def test_rank_card_from_the_launchers_environment(cards, launchers,
                                                  per_launcher, count,
                                                  want):
    got = [launch.rank_card(env=env, count=count)
           for env in launcher_envs(launchers, per_launcher)]
    assert got == [f"cuda:{i}" for i in want]
    assert cards == want


def test_two_launchers_of_two_ranks_take_four_cards(cards):
    envs = launcher_envs(2, 2)
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1", "0", "1"]
    got = {launch.rank_card(env=env, count=4) for env in envs}
    assert got == {"cuda:0", "cuda:1", "cuda:2", "cuda:3"}


def test_rank_card_takes_the_rank_given(cards):
    assert launch.rank_card(6, count=4) == "cuda:2"
    assert cards == [2]


def test_init_group_binds_nccl_to_the_rank_card(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    launch.init_group("nccl", 3, 4, "cuda:3", init_method="env://")
    launch.init_group("gloo", 3, 4, "cuda:3", init_method="env://")
    (nccl, kw_nccl), (gloo, kw_gloo) = calls
    assert (nccl, kw_nccl["device_id"]) == ("nccl", torch.device("cuda:3"))
    assert (kw_nccl["rank"], kw_nccl["world_size"]) == (3, 4)
    assert gloo == "gloo" and "device_id" not in kw_gloo


def test_mesh_on_a_bare_cuda_names_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert RankMesh((1, 1), "cuda").device == torch.device("cuda", 2)
    assert RankMesh((1, 1), "cuda:1").device == torch.device("cuda", 1)
    assert RankMesh((1, 1), "cpu").device == torch.device("cpu")


def on_card(index, shape=(3, 4)):
    """A stand-in for a float32 tensor on card ``index`` (no card here)."""
    return SimpleNamespace(is_cuda=True, device=torch.device("cuda", index),
                           dtype=torch.float32, shape=torch.Size(shape),
                           is_contiguous=lambda: True)


def test_check_cuda_refuses_a_tensor_on_another_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda.check_cuda("k", dict(a=(on_card(0), (3, 4)), b=(None, None)))
    with pytest.raises(ValueError, match="b is on cuda:1, the current "
                                         "card is cuda:0"):
        cuda.check_cuda("k", dict(a=(on_card(0), (3, 4)),
                                  b=(on_card(1), None)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cuda.check_cuda("k", dict(b=(on_card(1), None)))
    with pytest.raises(ValueError, match="a is on cuda:0"):
        cuda.check_cuda("k", dict(a=(on_card(0), (3, 4))))


def test_check_cuda_still_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="not cuda"):
        cuda.check_cuda("k", dict(a=(torch.zeros(2), None)))


NCCL_PEER_GONE = [
    "torch.distributed.DistBackendError: NCCL error in: ProcessGroupNCCL."
    "cpp:3356, remote process exited or there was a network error, NCCL "
    "version 2.21.5\nncclRemoteError: A call failed possibly due to a "
    "network error or a remote process exiting prematurely.",
    "[Rank 2] Watchdog caught collective operation timeout: WorkNCCL("
    "SeqNum=7, OpType=ALLGATHER, NumelIn=1, NumelOut=4, Timeout(ms)="
    "600000) ran for 600011 milliseconds before timing out.",
    "RuntimeError: NCCL communicator was aborted on rank 1.",
    "torch.distributed.DistStoreError: failed to recv, got 0 bytes",
]
OWN = [
    "ValueError: rank 1 raises on purpose",
    "torch.distributed.DistBackendError: NCCL error in: ProcessGroupNCCL."
    "cpp:1970, invalid usage, NCCL version 2.21.5\nncclInvalidUsage: "
    "This usually reflects invalid usage of NCCL library.",
    "RuntimeError: CUDA error: an illegal memory access was encountered",
]


@pytest.mark.parametrize("text", NCCL_PEER_GONE)
def test_transport_names_nccl_peer_failures(text):
    assert launch.TRANSPORT.search(text)


@pytest.mark.parametrize("text", OWN)
def test_transport_leaves_a_rank_own_failure(text):
    assert not launch.TRANSPORT.search(text)


class FakeRank:
    """What ``_blame`` reads of a rank's process."""

    def __init__(self, rank):
        self.name, self.exitcode = f"rank{rank}", 1

    def is_alive(self):
        return False

    def join(self, timeout=None):
        pass


@pytest.mark.parametrize("peer_gone", NCCL_PEER_GONE)
def test_blame_passes_over_a_rank_that_nccl_killed(tmp_path, peer_gone):
    """Rank 0 died first, of NCCL (its peer went away); rank 1's own code
    raised: rank 1 is named."""
    (tmp_path / "error_0.txt").write_text(peer_gone)
    (tmp_path / "error_1.txt").write_text(OWN[0])
    procs = [FakeRank(0), FakeRank(1)]
    err = launch._blame(procs, procs[0], str(tmp_path))
    assert str(err).startswith("rank 1 exited with code 1")


def test_artifact_over_nccl_needs_four_cards():
    with pytest.raises(RuntimeError, match="takes 4 cards"):
        art.main(["1", "--backend", "nccl", "--device", "cpu"])
    assert art.LAYOUTS["nccl"] == art.Layout((2, 2), 4, (1, 3))
    assert art.LAYOUTS["gloo"].mesh == art.MESH == (2, 3)


@pytest.mark.parametrize("count", [0, 1, 3])
def test_chip_smoke_four_cards_refuses_fewer(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    with pytest.raises(RuntimeError, match="needs 4 cards"):
        chip_smoke.require_cards(4)



def test_committed_nccl_artifact_is_a_whole_record():
    """MULTIHOST_torch_nccl.json: the (2, 2) mesh from one launcher of
    four ranks and from two launchers of two, and the (1, 3) mesh on
    three of four ranks, over NCCL on four cards, their checksums
    equal."""
    a = json.loads((ROOT / "MULTIHOST_torch_nccl.json").read_text())
    assert a["ok"] is True and a["device"].endswith(", nccl)")
    single, two, part = a["single"], a["two_process"], a["part_of_world"]
    assert set(single) == set(two) == JAX_KEYS
    assert set(part) == JAX_KEYS | {"checksum_rel_diff"}
    assert [(r["processes"], r["local_devices"], r["global_devices"],
             r["mesh"]) for r in (single, two, part)] == [
        (1, 4, 4, [2, 2]), (2, 2, 4, [2, 2]), (2, 2, 4, [1, 3])]
    for r in (two, part):
        assert (r["checksum_t0"], r["checksum_ke"]) == (
            single["checksum_t0"], single["checksum_ke"])
        assert not r["nan"]
    assert a["checksum_rel_diff"] == part["checksum_rel_diff"] \
        == {"t0": 0.0, "ke": 0.0}
