"""The deterministic diagnostics of a rank-decomposed state: the twins of
``tests/test_sharding.py::test_deterministic_tsi_bitwise_across_meshes``
and ``tests/test_conservation.py::
test_deterministic_audit_bitwise_under_sharding``, and the cut and join
of a ``CoupledState`` (``parallel.mesh.shard_coupled`` /
``gather_coupled``).

Each rank (gloo, CPU, float64) holds its block of the state; the
deterministic tsi row (``TsiDiagnostics.compute(..., mesh=mesh)``) and
the audit's inventories (``ConservationAudit.inventories(...,
mesh=mesh)``) gather the blocks' column partials and sum them on the
host in the unsharded C order: the row must be BITWISE the unsharded
one, on (2, 4) and on (1, 8).  The tsi state is test_sharding.py's (the
34x40 small ocean after a forward and four leapfrog steps of the port's
model), with a whole atmosphere and ice from a seeded generator; the
audit's is test_conservation.py's (34x34, seeded random tracers).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uvic_tpu_torch.config import small_config
from uvic_tpu_torch.convert import (ocean_state_from_numpy,
                                    ocean_state_to_numpy)
from uvic_tpu_torch.diag.conservation import ConservationAudit
from uvic_tpu_torch.diag.tsi import TsiDiagnostics
from uvic_tpu_torch.models.ocean.model import make_ocean
from uvic_tpu_torch.parallel.launch import spawn
from uvic_tpu_torch.parallel.mesh import make_mesh

from torch_rank_fns import call_all, coupled_roundtrip, diag_rows
from torch_shard_runs import BASE, SPAWN_S, one_thread, t_forcing, wind

MESHES = ((2, 4), (1, 8))


def tsi_case():
    """test_sharding.py's _ocean_setup() state after 1 + 4 steps, with a
    seeded whole atmosphere and ice."""
    cfg = small_config(imt=40, jmt=34, km=8)
    cfg = cfg.replace(ocean=dataclasses.replace(
        cfg.ocean, isopycmix=False, gent_mcwilliams=False, **BASE))
    with one_thread():
        m = make_ocean(cfg, device="cpu")
        g = m.params.grid
        t0 = np.zeros((2, g.km, g.jmt, g.imt))
        t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None]
        t0 *= np.asarray(m.params.topo.tmask)
        f = t_forcing(wind(g, m.nt))
        s = m.step(m.init_state(t0), f, leapfrog=False)
        for _ in range(4):
            s = m.step(s, f, leapfrog=True)
    rng = np.random.default_rng(5)
    atm_ice = (rng.standard_normal((2, g.jmt, g.imt)),
               rng.random((g.jmt, g.imt)), rng.random((g.jmt, g.imt)))
    return cfg, ocean_state_to_numpy(s), atm_ice


def audit_case():
    """test_conservation.py's state: 34x34, seeded random tracers."""
    cfg = small_config(imt=34, jmt=34, km=8)
    m = make_ocean(cfg, device="cpu")
    g = m.params.grid
    rng = np.random.default_rng(3)
    t0 = rng.standard_normal((2, g.km, g.jmt, g.imt)) \
        * np.asarray(m.params.topo.tmask)
    return cfg, ocean_state_to_numpy(m.init_state(t0))


def unsharded(cfg, state, atm_ice=None):
    m = make_ocean(cfg, device="cpu")
    s = ocean_state_from_numpy(state, "cpu", m.dtype)
    row = None
    if atm_ice is not None:
        at, aice, hice = (torch.as_tensor(a) for a in atm_ice)
        row = TsiDiagnostics(m, deterministic=True).compute(
            s, SimpleNamespace(at=at), SimpleNamespace(aice=aice, hice=hice))
    return row, ConservationAudit(m, deterministic=True).inventories(s)


@pytest.fixture(scope="module")
def runs():
    tsi_cfg, tsi_state, atm_ice = tsi_case()
    audit_cfg, audit_state = audit_case()
    out = dict(tsi=unsharded(tsi_cfg, tsi_state, atm_ice)[0],
               audit=unsharded(audit_cfg, audit_state)[1])
    for shape in MESHES:
        calls = [(diag_rows, dict(cfg=tsi_cfg, state=tsi_state,
                                  atm_ice=atm_ice)),
                 (diag_rows, dict(cfg=audit_cfg, state=audit_state))]
        if shape == (2, 4):
            calls.append((coupled_roundtrip, dict(cfg=tsi_cfg)))
        out[shape] = spawn(call_all, shape, "gloo", "cpu", SPAWN_S, calls)
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_tsi_row_bitwise(runs, shape):
    ref = runs["tsi"]
    for rank in runs[shape]:
        got = rank[0]["row"]
        assert set(got) == set(ref)
        for k in ref:
            assert got[k] == ref[k], (k, got[k], ref[k])


@pytest.mark.parametrize("shape", MESHES)
def test_audit_inventories_bitwise(runs, shape):
    ref = runs["audit"]
    for rank in runs[shape]:
        got = rank[1]["inventories"]
        assert got == ref, (got, ref)


def test_coupled_state_cut_and_join(runs):
    """The ocean cut into (17, 10) blocks with psi0 whole, the other
    components the same objects; joined on rank 0 bitwise the original
    (None elsewhere)."""
    ranks = [r[2] for r in runs[(2, 4)]]
    assert ranks[0]["t_block"][-2:] == (17, 10)
    assert ranks[0]["psi_block"] == (34, 40)
    whole, ref = ranks[0]["whole"], ranks[0]["ref"]
    assert set(whole) == set(ref)
    for k in ref:
        assert np.array_equal(whole[k], ref[k]), k
    for r in ranks:
        assert all(r["same"])
    assert all(r["whole"] is None for r in ranks[1:])


def test_rank_decomposed_rows_need_determinism():
    """A row of a rank-decomposed state sums on the host: the device
    path refuses a mesh."""
    cfg = small_config(imt=34, jmt=34, km=8)
    m = make_ocean(cfg, device="cpu")
    s = m.init_state()
    mesh = make_mesh((1, 1), device="cpu")
    with pytest.raises(ValueError, match="deterministic"):
        TsiDiagnostics(m).compute(s, mesh=mesh)
    with pytest.raises(ValueError, match="deterministic"):
        ConservationAudit(m).inventories(s, mesh=mesh)
