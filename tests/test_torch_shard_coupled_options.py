"""The coupled options on the port's rank-decomposed coupled segment
(``parallel.shard_segment.ShardedCoupledModel``) against the port's
unsharded segment.

Each option runs ``ShardedCoupledModel.run`` on a (2, 2) mesh of gloo
CPU ranks (one spawn for them all, ``torch_rank_fns.call_all``), in
float64, from the cold-pole state of ``test_torch_coupled_options.py``
(ice forms and rejects brine; seeded noise keeps the columns off exact
density ties), on ``small_config`` at 34x40x8 with the sharded tests'
ocean settings (``torch_shard_runs.BASE``, isopycnal mixing off but
where the option needs it):

- ``dtxcel_deep``: the spin-up's deep tracer acceleration (4, with
  isopycnal/GM mixing);
- ``transient_awind``: two segments under transient forcing (CO2, solar,
  volcanic, sulphate, other greenhouse gases and land ice changing
  within them) with the anomalous winds of a climatology 2 K colder
  than the start, so that ``run`` reaches ``_update_transient`` before
  each segment and the head stage the anomalous winds;
- ``brine``: brine convection, its fluxes ``cbf``/``cba`` cut to each
  rank's block in the mid stage;
- ``cpts``: three ice categories; ``no_ice``: the sea ice off;
  ``no_evp``: the ice without EVP dynamics; ``freedrift``: the
  free-drift ice-ocean stress with its cap.

The gathered state, time means and forcing of the last segment are held
against the port's unsharded segment on the sharded core's tracer path
(the generic step, ``fused_tracer`` off) within 1e-12 of each field's
largest magnitude, the counters exactly; each segment's CG iterations
and BiCGSTAB trips equal; every rank's whole components (atmosphere,
ice, CPTS, land, the barotropic fields) bitwise equal, one digest a
rank.
"""

import dataclasses

import numpy as np
import pytest

from uvic_tpu_torch.config import small_config
from uvic_tpu_torch.coupler.driver import CoupledModel
from uvic_tpu_torch.parallel.launch import spawn

from test_torch_coupled_options import initial_t
from torch_rank_fns import (call_all, coupled_model, coupled_numpy,
                            coupled_run)
from torch_shard_runs import BASE, SPAWN_S, rel_gap
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

SHAPE = (2, 2)
TOL_PORT = 1e-12


def _ocean(**kw):
    return lambda cfg: dict(ocean=dataclasses.replace(cfg.ocean, **kw))


def _ice(**kw):
    return lambda cfg: dict(ice=dataclasses.replace(cfg.ice, **kw))


def _awind(cfg):
    return dict(embm=dataclasses.replace(cfg.embm, awind=True))


# option -> (configuration change, segments, transient forcing)
OPTIONS = {
    "dtxcel_deep": (_ocean(dtxcel_deep=4.0, isopycmix=True,
                           gent_mcwilliams=True), 1, False),
    "transient_awind": (_awind, 2, True),
    "brine": (_ocean(convect_brine=True), 1, False),
    "cpts": (_ice(cpts=3, nlay=4), 1, False),
    "no_ice": (_ice(enabled=False), 1, False),
    "no_evp": (_ice(evp=False), 1, False),
    "freedrift": (_ice(ice_ocn_stress="freedrift", ice_ocn_stress_cap=0.1),
                  1, False),
}


def config(option):
    cfg = small_config(imt=40, jmt=34, km=8).replace(dtype="float64")
    cfg = cfg.replace(ocean=dataclasses.replace(
        cfg.ocean, isopycmix=False, gent_mcwilliams=False, **BASE))
    return cfg.replace(**OPTIONS[option][0](cfg))


def case(option):
    """The keyword arguments of ``coupled_run`` for an option."""
    cfg = config(option)
    _, nseg, transient = OPTIONS[option]
    m = CoupledModel(cfg, device="cpu")
    kw = dict(cfg=cfg, t0=initial_t(m.grid, m.topo.tmask), nseg=nseg,
              transient=transient)
    if m.awind is not None:
        # a climatology 2 K colder than the start, with a zonal wave
        sat = m.init_state(kw["t0"]).atm.at[0].numpy()
        kw["awind_clim"] = (sat - 2.0 + 0.5 * np.sin(
            np.arange(sat.shape[1]))[None, :])
    return kw


def port_run(cfg, t0=None, nseg=1, transient=False, awind_clim=None):
    """The port's unsharded segments on the generic tracer step: the
    records of the last, and each segment's counters and inputs."""
    m, state = coupled_model(cfg, "cpu", t0, transient, awind_clim)
    m.ocean.fused_tracer = False
    cg_iters, trips, inputs = [], [], []
    for _ in range(nseg):
        state = m.run(state, 1)
        cg_iters.append(m.seg_cg_iters.numpy())
        trips.append(m.seg_trips.numpy())
        # the inputs the segment ran on (relyr has moved on since)
        inputs.append({k: v.numpy().copy()
                       for k, v in m.segment_inputs().items()})
    return dict(state=coupled_numpy(state, m.last_tavg, m.last_forcing),
                cg_iters=cg_iters, trips=trips, inputs=inputs)


@pytest.fixture(scope="module")
def runs():
    """Every option's unsharded run and its sharded ranks (one spawn)."""
    cases = {name: case(name) for name in OPTIONS}
    out = {name: dict(port=port_run(**kw)) for name, kw in cases.items()}
    res = spawn(call_all, SHAPE, "gloo", "cpu", SPAWN_S,
                [(coupled_run, kw) for kw in cases.values()])
    for n, name in enumerate(cases):
        out[name]["ranks"] = [rank[n] for rank in res]
    return out


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_sharded_option_segment_against_port(runs, option):
    """Every field of the gathered state, time means and forcing within
    TOL_PORT of its scale; the counters equal."""
    got = runs[option]["ranks"][0]["state"]
    want = runs[option]["port"]["state"]
    assert set(got) == set(want)
    for k in want:
        if k in ("itt", "nats"):
            assert got[k] == want[k], k
        else:
            assert got[k].shape == want[k].shape, k
            assert rel_gap(got[k], want[k]) <= TOL_PORT, k


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_sharded_option_solver_counts(runs, option):
    """Each segment's CG iterations and BiCGSTAB trips equal to the
    unsharded segment's."""
    r0, ref = runs[option]["ranks"][0], runs[option]["port"]
    assert len(r0["cg_iters"]) == len(ref["cg_iters"]) == OPTIONS[option][1]
    for got, want in zip(r0["cg_iters"], ref["cg_iters"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(r0["trips"], ref["trips"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_sharded_option_replicated_bitwise(runs, option):
    """Every rank's whole components bitwise equal to rank 0's."""
    ranks = runs[option]["ranks"]
    assert len({r["digest"] for r in ranks}) == 1
    for r in ranks:
        for got, want in zip(r["cg_iters"], ranks[0]["cg_iters"]):
            np.testing.assert_array_equal(got, want)


def test_options_reach_their_paths(runs):
    """The runs take the paths they stand for: ice forms; brine fluxes
    drive the ocean; three ice categories; no ice; the transient inputs
    change between the two segments and the anomalous winds are on."""
    st = {name: r["port"]["state"] for name, r in runs.items()}
    assert st["cpts"]["ice/hice"].max() > 1.0
    assert np.abs(st["brine"]["forcing/cbf"]).max() > 0.0
    assert "cpts/A" in st["cpts"] and st["cpts"]["cpts/A"].max() > 0.0
    assert "cpts/A" not in st["no_evp"]
    assert st["no_ice"]["ice/hice"].max() == 0.0
    assert not np.array_equal(st["freedrift"]["ocean/u"],
                              st["no_evp"]["ocean/u"])
    first, last = runs["transient_awind"]["port"]["inputs"]
    assert "awind_clim" in first and "sulph" in first
    assert float(last["co2ccn"]) != float(first["co2ccn"])
    assert not np.array_equal(st["dtxcel_deep"]["ocean/t"],
                              st["brine"]["ocean/t"])
