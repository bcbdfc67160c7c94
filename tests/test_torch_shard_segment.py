"""The port's rank-decomposed coupled segment
(``parallel.shard_segment.ShardedCoupledModel``) against the JAX
package's unsharded segment, the twin of
``tests/test_sharding.py::test_coupled_segment_sharded``, and against the
port's own unsharded segment.

The ranks are gloo CPU processes (``launch.spawn``), one block of the
mesh each, in float64; each mesh takes one spawn for all its cases.

- ``small_config`` km 8 with the reference test's ocean settings
  (isopycnal mixing off, dtts 43,200 s, dtuv and dtsf 1,800 s, tolrsf 1,
  mxscan 2,000), one segment from ``init_state`` (its first ocean step a
  mixing step): on (2, 4) at 34x44 (40 columns cannot hold the FCT halo
  of 9 with the ghost columns) and on (2, 2) at 34x40.
- ``mobi``: full MOBI with the pore-water sediments and the land,
  isopycnal/GM mixing on (the core's isopycnal path and the tail's bolus
  means on a halo-padded block), a 2.5-day segment (4 atmosphere and 5
  ocean steps) from itt 12, so that its last ocean step is a mixing step
  (nmix 16), on (2, 2).
- ``scan``: one MOBI mixing step of ``ShardedOceanStep.step(...,
  scan=True)``, which takes the leapfrog source instance with the step's
  interval as ``OceanModel._step(..., scan=True)`` does.

Tolerances:
- against the JAX package (test_sharding.py:121-135): ocean t at rtol
  1e-6 / atol 1e-5; atm.at and ice.hice at rtol 1e-9 / atol 1e-11;
- against the port's unsharded segment on the sharded core's tracer path
  (the generic step, ``fused_tracer`` off): every field of the gathered
  state, time means and forcing within TOL_PORT of the field's largest
  magnitude (measured: 0 on (2, 2), at most 3.5e-15 on (2, 4)), the
  counters, CG iterations and BiCGSTAB trips equal;
- every rank's whole components (atmosphere, ice, land, sediments, the
  barotropic fields) bitwise equal (one digest a rank).
"""

import dataclasses

import jax
import numpy as np
import pytest

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.coupler.driver import CoupledModel as JCoupledModel

from uvic_tpu_torch.config import mobi_full, small_config
from uvic_tpu_torch.convert import ocean_state_from_numpy
from uvic_tpu_torch.coupler.driver import CoupledModel
from uvic_tpu_torch.models.ocean.model import make_ocean
from uvic_tpu_torch.parallel.launch import spawn

from torch_rank_fns import (call_all, coupled_numpy, coupled_segment,
                            scan_mixing_step)
from torch_shard_runs import (BASE, SPAWN_S, one_thread, port_setup,
                              rel_gap, t_forcing, wind)

# test_sharding.py's ocean settings
OCEAN = dict(BASE, isopycmix=False, gent_mcwilliams=False)
TOL_T = dict(rtol=1e-6, atol=1e-5)
TOL_2D = dict(rtol=1e-9, atol=1e-11)
TOL_PORT = 1e-12
MOBI_ITT = 12
# name: (mesh, jmt, imt)
SEGMENTS = {"plain_2x4": ((2, 4), 34, 44), "plain_2x2": ((2, 2), 34, 40)}


def plain_cfg(small, jmt, imt):
    cfg = small(imt=imt, jmt=jmt, km=8)
    return cfg.replace(ocean=dataclasses.replace(cfg.ocean, **OCEAN))


def mobi_cfg():
    cfg = small_config(imt=40, jmt=34, km=8)
    return cfg.replace(
        ocean=dataclasses.replace(cfg.ocean, **BASE),
        bgc=mobi_full(),
        sed=dataclasses.replace(cfg.sed, enabled=True),
        land=dataclasses.replace(cfg.land, enabled=True),
        time=dataclasses.replace(cfg.time, segtim_days=2.5))


def port_segment(cfg, itt=None):
    """The port's unsharded segment on the generic tracer step."""
    with one_thread():
        m = CoupledModel(cfg, device="cpu")
        m.ocean.fused_tracer = False
        state = m.init_state()
        if itt is not None:
            state.ocean.itt = itt
        out = m.run_segment(state)
        return dict(state=coupled_numpy(out, m.last_tavg, m.last_forcing),
                    cg_iters=m.seg_cg_iters.numpy(),
                    trips=m.seg_trips.numpy())


def jax_segment(jmt, imt):
    m = JCoupledModel(plain_cfg(j_small_config, jmt, imt))
    out = m.run_segment(m.init_state())
    jax.block_until_ready(out.ocean.t)
    return {k: np.asarray(v) for k, v in (("t", out.ocean.t),
                                          ("at", out.atm.at),
                                          ("hice", out.ice.hice))}


def scan_case():
    """A primed MOBI state and its forcing (NumPy), and the port's
    unsharded mixing step with ``scan`` True and False."""
    cfg = small_config(imt=40, jmt=34, km=8).replace(bgc=mobi_full())
    cfg = cfg.replace(ocean=dataclasses.replace(cfg.ocean, **OCEAN))
    m = make_ocean(cfg, device="cpu")
    forcing = wind(m.params.grid, m.nt)
    primed = port_setup(cfg, forcing)
    m.fused_tracer = False
    refs = {}
    with one_thread():
        for scan in (True, False):
            s = m._step(ocean_state_from_numpy(primed, "cpu"),
                        t_forcing(forcing), leapfrog=False, scan=scan)
            refs[scan] = s.t.numpy()
    return dict(cfg=cfg, state=primed, forcing=forcing), refs


@pytest.fixture(scope="module")
def runs():
    """The references and the sharded runs: one spawn a mesh."""
    out = {}
    for name, (shape, jmt, imt) in SEGMENTS.items():
        out[name] = dict(jax=jax_segment(jmt, imt),
                         port=port_segment(plain_cfg(small_config, jmt,
                                                     imt)))
    out["mobi"] = dict(port=port_segment(mobi_cfg(), MOBI_ITT))
    scan_job, scan_refs = scan_case()
    out["scan"] = dict(refs=scan_refs)
    calls = {(2, 4): [(coupled_segment, dict(
                 cfg=plain_cfg(small_config, 34, 44)))],
             (2, 2): [(coupled_segment, dict(
                 cfg=plain_cfg(small_config, 34, 40))),
                 (coupled_segment, dict(cfg=mobi_cfg(), itt=MOBI_ITT)),
                 (scan_mixing_step, scan_job)]}
    res = {shape: spawn(call_all, shape, "gloo", "cpu", SPAWN_S, c)
           for shape, c in calls.items()}
    for name, n, shape in (("plain_2x4", 0, (2, 4)),
                           ("plain_2x2", 0, (2, 2)), ("mobi", 1, (2, 2)),
                           ("scan", 2, (2, 2))):
        out[name]["ranks"] = [rank[n] for rank in res[shape]]
    return out


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_segment_against_jax(runs, name):
    """test_sharding.py's contract on the gathered state."""
    got, ref = runs[name]["ranks"][0]["state"], runs[name]["jax"]
    np.testing.assert_allclose(got["ocean/t"], ref["t"], **TOL_T)
    np.testing.assert_allclose(got["atm/at"], ref["at"], **TOL_2D)
    np.testing.assert_allclose(got["ice/hice"], ref["hice"], **TOL_2D)


@pytest.mark.parametrize("name", sorted(SEGMENTS) + ["mobi"])
def test_segment_against_port(runs, name):
    """Every field of the gathered state, time means and forcing within
    TOL_PORT of its scale; counters, CG iterations and trips equal."""
    r0, ref = runs[name]["ranks"][0], runs[name]["port"]
    got, want = r0["state"], ref["state"]
    assert set(got) == set(want)
    for k in want:
        if k in ("itt", "nats"):
            assert got[k] == want[k], k
        else:
            assert got[k].shape == want[k].shape, k
            assert rel_gap(got[k], want[k]) <= TOL_PORT, k
    np.testing.assert_array_equal(r0["cg_iters"], ref["cg_iters"])
    np.testing.assert_array_equal(r0["trips"], ref["trips"])
    if name == "mobi":
        # the segment held a mixing step and carried the bgc means
        assert any("surf_dic" in k for k in want)
        assert "tavg/vetiso" in want and "sed/calgg" in want


@pytest.mark.parametrize("name", sorted(SEGMENTS) + ["mobi"])
def test_replicated_components_bitwise(runs, name):
    """Every rank's whole components bitwise equal to rank 0's."""
    ranks = runs[name]["ranks"]
    assert len({r["digest"] for r in ranks}) == 1
    for r in ranks:
        np.testing.assert_array_equal(r["cg_iters"], ranks[0]["cg_iters"])


def test_scan_mixing_step(runs):
    """A MOBI mixing step with scan=True on (2, 2) equals the port's
    ``_step(..., scan=True)`` within TOL_PORT; the forward source
    instance (scan False) lies far from it, so the check sees the
    choice."""
    got = runs["scan"]["ranks"][0]
    refs = runs["scan"]["refs"]
    assert rel_gap(got, refs[True]) <= TOL_PORT
    assert rel_gap(refs[False], refs[True]) > 1e3 * TOL_PORT
