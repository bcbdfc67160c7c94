"""The port's NaN harness (``uvic_tpu_torch.debug``) against
``uvic_tpu.debug``, on the CPU in float64.

The coupled model of ``tests/test_coupled.py``'s bisector test
(``small_config``, isopycnal mixing off, dtts 43,200 s) from each
package's ``init_state()`` (the reference's state carried into the
port):

- ``nan_report`` on nested dicts and tuples and on clean and poisoned
  coupled states: the same (key, count, first index) entries, in the
  same order, as the reference's;
- ``bisect_segment`` with two atmosphere substeps, on the clean state, on
  a copy with one ``hice`` cell set to NaN and on a copy with one deep
  ocean temperature set to NaN: the reference's ``ok`` and ``phase``
  (``"atm_ice substep 0"``, ``"ocean substep 0"``), the first entries of
  its ``detail`` too, and the caller's state left as it was.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.coupler.driver import CoupledModel as JCoupled
from uvic_tpu.debug import bisect_segment as j_bisect
from uvic_tpu.debug import nan_report as j_nan_report
from uvic_tpu.io.restart import _flatten_state

from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import (coupled_state_from_numpy,
                                    coupled_state_to_numpy)
from uvic_tpu_torch.coupler.driver import CoupledModel
from uvic_tpu_torch.debug import bisect_segment, nan_report

OCEAN = dict(isopycmix=False, gent_mcwilliams=False, dtts=43200.0,
             dtuv=1800.0, dtsf=1800.0, tolrsf=1e8)
SUBSTEPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the steps are many small operations, which a
    thread pool slows down when other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_nan_report_keys_match_jax():
    a = np.array([[1.0, np.nan], [np.inf, 2.0]])
    b = np.array([-np.inf, 0.0, np.nan])
    tree = dict(z=(a, None, 3), a=dict(k=b, j=np.arange(3)),
                c=[np.float64(np.nan), np.ones(2)])

    def j(x):
        return jnp.asarray(x) if isinstance(x, np.ndarray) \
            or isinstance(x, np.floating) else x

    def t(x):
        return torch.as_tensor(x) if isinstance(x, np.ndarray) \
            or isinstance(x, np.floating) else x

    jt = dict(z=(j(a), None, 3), a=dict(k=j(b), j=j(np.arange(3))),
              c=[j(tree["c"][0]), j(tree["c"][1])])
    tt = dict(z=(t(a), None, 3), a=dict(k=t(b), j=t(np.arange(3))),
              c=[t(tree["c"][0]), t(tree["c"][1])])
    for prefix in ("state", "x:"):
        ref = j_nan_report(jt, prefix=prefix)
        assert len(ref) == 3
        assert nan_report(tt, prefix=prefix) == ref


@pytest.fixture(scope="module")
def models():
    jc, tc = j_small_config(), t_small_config()
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **OCEAN))
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **OCEAN))
    jm, tm = JCoupled(jc), CoupledModel(tc, device="cpu")
    js = jm.init_state()
    ts = coupled_state_from_numpy(_flatten_state(js), tm.init_state())
    return jm, tm, js, ts


def _poisoned(js, ts, where):
    if where == "hice":
        j, i = 5, 5
        jb = js.replace(ice=js.ice.replace(
            hice=js.ice.hice.at[j, i].set(jnp.nan)))
        hice = ts.ice.hice.clone()
        hice[j, i] = float("nan")
        tb = dataclasses.replace(ts, ice=dataclasses.replace(ts.ice,
                                                             hice=hice))
    else:
        k, j, i = 3, 12, 15
        assert float(ts.ocean.t[0, k, j, i]) != 0.0
        jb = js.replace(ocean=js.ocean.replace(
            t=js.ocean.t.at[0, k, j, i].set(jnp.nan)))
        t = ts.ocean.t.clone()
        t[0, k, j, i] = float("nan")
        tb = dataclasses.replace(ts, ocean=dataclasses.replace(ts.ocean,
                                                               t=t))
    return jb, tb


@pytest.mark.parametrize("where", ["clean", "hice", "ocean_t"])
def test_nan_report_of_states_matches_jax(models, where):
    jm, tm, js, ts = models
    if where != "clean":
        js, ts = _poisoned(js, ts, where)
    ref = j_nan_report(js)
    assert nan_report(ts) == ref
    assert len(ref) == (0 if where == "clean" else 1)


@pytest.mark.parametrize("where,phase", [
    ("clean", None), ("hice", "atm_ice substep 0"),
    ("ocean_t", "ocean substep 0")])
def test_bisect_segment_matches_jax(models, where, phase):
    jm, tm, js, ts = models
    if where != "clean":
        js, ts = _poisoned(js, ts, where)
    before = coupled_state_to_numpy(ts)
    ref = j_bisect(jm, js, max_substeps=SUBSTEPS)
    got = bisect_segment(tm, ts, max_substeps=SUBSTEPS)
    assert (got["ok"], got["phase"]) == (ref["ok"], ref["phase"]) \
        == (where == "clean", phase)
    assert [tag for tag, _ in got["detail"]] \
        == [tag for tag, _ in ref["detail"]]
    if got["detail"]:
        assert [k for k, _, _ in got["detail"][0][1]] \
            == [k for k, _, _ in ref["detail"][0][1]]
    after = coupled_state_to_numpy(ts)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
