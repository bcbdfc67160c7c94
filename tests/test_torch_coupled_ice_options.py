"""The port's sea-ice options against ``uvic_tpu`` on the CPU, in float64:
the sea ice off (``ice.enabled = False``), the ice without EVP dynamics
(``ice.evp = False``: no advection, no ice stress on the ocean) and the
free-drift ice-ocean stress (``ice_ocn_stress = "freedrift"``) with its
cap at 0.1 (below the ~0.3-0.5 the EVP stress divergence reaches here,
so the cap acts) and at 0 (no cap).

Two segments of each in both packages, with the set-up, the tolerance
(1e-9 of each field's largest value) and the checks of
``test_torch_coupled_options.py``: every field of the state, the last
segment's ocean forcing and flux totals.
"""

import dataclasses

import pytest
import torch

from test_torch_coupled_options import check_segment, check_state, run_both
from torch_threads import torch_one_thread  # noqa: F401  (autouse)


def _ice(**kw):
    def change(cfg):
        return dict(ice=dataclasses.replace(cfg.ice, **kw))
    return change


OPTIONS = {
    "no_ice": _ice(enabled=False),
    "no_evp": _ice(evp=False),
    "freedrift_cap": _ice(ice_ocn_stress="freedrift",
                          ice_ocn_stress_cap=0.1),
    "freedrift_uncapped": _ice(ice_ocn_stress="freedrift",
                               ice_ocn_stress_cap=0.0),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_ice_option_segments_match_reference(option):
    r = run_both(OPTIONS[option])
    check_state(r)
    check_segment(r)
    ts = r["ts"]
    assert bool(torch.isfinite(ts.ocean.t).all())
    if option == "no_ice":
        assert float(ts.ice.hice.abs().max()) == 0.0
    else:
        assert float(ts.ice.hice.max()) > 1.0        # ice formed
    if option == "no_evp":
        # without the dynamics the ice does not move
        assert torch.equal(ts.ice.uice, torch.zeros_like(ts.ice.uice))
