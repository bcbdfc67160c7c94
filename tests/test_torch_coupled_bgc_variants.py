"""The port's coupled carbon cycle against ``uvic_tpu`` on the CPU, in
float64: the variants of ``test_torch_coupled_bgc.py``'s configuration.

- the NPZD suite of ``scripts/run_production.py --bgc npzd`` (carbon,
  alkalinity, O2, nitrogen) over the pore-water sediments;
- the legacy sediments (``SedConfig(porewater=False)``: the interfacial
  closure on the bottom water's ``co2calc_sws`` carbonate);
- transient forcing with CFCs (``TransientForcing.default()`` from year
  1990): the CFC-11 and CFC-12 gas exchange and the atmospheric
  Delta-14C in the c14 flux.

Each runs both packages' ``Run`` over two segments and holds the state,
the time means, the forcing and the written means as the main file
does (its helpers, its tolerances).
"""

import dataclasses

import pytest

from test_torch_coupled_bgc import (check_forcing, check_means, check_state,
                                    check_written_means, run_both)


def _npzd(cfg, C):
    return cfg.replace(bgc=C.BgcConfig(suite="npzd", carbon=True, alk=True,
                                       o2=True, nitrogen=True))


def _legacy(cfg, C):
    return cfg.replace(sed=dataclasses.replace(cfg.sed, porewater=False))


def _year_1990(cfg, C):
    return cfg.replace(time=dataclasses.replace(cfg.time, year0=1990))


# (configuration change, transient forcing, the tracers that must
# exchange gas, the tracers the sediments must feed at the bottom)
VARIANTS = {
    # no CaCO3 rain in NPZD: the sediments return no alkalinity
    "npzd": (_npzd, None, ("dic", "o2"), ("dic",)),
    "legacy_sediments": (_legacy, None, ("dic", "o2", "c14"),
                         ("dic", "alk")),
    "transient_cfc": (_year_1990,
                      lambda F: F.TransientForcing.default(),
                      ("dic", "o2", "c14", "cfc11", "cfc12"),
                      ("dic", "alk")),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request, tmp_path_factory):
    over, transient, gas, bottom = VARIANTS[request.param]
    r = run_both(tmp_path_factory.mktemp(request.param), over, transient)
    r.update(name=request.param, gas=gas, bottom=bottom)
    return r


def test_variant_matches_reference(variant):
    for component in ("ocean", "atm", "ice", "sed"):
        check_state(variant, component)
    check_means(variant)
    check_forcing(variant, variant["gas"], variant["bottom"])
    check_written_means(variant)
    tm = variant["tm"]
    if variant["name"] == "transient_cfc":
        assert tm.cfcccn is not None and min(tm.cfcccn) > 100.0
        assert "cfcccn" in tm.segment_inputs()
        assert tm.dc14ccn != 0.0
    if variant["name"] == "legacy_sediments":
        assert type(variant["ts"].sed).__name__ == "SedState"
