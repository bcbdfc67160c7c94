"""The port's configuration checks against ``uvic_tpu.checks``.

``validate`` of both packages on the same configuration (built in each
package's own ``config``): the same warnings, in the same order, or the
same ``ConfigError`` message.  The configurations are those of
``tests/test_forcing_checks.py`` (the reference's own checks tests),
plus the configurations the port builds (small, earth) and a coupled
model's ``config_warnings``.
"""

import dataclasses

import pytest

import uvic_tpu.config as JC
from uvic_tpu.checks import ConfigError as JConfigError
from uvic_tpu.checks import validate as j_validate

import uvic_tpu_torch.config as TC
from uvic_tpu_torch.checks import ConfigError, validate
from uvic_tpu_torch.coupler.driver import CoupledModel


def _ocean(**kw):
    return lambda C: C.ModelConfig().replace(
        ocean=dataclasses.replace(C.ModelConfig().ocean, **kw))


def _section(name, **kw):
    def make(C):
        cfg = C.ModelConfig()
        return cfg.replace(**{name: dataclasses.replace(
            getattr(cfg, name), **kw)})
    return make


CASES = {
    "defaults": lambda C: C.ModelConfig(),
    "small": lambda C: C.small_config(),
    "earth": lambda C: C.earth_config(),
    "earth_float64": lambda C: C.earth_config(dtype="float64"),
    "negative_dtts": _ocean(dtts=-1.0),
    "nitrogen_without_o2": lambda C: C.ModelConfig().replace(
        bgc=C.BgcConfig(suite="mobi", nitrogen=True, o2=False)),
    "caco3_without_carbon": lambda C: C.ModelConfig().replace(
        bgc=C.BgcConfig(suite="mobi", carbon=False, caco3=True)),
    "segment_not_whole_steps": _ocean(dtts=100000.0),
    "restoring_zero_damping": _ocean(restorst=True, dampts=(0.0, 30.0)),
    "fct_variant": _ocean(fct_variant="bogus"),
    "fct_3d_centered": _ocean(tracer_advection="centered", fct_3d=True),
    "sf_npt": _ocean(sf_npt=7),
    "aidif": _ocean(aidif=1.5),
    "dtxcel_below_one": _ocean(dtxcel_deep=0.5),
    "cpts": _section("ice", cpts=4),
    "tidal_kv_without_isopycmix": _ocean(tidal_kv=True, isopycmix=False,
                                         gent_mcwilliams=False),
    "acceleration": _ocean(dtxcel_deep=3.0),
    "dtatm": _section("embm", dtatm=50000.0),
    "tsiint": _section("time", tsiint=7.0),
    "mesh_too_fine": _section("parallel", mesh_shape=(16, 1)),
    "mesh": _section("parallel", mesh_shape=(2, 2)),
    "biharmonic": _ocean(hmix="biharmonic"),
    "gm_without_isopycmix": _ocean(isopycmix=False, gent_mcwilliams=True,
                                   tidal_kv=False),
    "ahisop": _ocean(ahisop=2.0e11),
    "x_bounds": _section("grid", x_bounds=(0.0, 350.0)),
    "acceleration_seasonal": lambda C: C.ModelConfig().replace(
        ocean=dataclasses.replace(C.ModelConfig().ocean, dtxcel_deep=3.0),
        embm=dataclasses.replace(C.ModelConfig().embm, seasonal=True)),
    "sediments": lambda C: C.ModelConfig().replace(
        sed=C.SedConfig(enabled=True)),
    "ppmix_explicit": _ocean(vmix="ppmix", aidif=0.0),
    "runlen": _section("time", runlen_days=12.5),
    "float64": lambda C: C.ModelConfig().replace(dtype="float64"),
}


def _outcome(validate_fn, error, cfg):
    try:
        return "warnings", validate_fn(cfg)
    except error as e:
        return "error", str(e)


@pytest.mark.parametrize("case", sorted(CASES))
def test_validate_matches_reference(case):
    make = CASES[case]
    got = _outcome(validate, ConfigError, make(TC))
    ref = _outcome(j_validate, JConfigError, make(JC))
    assert got == ref


def test_config_error_is_a_value_error():
    assert issubclass(ConfigError, ValueError)
    with pytest.raises(ConfigError, match="dtts"):
        validate(CASES["negative_dtts"](TC))


def test_coupled_model_keeps_the_warnings():
    cfg = TC.small_config(dtype="float64")
    m = CoupledModel(cfg, device="cpu")
    assert m.config_warnings == j_validate(JC.small_config(dtype="float64"))
    assert any("float64" in w for w in m.config_warnings)
