"""The port's air-sea gas exchange against ``uvic_tpu`` on the CPU, in
float64.

The gasbc.F helpers (O2 saturation, Schmidt numbers, CFC solubility and
saturation, the hemispheric blend, the piston velocity) and
``surface_gas_fluxes`` on seeded surface fields agree with the JAX
package's to rtol 1e-12: the full MOBI suite with and without the CFC
atmosphere, with an atmospheric Delta-14C, and the NPZD suite without
alkalinity (the salinity-scaled default), and with a given one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import BgcConfig as JBgc
from uvic_tpu.config import mobi_full as j_mobi_full
from uvic_tpu.coupler.tracers import TracerIndex as JIndex
from uvic_tpu.coupler.tracers import build_registry as j_registry
from uvic_tpu.models.bgc import gasx as jg

from uvic_tpu_torch.config import BgcConfig as TBgc
from uvic_tpu_torch.config import mobi_full as t_mobi_full
from uvic_tpu_torch.coupler.tracers import TracerIndex as TIndex
from uvic_tpu_torch.coupler.tracers import build_registry as t_registry
from uvic_tpu_torch.models.bgc import gasx as tg

RTOL = 1e-12
SHAPE = (7, 9)
NPZD_NO_ALK = dict(suite="npzd", carbon=True, o2=True, nitrogen=True)


def _close(got, ref, what, rtol=RTOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


def _surface(seed, registry):
    """Seeded SST, SSS, wind speed, open water and surface tracers near
    each tracer's initial value."""
    rng = np.random.default_rng(seed)
    sst = rng.uniform(-3.0, 33.0, SHAPE)      # beyond the clip on both ends
    sss = rng.uniform(30.0, 38.0, SHAPE)
    wspd = rng.uniform(100.0, 1500.0, SHAPE)  # cm/s
    ao = rng.uniform(0.0, 1.0, SHAPE)
    ao[0, :3] = 0.0
    init = np.array([max(t.init, 1e-3) for t in registry])
    surf = init[:, None, None] * np.exp(0.1 * rng.standard_normal(
        (len(registry),) + SHAPE))
    return sst, sss, wspd, ao, surf


def _t(x):
    return torch.from_numpy(np.array(x))


def test_helpers_match():
    rng = np.random.default_rng(1)
    t = rng.uniform(-2.0, 35.0, SHAPE)
    s = rng.uniform(0.0, 45.0, SHAPE)
    lat = rng.uniform(-90.0, 90.0, SHAPE)
    _close(tg.o2_saturation(_t(t), _t(s)),
           jg.o2_saturation(jnp.asarray(t), jnp.asarray(s)), "o2sat")
    for name in ("schmidt_co2", "schmidt_o2", "schmidt_cfc11",
                 "schmidt_cfc12"):
        _close(getattr(tg, name)(_t(t)), getattr(jg, name)(jnp.asarray(t)),
               name)
    for which in (11, 12):
        _close(tg.cfc_solubility(_t(t), _t(s), which),
               jg.cfc_solubility(jnp.asarray(t), jnp.asarray(s), which),
               f"cfc{which} solubility")
        _close(tg.cfc_saturation(_t(t), _t(s), 250.0, which),
               jg.cfc_saturation(jnp.asarray(t), jnp.asarray(s), 250.0,
                                 which), f"cfc{which} saturation")
    _close(tg.hemispheric_blend(_t(lat), 255.3, 239.8),
           jg.hemispheric_blend(jnp.asarray(lat), 255.3, 239.8), "blend")
    sc = tg.schmidt_co2(_t(t))
    w, ao = rng.uniform(0, 2000, SHAPE), rng.uniform(0, 1, SHAPE)
    _close(tg.piston_velocity(_t(w), sc, _t(ao)),
           jg.piston_velocity(jnp.asarray(w), jg.schmidt_co2(jnp.asarray(t)),
                              jnp.asarray(ao)), "piston velocity")


CASES = {
    "mobi": dict(suite="mobi"),
    "mobi_cfc_c14": dict(suite="mobi", cfc=(255.3, 239.8, 530.1, 525.6),
                         dc14ccn=-45.0, co2ccn=353.2),
    "mobi_cfc_tensor_inputs": dict(suite="mobi",
                                   cfc=(255.3, 239.8, 530.1, 525.6),
                                   dc14ccn=120.0, co2ccn=412.0,
                                   tensors=True),
    "npzd_no_alk": dict(suite="npzd_no_alk"),
    "npzd_no_alk_given": dict(suite="npzd_no_alk", alk_default=2.31),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_surface_gas_fluxes_match(case):
    c = CASES[case]
    if c["suite"] == "mobi":
        jb, tb = j_mobi_full(), t_mobi_full()
    else:
        jb, tb = JBgc(**NPZD_NO_ALK), TBgc(**NPZD_NO_ALK)
    jr, tr = j_registry(jb), t_registry(tb)
    ji, ti = JIndex(jr), TIndex(tr)
    assert ("alk" in ti) == (c["suite"] == "mobi")
    sst, sss, wspd, ao, surf = _surface(2, tr)
    lat = np.broadcast_to(np.linspace(-80.0, 80.0, SHAPE[0])[:, None],
                          SHAPE)
    kw_j, kw_t = {}, {}
    for k in ("co2ccn", "dc14ccn", "alk_default"):
        if k in c:
            kw_j[k] = c[k]
            kw_t[k] = (torch.tensor(c[k], dtype=torch.float64)
                       if c.get("tensors") else c[k])
    if "cfc" in c:
        n11, s11, n12, s12 = c["cfc"]
        kw_j["cfc_atm"] = (jg.hemispheric_blend(jnp.asarray(lat), n11, s11),
                           jg.hemispheric_blend(jnp.asarray(lat), n12, s12))
        kw_t["cfc_atm"] = (tg.hemispheric_blend(_t(lat), n11, s11),
                           tg.hemispheric_blend(_t(lat), n12, s12))
    jflux, jd = jg.surface_gas_fluxes(
        jnp.asarray(sst), jnp.asarray(sss), jnp.asarray(wspd),
        jnp.asarray(ao), jnp.asarray(surf), ji, **kw_j)
    tflux, td = tg.surface_gas_fluxes(_t(sst), _t(sss), _t(wspd), _t(ao),
                                      _t(surf), ti, **kw_t)
    assert tflux.shape == surf.shape and set(td) == set(jd)
    names = ti.names
    for n, name in enumerate(names):
        _close(tflux[n], jflux[n], f"flux {name}")
    for k in jd:
        _close(td[k], jd[k], k)
    # the gas tracers exchange, every other row is zero
    gas = {"dic", "o2"} | ({"c14"} if "c14" in ti else set()) \
        | ({"cfc11", "cfc12"} if "cfc" in c else set())
    for n, name in enumerate(names):
        moved = bool(torch.any(tflux[n] != 0))
        assert moved == (name in gas), name
