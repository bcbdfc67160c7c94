"""The PyTorch port builds the same constants as ``uvic_tpu``.

Grid, topography, island perimeters, EOS fit, barotropic operator,
filter matrices and the static mixing fields are host NumPy in both
packages; for this model they take the place of weights, so they must
be bitwise equal on the same configuration.

On the small grid the port is held against the JAX ``OceanModel``
itself.  On the standard 102x102x19 grid the JAX side is built from the
same host builders the JAX model calls (``build_ocean_params``,
``sfc5pt_unit``, ``build_hlat_filter``, ``make_inv``, the static mixing
fields), so that no JAX model is built at that size.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from uvic_tpu.config import ModelConfig as JModelConfig
from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.models.ocean.aniso import (equatorial_zonal_diffusivity,
                                        large_anisotropic_viscosity)
from uvic_tpu.models.ocean.gthflx import geoheatflux_field
from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean
from uvic_tpu.models.ocean.params import build_ocean_params
from uvic_tpu.models.ocean.tropic import sfc5pt_unit
from uvic_tpu.models.ocean.vmix import default_tidal_edr
from uvic_tpu.ops.filters import build_hlat_filter
from uvic_tpu.ops.solvers import IslandIndex, make_inv

from uvic_tpu_torch.config import ModelConfig as TModelConfig
from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.models.ocean.model import make_ocean as t_make_ocean
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

FLAGSHIP = dict(isopycmix=True, gent_mcwilliams=True, tidal_kv=True,
                gthflx=True, aniso_visc=True, aniso_zonal=True)

GRID_FIELDS = ("xt", "xu", "yt", "yu", "zt", "zw", "dxt", "dxu", "dyt",
               "dyu", "dzt", "dzw", "cst", "csu", "sine", "tng", "phi",
               "phit", "duw", "due", "dus", "dun", "dxmetr")
TOPO_FIELDS = ("kmt", "kmu", "tmask", "umask", "h", "hr", "ht", "land_map",
               "perim_id", "perim_count")
EOS_FIELDS = ("to", "so", "ro0", "c", "tmin", "tmax", "smin", "smax")
PARAM_FIELDS = ("cori", "advmet", "amc_north", "amc_south", "ahc_north",
                "ahc_south", "am3", "am4", "dtxcel")


def _jax_host_constants(cfg):
    """The flagship constants of the JAX ``OceanModel`` on ``cfg``, from
    the host builders its constructor calls, in float64."""
    p = build_ocean_params(cfg)
    g, topo, o = p.grid, p.topo, cfg.ocean
    km = g.km
    isl = IslandIndex(perim_id=np.asarray(topo.perim_id), nisle=topo.nisle,
                      counts=np.asarray(topo.perim_count),
                      imain=topo.imain,
                      ocean_mask=(topo.land_map <= 0).astype(np.float64))
    cf_unit, _ = sfc5pt_unit(np.asarray(g.dxu), np.asarray(g.dyu),
                             np.asarray(g.csu), np.asarray(topo.hr),
                             f=np.asarray(p.cori[0]), acor=o.acor)

    def filt(mask, lat, sym):
        return build_hlat_filter(o.hlat_filter, mask, np.asarray(lat),
                                 g.imt, sym, g.cyclic, cfg.np_dtype)

    area_t = (np.asarray(g.cst)[:, None] * np.asarray(g.dyt)[:, None]
              * np.asarray(g.dxt)[None, :])
    return SimpleNamespace(
        params=p, isl=isl, cf_unit=cf_unit,
        z_unit=make_inv(cf_unit, isl),
        filt_t=filt(topo.tmask, g.yt, "symmetric"),
        filt_u=filt(topo.umask, g.yu, "asymmetric"),
        filt_sf=filt((topo.land_map <= 0).astype(np.float64), g.yt,
                     "symmetric"),
        tidal_edr=default_tidal_edr(np.asarray(topo.kmt),
                                    np.asarray(g.dzt),
                                    ht_cm=np.asarray(topo.ht), area=area_t),
        aniso_visc=large_anisotropic_viscosity(
            np.asarray(g.yu), np.asarray(g.dxu), np.asarray(g.dyu),
            np.asarray(topo.umask)[0], np.asarray(g.zw)[:km], o.am,
            cyclic=g.cyclic),
        addisop=equatorial_zonal_diffusivity(np.asarray(g.yt)),
        bhf=geoheatflux_field(np.asarray(g.xt), np.asarray(g.yt)))


def _models(kind):
    if kind == "small":
        jc, tc = j_small_config(), t_small_config()
    else:
        jc, tc = JModelConfig(), TModelConfig()
    jc = jc.replace(ocean=dataclasses.replace(jc.ocean, **FLAGSHIP))
    tc = tc.replace(ocean=dataclasses.replace(tc.ocean, **FLAGSHIP))
    tm = t_make_ocean(tc, device="cpu")
    if kind == "small":
        return j_make_ocean(jc), tm
    return _jax_host_constants(jc), tm


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if hasattr(b, "numpy") else np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("kind", ["small", "standard"])
def test_params_bitwise_equal(kind):
    jm, tm = _models(kind)
    jp, tp = jm.params, tm.params
    for name in GRID_FIELDS:
        _eq(getattr(jp.grid, name), getattr(tp.grid, name), f"grid.{name}")
    for name in TOPO_FIELDS:
        _eq(getattr(jp.topo, name), getattr(tp.topo, name), f"topo.{name}")
    assert (jp.topo.nisle, jp.topo.imain) == (tp.topo.nisle, tp.topo.imain)
    for name in EOS_FIELDS:
        _eq(getattr(jp.eos, name), getattr(tp.eos, name), f"eos.{name}")
    for name in PARAM_FIELDS:
        _eq(getattr(jp, name), getattr(tp, name), name)
    assert jp.nt == tp.nt == 2

    # device constants of the two models
    _eq(jm.cf_unit, tm.cf_unit, "cf_unit")
    for name in ("filt_t", "filt_u", "filt_sf"):
        jf, tf = getattr(jm, name), getattr(tm, name)
        _eq(jf.rows, tf.rows, f"{name}.rows")
        _eq(jf.mats, tf.mats, f"{name}.mats")
    _eq(jm.tidal_edr, tm.tidal_edr, "tidal_edr")
    _eq(jm.aniso_visc[0], tm.aniso_visc[0], "visc_ceu")
    _eq(jm.aniso_visc[1], tm.aniso_visc[1], "visc_cnu")
    _eq(jm.addisop, tm.addisop, "addisop")
    _eq(jm.bhf, tm.bhf, "bhf")
    _eq(jm.isl.perim_id, tm.isl.perim_id, "isl.perim_id")
    _eq(jm.isl.counts, tm.isl.counts, "isl.counts")
    _eq(jm.isl.ocean_mask, tm.isl.ocean_mask, "isl.ocean_mask")
    _eq(make_inv(jm.cf_unit, jm.isl), tm.cg_solver.z_unit, "z_unit")
    jg = jm.g if kind == "small" else jp.grid
    for name in ("cstdxt2r", "cstdyt2r", "dztur", "dztlr", "csudxu2r"):
        _eq(getattr(jg, name), getattr(tm.g, name), f"g.{name}")
    if kind == "standard":
        return
    # fields the JAX constructor assembles itself (small grid only)
    _eq(jm.cdbot2d, tm.cdbot2d, "cdbot2d")
    _eq(jm.diff_cbt, tm.diff_cbt, "diff_cbt")
    _eq(jm.dztxcl, tm.dztxcl, "dztxcl")
