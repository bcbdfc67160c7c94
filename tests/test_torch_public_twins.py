"""The public functions of the JAX package that the port had lacked, each
against the JAX function on the same inputs (the twins of the JAX tests
that cover them):

- ``models.embm.insolation.orbital_params`` (``tests/test_embm.py::
  test_berger_orbital_series``): bitwise, both NumPy series; the 6 ka
  northern-summer insolation anomaly through the port's
  ``daily_insolation``;
- ``core.topog.set_kmt_region`` (``tests/test_topog.py::
  test_set_kmt_region_and_bcest``): ``kmt`` equal;
- ``ops.filters.fir_filter`` (``tests/test_ops.py::
  test_fir_matrix_matches_unrolled``): the unrolled passes against the
  port's matrix filter and against the JAX function, within 1e-12;
- ``models.ocean.isopyc.iso_tendency`` (``tests/test_isopyc.py::
  test_iso_weight_pack_matches_isoflux``): against the port's
  ``iso_flux_tendency`` (the same flux divergence composed from
  ``isoflux``) and against the JAX function, within 1e-12 of the
  tendency's largest magnitude;
- ``ops.stencil.interior_mask`` and ``zero_boundary_rows``,
  ``core.grid.Grid.shape2d`` and ``shape3d``: equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.core.grid import make_grid as j_make_grid
from uvic_tpu.core.topog import idealized_kmt as j_idealized_kmt
from uvic_tpu.core.topog import set_kmt_region as j_set_kmt_region
from uvic_tpu.models.embm.insolation import orbital_params as j_orbital
from uvic_tpu.ops import stencil as j_stencil
from uvic_tpu.ops.filters import fir_filter as j_fir_filter

from uvic_tpu_torch.config import small_config
from uvic_tpu_torch.core.grid import make_grid
from uvic_tpu_torch.core.topog import idealized_kmt, set_kmt_region
from uvic_tpu_torch.models.embm.insolation import (daily_insolation,
                                                   orbital_params)
from uvic_tpu_torch.ops import stencil
from uvic_tpu_torch.ops.filters import build_fir_filter, fir_filter

TOL_FIR = 1e-12
TOL_ISO = 1e-12


@pytest.mark.parametrize("year", [1950.0, 1950.0 - 6000.0,
                                  1950.0 - 21000.0, 2400.0])
def test_orbital_params_bitwise(year):
    got, ref = orbital_params(year), j_orbital(year)
    for a, b in zip(got, ref):
        assert float(a) == float(b)


def test_orbital_params_paleo_checkpoints():
    """test_embm.py's checkpoints: the modern epoch, 6 ka and 21 ka, and
    the 6 ka northern-summer insolation anomaly."""
    e0, o0, p0 = orbital_params(1950.0)
    assert abs(e0 - 0.016724) < 0.003
    assert abs(np.rad2deg(o0) - 23.446) < 0.05
    assert abs((np.rad2deg(p0) - 102.04 + 180) % 360 - 180) < 3.0
    e6, o6, p6 = orbital_params(1950.0 - 6000.0)
    assert abs(np.rad2deg(o6) - 24.105) < 0.1
    assert abs((np.rad2deg(p6) - 0.87 + 180) % 360 - 180) < 5.0
    _, o21, _ = orbital_params(1950.0 - 21000.0)
    assert abs(np.rad2deg(o21) - 22.949) < 0.1
    lat = torch.deg2rad(torch.tensor([[65.0]], dtype=torch.float64))
    day = torch.tensor(172.0, dtype=torch.float64)
    q0 = float(daily_insolation(lat, day, ecc=e0, obliq=float(o0),
                                per=float(p0))[0, 0])
    q6 = float(daily_insolation(lat, day, ecc=e6, obliq=float(o6),
                                per=float(p6))[0, 0])
    assert q6 > q0 + 1.0e4


def test_set_kmt_region_matches_reference():
    grid, jgrid = make_grid(small_config().grid), \
        j_make_grid(j_small_config().grid)
    kmt = idealized_kmt(grid, "world")
    args = (-10.0, 40.0, 80.0, 10.0, 50.0, 90.0, 0)
    out = set_kmt_region(kmt, grid, *args)
    ref = j_set_kmt_region(j_idealized_kmt(jgrid, "world"), jgrid, *args)
    np.testing.assert_array_equal(out, ref)
    assert (out != kmt).any()
    j = int(np.argmin(np.abs(np.asarray(grid.yt))))
    assert out[j, np.argmin(np.abs(np.asarray(grid.xt) - 60.0))] == 0
    assert (out[0] == kmt[0]).all()


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_fir_filter_matches_matrix_and_reference(kind):
    rng = np.random.default_rng(0)
    km, jmt, imt = 3, 10, 16
    mask = (rng.random((km, jmt, imt)) > 0.3).astype(np.float64)
    mask[..., 0] = mask[..., -2]
    mask[..., -1] = mask[..., 1]
    npass = np.array([0, 0, 1, 3, 0, 0, 2, 4, 0, 0])
    field = rng.standard_normal((2, km, jmt, imt))
    got = fir_filter(torch.as_tensor(field), torch.as_tensor(mask)[None],
                     npass, kind, True).numpy()
    mat = build_fir_filter(mask, npass, kind, True)(
        torch.as_tensor(field)).numpy()
    ref = np.asarray(j_fir_filter(jnp.asarray(field),
                                  jnp.asarray(mask)[None], npass, kind,
                                  True))
    np.testing.assert_allclose(got, mat, rtol=0, atol=TOL_FIR)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_FIR)
    # no row filtered: the field comes back as it was given
    f = torch.as_tensor(field)
    assert fir_filter(f, torch.as_tensor(mask)[None], np.zeros(jmt, int),
                      kind) is f


def test_iso_tendency_matches_isoflux_and_reference():
    from uvic_tpu.models.ocean.isopyc import compute_isopyc as j_isopyc
    from uvic_tpu.models.ocean.isopyc import iso_tendency as j_tendency
    from uvic_tpu.models.ocean.isopyc import iso_weight_pack as j_pack
    from uvic_tpu.models.ocean.model import make_ocean as j_make_ocean

    from uvic_tpu_torch.models.ocean.isopyc import (compute_isopyc,
                                                    iso_tendency,
                                                    iso_weight_pack)
    from uvic_tpu_torch.models.ocean.kernels import iso_flux_tendency
    from uvic_tpu_torch.models.ocean.model import make_ocean

    def cfg_of(small):
        cfg = small(imt=40, jmt=34, km=8)
        return cfg.replace(ocean=dataclasses.replace(
            cfg.ocean, isopycmix=True, gent_mcwilliams=True,
            aniso_zonal=True))

    m, jm = make_ocean(cfg_of(small_config), device="cpu"), \
        j_make_ocean(cfg_of(j_small_config))
    grid = m.params.grid
    rng = np.random.default_rng(21)
    lat = np.asarray(grid.yt)[:, None]
    t0 = np.zeros((3, grid.km, grid.jmt, grid.imt))
    t0[0] = ((16.0 * np.exp(-np.asarray(grid.zt) / 800e2))[:, None, None]
             * (0.5 + 0.5 * np.cos(np.deg2rad(lat)))[None])
    t0[1] = 2e-4 * rng.normal(size=t0[1].shape)
    t0[2] = rng.normal(size=t0[2].shape)
    t0 *= np.asarray(m.tmask)
    t0[..., 0], t0[..., -1] = t0[..., -2], t0[..., 1]
    t = torch.as_tensor(t0)
    iso = compute_isopyc(t[:2], m.tmask, m.kmt, m.eos_c, m.eos_to,
                         m.eos_so, m.g, m.cfg.ocean, True,
                         addisop=m.addisop)
    got = iso_tendency(t, iso_weight_pack(iso, m.g), m.tmask, m.g).numpy()
    old = iso_flux_tendency(iso, t, m.tmask, m.g, True).numpy()
    jt = jnp.asarray(t0)
    jiso = j_isopyc(jt[:2], jm.tmask, jm.kmt, jm.eos_c, jm.eos_to,
                    jm.eos_so, jm.g, jm.cfg.ocean, True, addisop=jm.addisop)
    ref = np.asarray(j_tendency(jt, j_pack(jiso, jm.g), jm.tmask, jm.g))
    scale = np.abs(ref).max()
    assert np.abs(got - old).max() <= TOL_ISO * scale
    assert np.abs(got - ref).max() <= TOL_ISO * scale


def test_stencil_boundary_helpers_and_grid_shapes():
    a = np.random.default_rng(1).standard_normal((3, 6, 7))
    np.testing.assert_array_equal(
        stencil.zero_boundary_rows(torch.as_tensor(a)).numpy(),
        np.asarray(j_stencil.zero_boundary_rows(jnp.asarray(a))))
    np.testing.assert_array_equal(
        stencil.interior_mask(6, 7, torch.float64).numpy(),
        np.asarray(j_stencil.interior_mask(6, 7, jnp.float64)))
    grid, jgrid = make_grid(small_config().grid), \
        j_make_grid(j_small_config().grid)
    assert grid.shape2d == jgrid.shape2d == (grid.jmt, grid.imt)
    assert grid.shape3d == jgrid.shape3d == (grid.km, grid.jmt, grid.imt)
