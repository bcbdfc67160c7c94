"""The port's time-interpolated forcing and restoring fluxes
(``uvic_tpu_torch.io.timeforce``) and its ``bcest`` against
``uvic_tpu``, on the CPU in float64.

- ``TimeInterpField`` at fractional years across every record, exactly at
  the record centers, across the year's wrap and in later years, with
  the default and with custom (uneven) centers, scale and offset: the
  port's field built from the same NumPy records, and the port's field
  carried across from the reference's arrays (``convert``), agree with
  the reference to 1e-12 of the records' magnitude;
- ``restoring_flux`` and ``restoring_stf`` (each row alone, both, none)
  to 1e-12 relative;
- ``default_surface_climatology`` in float64 and float32: records and
  centers bitwise equal, and the interpolated fields at 1e-12;
- ``bcest`` and ``bcest_fields``: bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.config import small_config as j_small_config
from uvic_tpu.core.grid import make_grid as j_make_grid
from uvic_tpu.io import bcest as j_bcest
from uvic_tpu.io import timeforce as j_tf

from uvic_tpu_torch.config import small_config as t_small_config
from uvic_tpu_torch.convert import time_interp_field_from_numpy
from uvic_tpu_torch.core.grid import make_grid as t_make_grid
from uvic_tpu_torch.io import bcest as t_bcest
from uvic_tpu_torch.io import timeforce as t_tf

RTOL = 1e-12
# fractional years: a dense sweep over three years (every record, the
# wrap at each year's end, years before 0 and after 1) and some exact
# points (0, the wrap, record centers and midpoints are added per field)
SWEEP = np.concatenate([np.linspace(-1.3, 2.3, 181),
                        [0.0, 1.0, 1.0 - 1e-12, 0.999999, 1e-9]])


def _fields(nrec, centers=None, scale=1.0, offset=0.0, seed=0):
    rng = np.random.default_rng(seed)
    rec = 10.0 + rng.standard_normal((nrec, 3, 4))
    jf = j_tf.TimeInterpField(rec, centers=centers, scale=scale,
                              offset=offset)
    tf = t_tf.TimeInterpField(rec, centers=centers, scale=scale,
                              offset=offset, device="cpu")
    return jf, tf


def _points(jf):
    c = np.asarray(jf.centers)
    mids = 0.5 * (c[:-1] + c[1:])
    return np.concatenate([SWEEP, c, c + 1.0, mids, mids - 1.0,
                           [0.5 * (c[-1] + c[0] + 1.0)]])


def _check(jf, tf):
    scale = np.abs(np.asarray(jf.records)).max()
    for relyr in _points(jf):
        ref = np.asarray(jf(relyr))
        for got in (tf(float(relyr)),
                    tf(torch.tensor(relyr, dtype=torch.float64))):
            err = np.abs(got.numpy() - ref).max()
            assert err <= RTOL * scale, (relyr, err)


@pytest.mark.parametrize("case", [
    dict(nrec=12),
    dict(nrec=12, scale=0.001, offset=-0.035),
    dict(nrec=5, centers=[0.02, 0.3, 0.31, 0.7, 0.97], scale=2.5,
         offset=1.0),
    dict(nrec=4, centers=[0.25, 0.4, 0.6, 0.95]),
    dict(nrec=1),
], ids=["monthly", "scale_offset", "uneven", "first_center_late",
        "one_record"])
def test_time_interp_field_matches_jax(case):
    jf, tf = _fields(**case)
    np.testing.assert_array_equal(tf.records.numpy(), np.asarray(jf.records))
    np.testing.assert_array_equal(tf.centers.numpy(), np.asarray(jf.centers))
    _check(jf, tf)
    # the reference's arrays carried across
    _check(jf, time_interp_field_from_numpy(np.asarray(jf.records),
                                            np.asarray(jf.centers), "cpu"))


def test_restoring_flux_and_stf_match_jax():
    rng = np.random.default_rng(1)
    data, model = rng.normal(size=(2, 5, 6)) * 3.0 + 15.0
    ref = np.asarray(j_tf.restoring_flux(data, model, 30.0, 50.0e2))
    got = t_tf.restoring_flux(torch.as_tensor(data), torch.as_tensor(model),
                              30.0, 50.0e2).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)

    jsst, tsst = _fields(12, seed=2)
    jsss, tsss = _fields(12, scale=0.001, offset=-0.035, seed=3)
    stf = rng.normal(size=(4, 3, 4))
    tsurf = rng.normal(size=(4, 3, 4)) + 10.0
    tmask = (rng.uniform(size=(3, 4)) > 0.3).astype(float)
    for sst_on, sss_on in ((True, True), (True, False), (False, True),
                           (False, False)):
        for relyr in (0.04, 0.5, 0.97, 3.2):
            ref = np.asarray(j_tf.restoring_stf(
                jnp.asarray(stf), jnp.asarray(tsurf), jsst if sst_on else None,
                jsss if sss_on else None, relyr, (30.0, 60.0),
                (50.0e2, 40.0e2), jnp.asarray(tmask)))
            got = t_tf.restoring_stf(
                torch.as_tensor(stf), torch.as_tensor(tsurf),
                tsst if sst_on else None, tsss if sss_on else None, relyr,
                (30.0, 60.0), (50.0e2, 40.0e2),
                torch.as_tensor(tmask)).numpy()
            np.testing.assert_allclose(got, ref, rtol=RTOL,
                                       atol=RTOL * np.abs(ref).max())
            np.testing.assert_array_equal(got[2:], stf[2:])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_default_surface_climatology_matches_jax(dtype):
    jg = j_make_grid(j_small_config().grid)
    tg = t_make_grid(t_small_config().grid)
    jfs = j_tf.default_surface_climatology(jg, dtype=dtype)
    tfs = t_tf.default_surface_climatology(tg, dtype=dtype, device="cpu")
    for jf, tf in zip(jfs, tfs):
        assert tf.records.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
        np.testing.assert_array_equal(tf.records.numpy(),
                                      np.asarray(jf.records))
        np.testing.assert_array_equal(tf.centers.numpy(),
                                      np.asarray(jf.centers))
        if dtype == np.float64:
            _check(jf, tf)


def test_bcest_matches_jax():
    lat = np.linspace(-90.0, 90.0, 361)
    for ref, got in zip(j_bcest.bcest(lat, lat + 0.9),
                        t_bcest.bcest(lat, lat + 0.9)):
        np.testing.assert_array_equal(got, ref)
    jg = j_make_grid(j_small_config().grid)
    tg = t_make_grid(t_small_config().grid)
    for dtype in (np.float64, np.float32):
        ref = j_bcest.bcest_fields(jg, dtype=dtype)
        got = t_bcest.bcest_fields(tg, dtype=dtype)
        assert list(got) == list(ref) == ["wsx", "wsy", "sst", "sss"]
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
