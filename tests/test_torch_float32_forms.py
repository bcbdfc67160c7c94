"""The float32 forms of the implicit vertical diffusion and of the
convection apply, on the CPU.

Both mix a column's values with weights that sum to one: the Thomas
solve of ``ops/tridiag.invtri`` (every wet row of its system sums to
one) and the normalised region matrix M of ``ops/convection``.  In
float32 that sum is one only to a rounding, the same in a column at
every step, so a form applied to the tracer's whole value drifts it:
~5e-7 K a step (the solve) and ~8e-8 K a step (the apply) in the
flagship's mean SST (``golden/regression/restoring_year.py --steps``).
The port solves for the increment and applies M to the differences
from the top of each region, the forms held here:

- in float32 a uniform column under any diffusivity and no flux is a
  fixed point of ``invtri``, bitwise, where the whole-value solve moves
  it; in float64 both forms agree to 1e-13;
- in float32 ``apply_region_means_ref`` leaves every level of a mixed
  region bitwise equal and is then a fixed point, bitwise, where the
  whole-value apply drifts when it is repeated; with a region matrix
  whose rows sum to one both forms agree in float64 to 1e-13.
"""

import numpy as np
import pytest
import torch

from uvic_tpu_torch.ops.convection import (apply_region_means_ref,
                                           region_mixing_matrix,
                                           region_reference)
from uvic_tpu_torch.ops.eos import fit_eos
from uvic_tpu_torch.ops.tridiag import invtri, solve_tridiag_masked

KM, JMT, IMT = 19, 6, 7


def column_inputs(dtype, seed=0):
    """Seeded coefficients of ``invtri`` on a (KM, JMT, IMT) block: level
    factors of a 19-level grid, diffusivities up to the 1e4 cm2/s of a
    steep isopycnal's K33, and some columns cut by land."""
    rng = np.random.default_rng(seed)
    dzt = np.linspace(5.0e3, 5.0e4, KM)
    dzw = np.concatenate([[0.5 * dzt[0]], 0.5 * (dzt[1:] + dzt[:-1]),
                          [0.5 * dzt[-1]]])
    kmz = rng.integers(0, KM + 1, (JMT, IMT))
    kmz[0, 0] = KM
    mask = (np.arange(KM)[:, None, None] < kmz[None]).astype(np.float64)
    dcb = 10.0 ** rng.uniform(0.0, 4.0, (KM, JMT, IMT))
    t = {k: torch.as_tensor(v, dtype=dtype) for k, v in dict(
        dztr=1.0 / dzt, dztur=1.0 / (dzw[:-1] * dzt),
        dztlr=1.0 / (dzw[1:] * dzt), dcb=dcb, mask=mask,
        tdt=np.full(KM, 2.0 * 86400.0)).items()}
    return t, torch.as_tensor(kmz)


def whole_value_invtri(z, c, kmz, aidif=1.0):
    """invtri.F solved for z itself, with no surface or bottom flux."""
    tdt = c["tdt"].reshape(KM, 1, 1)
    mask = c["mask"]
    a = -torch.cat([c["dcb"][:1], c["dcb"][:-1]]) \
        * (c["dztur"].reshape(KM, 1, 1) * tdt * aidif) * mask
    cc = -c["dcb"] * (c["dztlr"].reshape(KM, 1, 1) * tdt * aidif) \
        * torch.cat([mask[1:], mask[-1:]])
    a[0], cc[-1] = 0.0, 0.0
    return solve_tridiag_masked(a, 1.0 - a - cc, cc, z * mask, mask)


def port_invtri(z, c, kmz, topbc=None, botbc=None, aidif=1.0):
    zero = torch.zeros((JMT, IMT), dtype=z.dtype)
    return invtri(z, zero if topbc is None else topbc,
                  zero if botbc is None else botbc, c["dcb"], c["tdt"], kmz,
                  c["mask"], c["dztr"], c["dztur"], c["dztlr"], aidif)


@pytest.mark.parametrize("value", [20.3, -1.87, 34.72])
def test_a_uniform_column_is_a_fixed_point_of_the_float32_solve(value):
    c, kmz = column_inputs(torch.float32)
    z = torch.full((KM, JMT, IMT), value, dtype=torch.float32) * c["mask"]
    assert torch.equal(port_invtri(z, c, kmz), z)
    moved = whole_value_invtri(z, c, kmz)
    assert not torch.equal(moved, z)


@pytest.mark.parametrize("aidif", [0.5, 1.0])
def test_the_increment_solve_equals_the_whole_value_solve_in_float64(aidif):
    c, kmz = column_inputs(torch.float64, seed=1)
    rng = np.random.default_rng(2)
    z = torch.as_tensor(15.0 + 5.0 * rng.standard_normal((KM, JMT, IMT)))
    got = port_invtri(z, c, kmz, aidif=aidif)
    ref = whole_value_invtri(z, c, kmz, aidif=aidif)
    assert float((got - ref).abs().max()) <= 1e-13 * float(ref.abs().max())


def unstable_columns(dtype, seed):
    """T and S on (2, KM, JMT, IMT), warm and fresh below cold and salty
    water in places, so that regions of several levels form."""
    rng = np.random.default_rng(seed)
    t = np.empty((2, KM, JMT, IMT))
    t[0] = 20.0 * np.exp(-np.arange(KM) / 6.0)[:, None, None] \
        + 2.0 * rng.standard_normal((KM, JMT, IMT))
    t[1] = (0.2 * rng.standard_normal((KM, JMT, IMT))) / 1000.0
    kmt = rng.integers(1, KM + 1, (JMT, IMT))
    dz = np.linspace(5.0e3, 5.0e4, KM)
    eos = fit_eos(np.cumsum(dz) - 0.5 * dz)
    t[0] += np.asarray(eos.to)[:, None, None] - 10.0
    t[1] += np.asarray(eos.so)[:, None, None]
    return (torch.as_tensor(t, dtype=dtype), torch.as_tensor(kmt),
            *(torch.as_tensor(np.asarray(x), dtype=dtype)
              for x in (eos.c, eos.to, eos.so, dz)))


def region_apply(dtype, seed):
    ts, kmt, c, to, so, dz = unstable_columns(dtype, seed)
    mnorm = region_mixing_matrix(ts, kmt, c, to, so, dz)
    ocean = (torch.arange(KM)[:, None, None] < kmt[None]).to(dtype)
    ocean = torch.broadcast_to(ocean, ts.shape[1:]).contiguous()
    return ts, mnorm, ocean


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_regions_stay_homogeneous_and_fixed(seed):
    ts, mnorm, ocean = region_apply(torch.float32, seed)
    out = apply_region_means_ref(ts, mnorm, ocean)
    top = region_reference(mnorm)
    mixed = (top != torch.arange(KM)[:, None, None]) & (ocean > 0)
    assert int(mixed.sum()) > 0
    at_top = torch.gather(out, 1, top[None].expand(2, -1, -1, -1))
    assert torch.equal(torch.where(ocean[None] > 0, at_top, out), out)
    again = out
    for _ in range(50):
        again = apply_region_means_ref(again, mnorm, ocean)
    assert torch.equal(again, out)

    def whole(x):
        y = mnorm[:, 0][None] * x[:, 0][:, None]
        for q in range(1, KM):
            y = y + mnorm[:, q][None] * x[:, q][:, None]
        return torch.where(ocean[None] > 0, y, x)

    drift = out
    for _ in range(50):
        drift = whole(drift)
    assert not torch.equal(drift, out)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_region_apply_equals_the_mean_in_float64(seed):
    ts, mnorm, ocean = region_apply(torch.float64, seed)
    got = apply_region_means_ref(ts, mnorm, ocean)
    ref = torch.where(ocean[None] > 0,
                      torch.einsum("klji,nlji->nkji", mnorm, ts), ts)
    assert float((got - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
