"""Host-side layout of the port's CUDA kernels, on the CPU.

The cluster CG (csrc/congrad.cu) cuts the grid into bands of rows, one
per CTA, with border-source tables and per-band island perimeter lists;
the tracer step (csrc/tracer_step.cu) runs a block per (row, tracer).
These tables and counts are built in Python by the wrappers and tested
here.  A plain-PyTorch emulation of the banded CG, with every reduction
taken band by band and summed in rank order as the kernel does, is held
against ``congrad_ref`` on the flagship grid's operator and islands, and
``congrad_ref`` against the JAX package's ``congrad`` on the same system;
the same on the earth bathymetry (six islands, the coupled
configuration's grid).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvic_tpu.ops.solvers import IslandIndex as JIslandIndex
from uvic_tpu.ops.solvers import congrad as j_congrad

from uvic_tpu_torch.config import ModelConfig, earth_config, small_config
from uvic_tpu_torch.models.ocean.params import build_ocean_params
from uvic_tpu_torch.models.ocean.tropic import sfc5pt_unit, sfforc
from uvic_tpu_torch.ops.cg_kernel import (SMEM_LIMIT, border_source,
                                          cg_layout, congrad_ref)
from uvic_tpu_torch.ops.solvers import IslandIndex, border, make_inv
from uvic_tpu_torch.ops.tracer_kernel import tracer_launch
from uvic_tpu_torch.ops.tracer_kernel import SMEM_LIMIT as TRACER_SMEM_LIMIT

H100_SMS = 132


def _system(cfg, topo_kind="world"):
    """(params, cf_unit, IslandIndex, forcing) of a configuration's grid:
    the 5-point operator at unit timestep and the curl of the entry
    point's sin(3 lat) wind stress over the depth, as tropic_step forms
    it, without stepping the model."""
    p = build_ocean_params(cfg, topo_kind=topo_kind)
    g, topo = p.grid, p.topo
    cf, _ = sfc5pt_unit(np.asarray(g.dxu), np.asarray(g.dyu),
                        np.asarray(g.csu), np.asarray(topo.hr))
    isl = IslandIndex(perim_id=torch.as_tensor(topo.perim_id,
                                               dtype=torch.int64),
                      nisle=topo.nisle,
                      counts=torch.as_tensor(topo.perim_count,
                                             dtype=torch.float64),
                      imain=topo.imain,
                      ocean_mask=torch.as_tensor(
                          (topo.land_map <= 0).astype(np.float64)))
    taux = np.sin(np.deg2rad(np.asarray(g.yu) * 3))[:, None] / 1.035
    zu = np.stack([taux * topo.hr, np.zeros_like(topo.hr)])
    forc = sfforc(*(torch.as_tensor(np.asarray(x, dtype=np.float64))
                    for x in (zu, g.dxu, g.dyu, g.csu)))
    return p, torch.as_tensor(cf), isl, forc


@pytest.fixture(scope="module")
def flagship():
    return _system(ModelConfig())


@pytest.fixture(scope="module")
def earth():
    return _system(earth_config(dtype="float64"), "earth")


@pytest.fixture(scope="module")
def small():
    return _system(small_config(imt=40, jmt=34, km=8))


@pytest.mark.parametrize("case", ["flagship-8", "flagship-16", "small-8",
                                  "small-3"])
def test_cg_bands_cover_every_row_once(case, flagship, small):
    name, cluster = case.split("-")
    p = (flagship if name == "flagship" else small)[0]
    jmt = p.grid.jmt
    lay = cg_layout(p.topo.perim_id, p.topo.nisle, True, int(cluster))
    bands = lay.bands
    assert bands[0] == 0 and bands[-1] == jmt and len(bands) == int(cluster) + 1
    rows = np.concatenate([np.arange(bands[r], bands[r + 1])
                           for r in range(lay.cluster)])
    np.testing.assert_array_equal(rows, np.arange(jmt))
    assert np.diff(bands).min() >= 1
    assert lay.rmax == np.diff(bands).max()


@pytest.mark.parametrize("name", ["flagship", "small"])
def test_cg_perimeter_lists_partition_each_island(name, flagship, small):
    p = (flagship if name == "flagship" else small)[0]
    pid, nisle = p.topo.perim_id, p.topo.nisle
    imt = p.grid.imt
    lay = cg_layout(pid, nisle, True)
    assert lay.poff[0] == 0 and lay.poff[-1] == lay.plist.size
    flat = pid.reshape(-1)
    for q in range(nisle):
        segs = []
        for r in range(lay.cluster):
            seg = lay.plist[lay.poff[r * nisle + q]:lay.poff[r * nisle + q + 1]]
            rows = seg // imt
            assert ((rows >= lay.bands[r]) & (rows < lay.bands[r + 1])).all()
            assert (flat[seg] == q).all()
            segs.append(seg)
        cells = np.concatenate(segs)
        np.testing.assert_array_equal(np.sort(cells),
                                      np.flatnonzero(flat == q))
    per_band = [lay.poff[(r + 1) * nisle] - lay.poff[r * nisle]
                for r in range(lay.cluster)]
    assert lay.npmax == max(per_band)


@pytest.mark.parametrize("cyclic", [True, False])
def test_border_source_table_is_the_border_operation(cyclic):
    jmt, imt = 9, 11
    v = torch.as_tensor(np.random.default_rng(3).standard_normal((jmt, imt)))
    src = torch.as_tensor(border_source(jmt, imt, cyclic), dtype=torch.int64)
    got = torch.where(src >= 0, v.reshape(-1)[src.clamp(min=0)],
                      torch.zeros_like(v))
    torch.testing.assert_close(got, border(v, cyclic), rtol=0, atol=0)
    interior = torch.zeros(jmt, imt, dtype=torch.bool)
    interior[1:-1, 1:-1] = True
    own = src == torch.arange(jmt * imt).reshape(jmt, imt)
    assert torch.equal(own, interior)


def test_flagship_shared_memory_and_grid_fit_the_card(flagship):
    p = flagship[0]
    g, topo = p.grid, p.topo
    for cluster in (8, 16):
        lay = cg_layout(topo.perim_id, topo.nisle, True, cluster)
        assert lay.smem_bytes <= SMEM_LIMIT
    lay8 = cg_layout(topo.perim_id, topo.nisle, True, 8)
    # 18 band planes, the halo rows of two s planes, the perimeter list
    assert lay8.smem_bytes == 4 * (18 * 13 * 102 + 4 * 102 + lay8.npmax)
    blocks, threads, smem = tracer_launch(2, g.km, g.jmt, g.imt)
    assert blocks >= H100_SMS
    assert threads <= 256 and threads % 32 == 0
    assert smem <= TRACER_SMEM_LIMIT
    # two blocks per SM fit in the SM's 228 KB: the dynamic window, the
    # level factors (6 x 64 floats, static) and 1 KB reserved per block
    assert 2 * (smem + 6 * 64 * 4 + 1024) <= 228 * 1024


def congrad_banded(cf_unit, isl, layout, guess, forc, c2dtsf, tol,
                   max_iter):
    """The cluster kernel's sequence of operations in plain PyTorch: the
    Pallas kernel's algorithm (the iterate starting from border(guess)
    undeflated, as ops/solvers.congrad), every reduction taken band by
    band and
    the band partials summed in rank order, the deflation dot product of
    the iterate taken with the residual's island sums.  Returns
    (dpsi, iters)."""
    jmt, imt = guess.shape
    dt = guess.dtype
    bands = [int(b) for b in layout.bands]
    src = torch.as_tensor(layout.src, dtype=torch.int64).reshape(-1)
    interior = (src == torch.arange(jmt * imt)).reshape(jmt, imt).to(dt)
    nisle = isl.nisle
    pid = isl.perim_id
    rcount = (1.0 / torch.clamp(isl.counts, min=1.0)).to(dt)

    def bord(x):
        flat = x.reshape(-1)
        return torch.where(src >= 0, flat[src.clamp(min=0)],
                           torch.zeros_like(flat)).reshape(jmt, imt)

    def bsum(x):
        parts = [torch.sum(x[bands[r]:bands[r + 1]])
                 for r in range(len(bands) - 1)]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    def bmax(x):
        return max(float(torch.max(x[bands[r]:bands[r + 1]]))
                   for r in range(len(bands) - 1))

    def island_sums(x):
        flat = x.reshape(-1)
        out = []
        for q in range(nisle):
            total = None
            for r in range(len(bands) - 1):
                lo = layout.poff[r * nisle + q]
                hi = layout.poff[r * nisle + q + 1]
                part = torch.sum(flat[torch.as_tensor(layout.plist[lo:hi],
                                                      dtype=torch.int64)])
                total = part if total is None else total + part
            out.append(total)
        return torch.stack(out) if out else torch.zeros(1, dtype=dt)

    def dist(x, sums):
        rep = sums[pid.clamp(0, max(nisle - 1, 0))]
        return torch.where(pid >= 0, rep, x)

    def op(x):
        acc = torch.zeros_like(x)
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                acc = acc + cf_unit[dj + 1, di + 1] * torch.roll(
                    x, (-dj, -di), dims=(0, 1))
        return acc * (1.0 / c2dtsf) * interior

    zpre = make_inv(cf_unit, isl)
    zl = zpre * c2dtsf
    w = bord((zpre != 0).to(dt))
    ww = bsum(w * w * interior)
    dpsi = bord(guess)
    res = bord(forc * interior - op(dpsi))
    dr = bsum(res * w * interior) / ww
    dpw = bsum(dpsi * w * interior)
    res = res - dr * w
    s = torch.zeros_like(res)

    def precondition(res):
        x2 = bord(dist(zl * res, island_sums(zl * res)))
        return x2, bsum(x2 * w * interior) / ww, bmax(torch.abs(x2))

    x2, dz, mx = precondition(res)
    done = 100.0 * mx < tol
    k, betakm1, step1 = 0, 1.0, 0.0
    while k < max_iter and not done:
        zres = x2 - dz * w
        betak = float(bsum(zres * res * interior))
        s = zres + (betak / (betakm1 if abs(betakm1) > 0 else 1.0)) * s
        As = bord(op(s))
        s_as = float(bsum(s * As * interior))
        smax = bmax(torch.abs(s))
        safe = abs(s_as) > abs(betak) * 1e-10
        alpha = betak / s_as if safe else 0.0
        k += 1
        step = abs(alpha) * smax
        if k == 1:
            step1 = step
            done = step < tol
        elif step < tol:
            rate = np.exp(np.log(max(step / step1, 1e-30)) / (k - 1))
            done = step * rate / (1.0 - rate) < tol
        done = done or not safe
        betakm1 = betak
        dpsi = dpsi + alpha * s
        res = res - alpha * As
        dpw = bsum(dpsi * w * interior)
        sums = island_sums(res)
        if done:
            break
        r2 = bord(dist(res, sums * rcount))
        res = r2 - (bsum(r2 * w * interior) / ww) * w
        if k < max_iter:
            x2, dz, mx = precondition(res)
    return dpsi - (dpw / ww) * w, k


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("guess", ["zero", "warm"])
def test_banded_cg_emulation_matches_congrad_ref(dtype, guess, flagship):
    p, cf, isl, forc = flagship
    cfg = p.cfg.ocean
    c2dtsf, tol, mxscan = 2.0 * cfg.dtsf, cfg.tolrsf, cfg.mxscan
    ref64, _ = congrad_ref(cf, isl, torch.zeros_like(forc), forc, c2dtsf,
                           1e-3 * tol, mxscan, True)
    g0 = torch.zeros_like(forc) if guess == "zero" else 0.9 * ref64
    dt = getattr(torch, dtype)
    cf_t, forc_t, g_t = cf.to(dt), forc.to(dt), g0.to(dt)
    isl_t = IslandIndex(isl.perim_id, isl.nisle, isl.counts.to(dt),
                        isl.imain, isl.ocean_mask.to(dt))
    lay = cg_layout(isl.perim_id.numpy(), isl.nisle, True)
    ref, it_ref = congrad_ref(cf_t, isl_t, g_t, forc_t, c2dtsf, tol, mxscan,
                              True)
    got, it_got = congrad_banded(cf_t, isl_t, lay, g_t, forc_t, c2dtsf, tol,
                                 mxscan)
    it_ref = int(it_ref)
    assert 1 <= it_ref < mxscan
    assert bool(torch.isfinite(got).all())
    err = float(torch.max(torch.abs(got.double() - ref.double())))
    if dtype == "float64":
        assert it_got == it_ref
        assert err <= 1e-9 * float(torch.max(torch.abs(ref)))
    else:
        assert abs(it_got - it_ref) <= max(3, 0.1 * it_ref)
        assert err <= 10.0 * tol


@pytest.mark.parametrize("guess", ["zero", "warm"])
def test_congrad_ref_matches_jax_congrad_on_flagship_grid(guess, flagship):
    p, cf, isl, forc = flagship
    cfg = p.cfg.ocean
    c2dtsf, tol, mxscan = 2.0 * cfg.dtsf, cfg.tolrsf, cfg.mxscan
    g0 = torch.zeros_like(forc)
    if guess == "warm":
        pilot, _ = congrad_ref(cf, isl, g0, forc, c2dtsf, 1e-3 * tol, mxscan,
                               True)
        g0 = 0.9 * pilot
    ref, it_ref = congrad_ref(cf, isl, g0, forc, c2dtsf, tol, mxscan, True)
    jisl = JIslandIndex(perim_id=jnp.asarray(isl.perim_id.numpy()),
                        nisle=isl.nisle, counts=jnp.asarray(isl.counts.numpy()),
                        imain=isl.imain,
                        ocean_mask=jnp.asarray(isl.ocean_mask.numpy()))
    jd, jk, _, _ = j_congrad(jnp.asarray(cf.numpy()) / c2dtsf,
                             jnp.asarray(g0.numpy()),
                             jnp.asarray(forc.numpy()), jisl, tol, mxscan,
                             True)
    assert int(jk) == int(it_ref)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-9 * float(np.abs(np.asarray(jd)).max()))


@pytest.mark.parametrize("cluster", [8, 16])
def test_earth_cg_layout(cluster, earth):
    """Bands cover each row once, the per-band perimeter lists partition
    each of the earth's six islands, and a CTA's shared memory fits."""
    p = earth[0]
    pid, nisle, imt = p.topo.perim_id, p.topo.nisle, p.grid.imt
    assert nisle == 6
    lay = cg_layout(pid, nisle, True, cluster)
    rows = np.concatenate([np.arange(lay.bands[r], lay.bands[r + 1])
                           for r in range(lay.cluster)])
    np.testing.assert_array_equal(rows, np.arange(p.grid.jmt))
    flat = pid.reshape(-1)
    for q in range(nisle):
        segs = []
        for r in range(lay.cluster):
            seg = lay.plist[lay.poff[r * nisle + q]:lay.poff[r * nisle + q + 1]]
            rws = seg // imt
            assert ((rws >= lay.bands[r]) & (rws < lay.bands[r + 1])).all()
            assert (flat[seg] == q).all()
            segs.append(seg)
        np.testing.assert_array_equal(np.sort(np.concatenate(segs)),
                                      np.flatnonzero(flat == q))
    assert lay.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("guess", ["zero", "warm"])
def test_banded_cg_emulation_matches_congrad_ref_on_earth(dtype, guess,
                                                          earth):
    test_banded_cg_emulation_matches_congrad_ref(dtype, guess, earth)


@pytest.mark.parametrize("guess", ["zero", "warm"])
def test_congrad_ref_matches_jax_congrad_on_earth_grid(guess, earth):
    test_congrad_ref_matches_jax_congrad_on_flagship_grid(guess, earth)
