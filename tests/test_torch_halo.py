"""The port's halo machinery and rank launcher against ``uvic_tpu.parallel``.

``extend_x``/``extend_y``/``extend_yx`` and ``ExtendedStatics`` (the
host-extended statics and each rank's padded view) are held bitwise
against the JAX package's on the same seeded arrays.  ``exchange_pad``
and ``pack_exchange`` run on 8 gloo CPU ranks (``launch.spawn``), on
meshes of several shapes over the same ranks, and each rank's padded
block is held bitwise against ``jax.lax.ppermute`` inside
``shard_map`` on the 8-device virtual mesh of ``tests/conftest.py``.
``shard_pytree``/``gather_pytree`` round-trip a padded window bitwise.
A rank that raises makes ``spawn`` raise, a rank that hangs makes it
time out.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from uvic_tpu.parallel import halo as jhalo
from uvic_tpu.parallel.mesh import make_mesh as j_make_mesh

from uvic_tpu_torch.parallel import halo as thalo
from uvic_tpu_torch.parallel.launch import RankFailed, spawn
from uvic_tpu_torch.parallel.mesh import RankMesh, make_mesh

import torch_rank_fns

SEED = 14
# (mesh shape, halo, trailing ghost/image columns, lead dims, ly, lx):
# middle ranks on the y line (4, 2), an x ring of one rank (8, 1)
EXCHANGES = [((2, 4), 3, 2, (2, 3), 6, 7),
             ((1, 8), 2, 2, (3,), 5, 6),
             ((4, 2), 2, 4, (2,), 4, 9),
             ((8, 1), 3, 2, (1,), 4, 11)]
PACK = ((2, 4), 2, 3, [(2, 3), (), (4,)], 5, 8)
JMT, IMT = 13, 22          # a window that (2, 4) pads to 14 x 24


def _rng():
    return np.random.default_rng(SEED)


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("n_out", [None, 3])
def test_extend_matches_jax(w, n_out):
    rng = _rng()
    a = rng.standard_normal((3, 9, 12))
    nx = None if n_out is None else a.shape[-1] + n_out
    ny = None if n_out is None else a.shape[-2] + n_out
    np.testing.assert_array_equal(thalo.extend_x(a, w, n_out=nx),
                                  jhalo.extend_x(a, w, n_out=nx))
    for fill in ("clamp", "zero"):
        np.testing.assert_array_equal(
            thalo.extend_y(a, w, axis=-2, fill=fill, n_out=ny),
            jhalo.extend_y(a, w, axis=-2, fill=fill, n_out=ny))
        np.testing.assert_array_equal(
            thalo.extend_yx(a, w, fill=fill, jmt_p=ny, imt_p=nx),
            jhalo.extend_yx(a, w, fill=fill, jmt_p=ny, imt_p=nx))


def test_bag_axes_are_the_reference_table():
    assert thalo.BAG_AXES == jhalo.BAG_AXES


@pytest.mark.parametrize("shape,w,jmt_p,imt_p", [((2, 4), 3, 14, 24),
                                                 ((1, 8), 2, 13, 24),
                                                 ((2, 2), 4, 14, 22)])
def test_extended_statics_match_jax(shape, w, jmt_p, imt_p):
    """Every kind of constant (x, y, yx with either fill, replicated
    1-D, scalar, absent), every rank's padded view, bitwise."""
    rng = _rng()
    arrays = {"dxt": rng.standard_normal(IMT),
              "cst": rng.standard_normal(JMT),
              "hr": rng.standard_normal((JMT, IMT)),
              "tmask": (rng.random((3, JMT, IMT)) > 0.3) * 1.0,
              "kmt": rng.integers(0, 4, (JMT, IMT)).astype(np.int32),
              "dzt": rng.standard_normal(3), "ah": 2.5, "gone": None}
    axes = {"dxt": "x", "cst": "y", "hr": "yx", "tmask": "yx",
            "kmt": "yx", "dzt": "k", "ah": "scalar", "gone": "skip"}
    fills = {"tmask": "zero", "kmt": "zero"}
    ny, nx = shape
    js = jhalo.ExtendedStatics(arrays, axes, JMT, IMT, ny, nx, w, fills,
                               jmt_p=jmt_p, imt_p=imt_p)
    ts = thalo.ExtendedStatics(
        {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
         for k, v in arrays.items()},
        axes, JMT, IMT, ny, nx, w, fills, jmt_p=jmt_p, imt_p=imt_p)
    for iy in range(ny):
        for ix in range(nx):
            for name in arrays:
                got, ref = ts.local(name, iy, ix), js.local(name, iy, ix)
                if name in ("ah", "gone"):
                    assert got == ref
                    continue
                got = got.cpu().numpy()
                assert got.dtype == np.asarray(ref).dtype, name
                np.testing.assert_array_equal(got, np.asarray(ref),
                                              err_msg=name)


def _jax_padded(fn, shape, *arrays):
    """``fn`` on every shard of the 8-device virtual mesh (``shard_map``
    over the trailing two axes): the global array of padded blocks."""
    mesh = j_make_mesh(shape)
    spec = P(*([None] * (arrays[0].ndim - 2)), "y", "x")
    specs = tuple(P(*([None] * (a.ndim - 2)), "y", "x") for a in arrays)
    out = jax.shard_map(fn, mesh=mesh, in_specs=specs,
                        out_specs=spec if len(arrays) == 1 else specs,
                        check_vma=False)(*map(jnp.asarray, arrays))
    return out


def _blocks(a, shape):
    """The (ny, nx) blocks of a global array, in rank order."""
    ny, nx = shape
    ly, lx = a.shape[-2] // ny, a.shape[-1] // nx
    return [a[..., iy * ly:(iy + 1) * ly, ix * lx:(ix + 1) * lx]
            for iy in range(ny) for ix in range(nx)]


@pytest.fixture(scope="module")
def halo_runs():
    """One spawn of 8 gloo CPU ranks for every exchange, the pack, the
    round trip and the refused mesh; the JAX counterparts."""
    rng = _rng()
    exchanges, ref_exchanges = [], []
    for shape, w, gx, lead, ly, lx in EXCHANGES:
        a = rng.standard_normal(lead + (shape[0] * ly, shape[1] * lx))
        exchanges.append((shape, w, gx, a))
        fn = partial(jhalo.exchange_pad, w=w, yname="y", xname="x",
                     ny=shape[0], nx=shape[1], gx=gx)
        ref_exchanges.append(np.asarray(_jax_padded(fn, shape, a)))
    shape, w, gx, leads, ly, lx = PACK
    arrays = [rng.standard_normal(lead + (shape[0] * ly, shape[1] * lx))
              for lead in leads]

    def jpack(*fs):
        return tuple(jhalo.pack_exchange(list(fs), w, "y", "x", shape[0],
                                         shape[1], gx=gx))
    ref_pack = [np.asarray(r) for r in _jax_padded(jpack, shape, *arrays)]
    fields = {"t": rng.standard_normal((2, 3, JMT, IMT)),
              "smf": rng.standard_normal((2, JMT, IMT)),
              "psi0": rng.standard_normal((JMT, IMT)),
              "relyr": np.float64(0.25)}
    res = spawn(torch_rank_fns.halo_rounds, (2, 4), "gloo", "cpu", 120.0,
                exchanges, [(shape, w, gx, arrays)], fields, JMT, IMT,
                (2, 2))
    return dict(res=res, ref_exchanges=ref_exchanges, ref_pack=ref_pack,
                fields=fields)


@pytest.mark.parametrize("case", range(len(EXCHANGES)))
def test_exchange_pad_matches_ppermute(halo_runs, case):
    shape = EXCHANGES[case][0]
    ref = _blocks(halo_runs["ref_exchanges"][case], shape)
    for rank, r in enumerate(halo_runs["res"]):
        np.testing.assert_array_equal(r["exchange"][case], ref[rank],
                                      err_msg=f"rank {rank}")


def test_pack_exchange_matches_jax(halo_runs):
    refs = [_blocks(a, PACK[0]) for a in halo_runs["ref_pack"]]
    for rank, r in enumerate(halo_runs["res"]):
        for got, ref in zip(r["pack"][0], refs):
            np.testing.assert_array_equal(got, ref[rank])


def test_shard_and_gather_round_trip(halo_runs):
    """Blocks of the padded window (periodic images, zero rows beyond
    the wall), the replicated and 0-D fields as they were, and the
    gathered fields bitwise the global ones, on every rank; with a root
    on rank 0 only."""
    fields = halo_runs["fields"]
    for rank, r in enumerate(halo_runs["res"]):
        iy, ix = divmod(rank, 4)
        for name in ("t", "smf"):
            images = [((g - 1) % (IMT - 2)) + 1 for g in (IMT, IMT + 1)]
            window = np.concatenate([fields[name], fields[name][..., images]],
                                    axis=-1)
            window = np.concatenate(
                [window, np.zeros_like(window[..., :1, :])], axis=-2)
            np.testing.assert_array_equal(
                r["blocks"][name],
                window[..., iy * 7:(iy + 1) * 7, ix * 6:(ix + 1) * 6])
        np.testing.assert_array_equal(r["blocks"]["psi0"], fields["psi0"])
        assert r["blocks"]["relyr"] == fields["relyr"]
        for name, a in fields.items():
            np.testing.assert_array_equal(r["gathered"][name], a)
        assert r["root_only"] == (sorted(fields) if rank == 0 else None)
        assert r["transport"] == "gloo, cpu tensors"


def test_make_mesh_refuses_another_world_size(halo_runs):
    for r in halo_runs["res"]:
        assert r["bad_mesh"] == ("mesh (2, 2) needs 4 ranks, the process "
                                 "group has 8")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((2, 1), device="cpu")
    m = make_mesh((1, 1), device="cpu")
    assert (m.iy, m.ix, m.transport) == (0, 0, "local (one rank)")


def test_local_exchange_on_one_rank():
    """A (1, 1) mesh: the x ring wraps the block, the y line gets zeros
    (no process group), as ppermute on one device."""
    a = _rng().standard_normal((2, 6, 9))
    got = thalo.exchange_pad(torch.as_tensor(a), 2, RankMesh((1, 1),
                                                          device="cpu"), 3)
    fn = partial(jhalo.exchange_pad, w=2, yname="y", xname="x", ny=1,
                 nx=1, gx=3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_jax_padded(fn, (1, 1), a)))


def test_window_pad_and_crop_match_jax():
    a = _rng().standard_normal((2, JMT, IMT))
    got = thalo.pad_window(torch.as_tensor(a), 16, 25).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jhalo.pad_window(jnp.asarray(a), 16, 25)))
    np.testing.assert_array_equal(
        thalo.crop_window(torch.as_tensor(got), JMT, IMT).numpy(), a)
    np.testing.assert_array_equal(
        thalo.pad_zeros(torch.as_tensor(a), 3).numpy(),
        np.asarray(jhalo.pad_zeros(jnp.asarray(a), 3)))
    np.testing.assert_array_equal(
        thalo.crop(torch.as_tensor(a), 2).numpy(),
        np.asarray(jhalo.crop(jnp.asarray(a), 2)))


def test_spawn_raises_when_a_rank_raises():
    with pytest.raises(RankFailed, match="rank 1 raises on purpose"):
        spawn(torch_rank_fns.raise_on, (1, 2), "gloo", "cpu", 60.0, 1)


def test_spawn_times_out_when_a_rank_hangs():
    """The hung rank is named (on a loaded host the other may still be
    starting when the time is up)."""
    with pytest.raises(TimeoutError,
                       match=r"ranks \[(0, )?1\] still running after 10 s"):
        spawn(torch_rank_fns.hang_on, (1, 2), "gloo", "cpu", 10.0, 1)


def test_rank_mesh_neighbours():
    ring = [RankMesh((2, 4), rank=r, device="cpu") for r in range(8)]
    assert [m.x_neighbours() for m in ring[:4]] == [(1, 3), (2, 0), (3, 1),
                                                    (0, 2)]
    assert [m.y_neighbours() for m in (ring[0], ring[5])] == [(4, None),
                                                              (None, 1)]
