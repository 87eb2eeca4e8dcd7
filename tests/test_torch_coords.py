"""Port parity: the coordinate engine equals the JAX package's, bit for bit.

Key order, unique and inverse maps, ``stride``, ``stride_region`` and the
kernel maps' ``in_idx`` / ``out_idx_t`` are integer results, so they must be
identical (the JAX side sliced to its valid rows).
"""

import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.coords import keys as jkeys
from minkowskiengine_tpu.kernel_generator import KernelGenerator as JKernelGenerator
from minkowskiengine_tpu_torch.coords import keys as tkeys
from minkowskiengine_tpu_torch.coords.manager import CoordinateManager
from minkowskiengine_tpu_torch.kernel_generator import KernelGenerator
from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels


def _room():
    # 0.2 m voxels of the 2 x 2 x 2.2 m room scan: 1446 voxels
    c, _ = room_scan_voxels(
        voxel_size=0.2, n_points=120_000, extent=(2.0, 2.0, 2.2), n_objects=4, seed=0
    )
    return c


def _random(D, n, lo, hi, batches, seed):
    rng = np.random.RandomState(seed)
    b = rng.randint(0, batches, (n, 1))
    x = rng.randint(lo, hi + 1, (n, D))
    return np.concatenate([b, x], 1).astype(np.int32)  # has duplicates


CLOUDS = {
    "room3d": _room,
    "rand2d": lambda: _random(2, 1500, -30, 30, 3, seed=1),
    "rand4d": lambda: _random(4, 1200, -6, 6, 2, seed=2),
}


def _managers(cloud):
    c = CLOUDS[cloud]()
    D = c.shape[1] - 1
    jm, tm = ME.CoordinateManager(D=D), CoordinateManager(D=D, device="cpu")
    jk, jmaps = jm.insert_and_map(c)
    tk, tmaps = tm.insert_and_map(torch.from_numpy(c))
    return c, (jm, jk, jmaps), (tm, tk, tmaps)


def _same_coords(jm, jk, tm, tk):
    assert jk.get_key() == tk.get_key()
    np.testing.assert_array_equal(np.asarray(jm.get_coordinates(jk)), tm.get_coordinates(tk).numpy())


@pytest.mark.parametrize("D", [1, 2, 3, 4, 5, 6])
def test_key_order_matches_jax_lanes(D):
    """Signed int64 keys sort exactly like the JAX package's unsigned lanes,
    including the extremes of every field's range."""
    rng = np.random.RandomState(D)
    ranges = jkeys.field_ranges(D)
    cols = []
    for lo, hi in ranges:
        v = rng.randint(lo, hi + 1, 600)
        v[:4] = [lo, hi, lo, hi]
        cols.append(v)
    c = np.stack(cols, 1).astype(np.int32)
    c = c[~np.asarray(jkeys.overflow_mask(c))]
    lanes = [np.asarray(l) for l in jkeys.pack(c)]
    j_order = np.lexsort(lanes[::-1])  # lanes are most-significant first
    keys = tkeys.pack(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"), j_order)
    assert len(np.unique(keys)) == len(np.unique(c, axis=0))


@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_insert_and_map_matches_jax(cloud):
    c, (jm, jk, (ju, ji)), (tm, tk, (tu, ti)) = _managers(cloud)
    _same_coords(jm, jk, tm, tk)
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    # the reference contract: coords[unique_map][inverse_map] == coords
    np.testing.assert_array_equal(c[tu.numpy()][ti.numpy()], c)


def test_room_scan_order_is_canonical():
    """``room_scan_voxels`` returns rows in np.unique order; for one batch
    that is already the canonical key order, so inserting it is the
    identity permutation in both packages."""
    c, (jm, jk, (ju, _)), (tm, tk, (tu, _)) = _managers("room3d")
    np.testing.assert_array_equal(tu.numpy(), np.arange(len(c)))
    np.testing.assert_array_equal(np.asarray(ju), np.arange(len(c)))


@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_stride_matches_jax(cloud):
    _, (jm, jk, _), (tm, tk, _) = _managers(cloud)
    for _ in range(4):  # the MinkUNet pyramid: 2, 4, 8, 16
        jk, tk = jm.stride(jk, 2), tm.stride(tk, 2)
        _same_coords(jm, jk, tm, tk)
    assert tm.stride(tk, 1) is tk


@pytest.mark.parametrize("is_transpose,expand", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("cloud", ["room3d", "rand2d"])
def test_stride_region_matches_jax(cloud, is_transpose, expand):
    _, (jm, jk, _), (tm, tk, _) = _managers(cloud)
    D = tm.D
    jk2, tk2 = jm.stride(jk, 2), tm.stride(tk, 2)
    src_j, src_t, out_ts = (jk2, tk2, (1,) * D) if is_transpose else (jk, tk, (2,) * D)
    jr = JKernelGenerator(kernel_size=2, stride=2, dimension=D).get_kernel(
        src_j.get_tensor_stride(), is_transpose
    )
    tr = KernelGenerator(kernel_size=2, stride=2, dimension=D).get_kernel(
        src_t.get_tensor_stride(), is_transpose
    )
    jo = jm.stride_region(src_j, jr, out_ts, expand, is_transpose)
    to = tm.stride_region(src_t, tr, out_ts, expand, is_transpose)
    _same_coords(jm, jo, tm, to)
    if is_transpose and not expand:  # lands back on the encoder's map
        assert to == tk


def _same_kmap(jkm, tkm):
    np.testing.assert_array_equal(np.asarray(jkm.in_idx)[:, : tkm.n_out], tkm.in_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jkm.out_idx_t)[:, : tkm.n_in], tkm.out_idx_t.numpy())
    assert tkm.in_idx.dtype == tkm.out_idx_t.dtype == torch.int32


@pytest.mark.parametrize(
    "cloud,k,s",
    [("room3d", 3, 1), ("room3d", 5, 1), ("room3d", 2, 2),
     ("rand2d", 3, 1), ("rand2d", 2, 2), ("rand4d", 3, 1), ("rand4d", 2, 2)],
)
def test_kernel_map_matches_jax(cloud, k, s):
    _, (jm, jk, _), (tm, tk, _) = _managers(cloud)
    jo, to = jm.stride(jk, s), tm.stride(tk, s)
    jkm = jm.kernel_map(jk, jo, stride=s, kernel_size=k)
    tkm = tm.kernel_map(tk, to, stride=s, kernel_size=k)
    _same_kmap(jkm, tkm)
    assert tm.kernel_map(tk, to, stride=s, kernel_size=k) is tkm  # cached
    # injective per offset, and out_idx_t is its inverse
    i = tkm.in_idx.long()
    for kk in range(tkm.kernel_volume):
        o = torch.nonzero(i[kk] >= 0).flatten()
        assert torch.equal(tkm.out_idx_t[kk, i[kk, o]].long(), o)


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_map_accessors_match_jax(cloud):
    """``CoordinateMap.batch_indices`` and ``to_numpy`` at strides 1 and 2,
    and ``KernelMap.pair_counts`` of the k = 3 and k = 2 s = 2 maps, equal
    the JAX package's."""
    _, (jm, jk, _), (tm, tk, _) = _managers(cloud)
    for s in (1, 2):
        jo, to = jm.stride(jk, s), tm.stride(tk, s)
        jmap, tmap = jm.get_coordinate_map(jo), tm.get_coordinate_map(to)
        np.testing.assert_array_equal(jmap.to_numpy(), tmap.to_numpy())
        assert tmap.to_numpy().shape == (tmap.size, tmap.dimension + 1)
        np.testing.assert_array_equal(
            np.asarray(jmap.batch_indices)[: jmap.size], tmap.batch_indices.numpy())
        for k in (3, 2):
            jkm = jm.kernel_map(jk, jo, stride=s, kernel_size=k)
            tkm = tm.kernel_map(tk, to, stride=s, kernel_size=k)
            np.testing.assert_array_equal(jkm.pair_counts(), tkm.pair_counts())


@pytest.mark.parametrize("cached", [True, False])
def test_minkunet_pyramid_transpose_maps_match_jax(cached):
    """The decoder's k=2 s=2 transposed convs: with the encoder's forward
    maps cached they are those maps swapped; without, they are built
    out→in at the finer stride and swapped.  Both equal JAX's."""
    _, (jm, jk, _), (tm, tk, _) = _managers("room3d")
    jkeys_, tkeys_ = [jk], [tk]
    for _ in range(4):
        jkeys_.append(jm.stride(jkeys_[-1], 2))
        tkeys_.append(tm.stride(tkeys_[-1], 2))
    kw = dict(stride=2, kernel_size=2)
    if cached:
        for lvl in range(4):
            jm.kernel_map(jkeys_[lvl], jkeys_[lvl + 1], **kw)
            tm.kernel_map(tkeys_[lvl], tkeys_[lvl + 1], **kw)
    for lvl in range(4):
        jkm = jm.kernel_map(jkeys_[lvl + 1], jkeys_[lvl], is_transpose=True, **kw)
        tkm = tm.kernel_map(tkeys_[lvl + 1], tkeys_[lvl], is_transpose=True, **kw)
        _same_kmap(jkm, tkm)
        assert tkm.n_out == tm.size(tkeys_[lvl])
        if cached:
            fwd = tm.kernel_map(tkeys_[lvl], tkeys_[lvl + 1], **kw)
            assert tkm.in_idx is fwd.out_idx_t


@pytest.mark.parametrize(
    "row,bad",
    [
        ([0, 32768, 0, 0], True),
        ([0, -32769, 0, 0], True),
        ([65536, 0, 0, 0], True),
        ([65535, 32767, 32767, 32767], True),  # the maximal tuple
        ([65535, 32767, -32768, 32767], False),
    ],
)
def test_overflow_raises_like_jax(row, bad):
    c = np.array([[0, 0, 0, 0], row], np.int32)
    if bad:
        with pytest.raises(ValueError):
            ME.CoordinateManager(D=3).insert_and_map(c)
        with pytest.raises(ValueError):
            CoordinateManager(D=3, device="cpu").insert_and_map(torch.from_numpy(c))
    else:
        _, (ju, _) = ME.CoordinateManager(D=3).insert_and_map(c)
        _, (tu, _) = CoordinateManager(D=3, device="cpu").insert_and_map(torch.from_numpy(c))
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
