"""Port parity for the coordinate manager's bookkeeping (``exists``,
``get_keys``, ``get_coordinate_map``, ``has_kernel_map``,
``peek_kernel_map``, ``kernel_map_dict``, ``clear``), the key's coordinate
size, the backend selectors, and the rest of ``types.py`` and
``convert_region_type``.

The same numpy coordinates go into a JAX manager and the port's, through
the same calls in the same order; keys, map ids and the
``{offset: (in_rows, out_rows)}`` pairs must be equal.
"""

import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
import minkowskiengine_tpu_torch as MT

COORDS = np.unique(np.concatenate([
    np.random.RandomState(0).randint(0, 2, (300, 1)),
    np.random.RandomState(1).randint(-6, 6, (300, 3)),
], 1).astype(np.int32), axis=0)


def _managers():
    jm, tm = ME.CoordinateManager(D=3), MT.CoordinateManager(D=3, device="cpu")
    jk, _ = jm.insert_and_map(COORDS)
    tk, _ = tm.insert_and_map(torch.from_numpy(COORDS))
    return jm, jk, tm, tk


def _same_pairs(got, want):
    assert sorted(got) == sorted(int(k) for k in want)
    for k, (i, o) in got.items():
        assert i.dtype == o.dtype == np.int64
        np.testing.assert_array_equal(i, np.asarray(want[k][0]))
        np.testing.assert_array_equal(o, np.asarray(want[k][1]))


@pytest.mark.parametrize("ks,stride,is_pool,is_transpose", [
    (3, 1, False, False), (2, 2, False, False), (3, 2, False, False),
    (2, 2, True, False), (2, 2, False, True), (5, 1, False, False),
], ids=["k3s1", "k2s2", "k3s2", "k2s2-pool", "k2s2-transpose", "k5s1"])
def test_kernel_map_dict_matches_jax(ks, stride, is_pool, is_transpose):
    jm, jk, tm, tk = _managers()
    jo, to = jm.stride(jk, stride), tm.stride(tk, stride)
    assert to.get_key() == jo.get_key()
    args = ((jo, jk) if is_transpose else (jk, jo)), ((to, tk) if is_transpose else (tk, to))
    kw = dict(stride=stride, kernel_size=ks, is_pool=is_pool, is_transpose=is_transpose)
    want = jm.kernel_map_dict(*args[0], **kw)
    got = tm.kernel_map_dict(*args[1], **kw)
    _same_pairs(got, want)
    if is_pool:  # always keyed by offsets: k^D of them
        assert set(got) <= set(range(ks**3))


def test_kernel_map_cache_bookkeeping():
    jm, jk, tm, tk = _managers()
    jo, to = jm.stride(jk, 2), tm.stride(tk, 2)
    kw = dict(stride=2, kernel_size=2)
    assert not tm.has_kernel_map(tk, to, **kw) and tm.peek_kernel_map(tk, to, **kw) is None
    assert jm.has_kernel_map(jk, jo, **kw) == tm.has_kernel_map(tk, to, **kw)
    kmap = tm.kernel_map(tk, to, **kw)
    jm.kernel_map(jk, jo, **kw)
    assert tm.has_kernel_map(tk, to, **kw) and jm.has_kernel_map(jk, jo, **kw)
    assert tm.peek_kernel_map(tk, to, **kw) is kmap
    # another request on the same maps is another cache entry
    assert not tm.has_kernel_map(tk, to, stride=2, kernel_size=3)
    assert not tm.has_kernel_map(tk, to, is_pool=True, **kw)


def test_keys_and_maps_match_jax():
    jm, jk, tm, tk = _managers()
    for s in (2, 4):
        jm.stride(jk, s)
        tm.stride(tk, s)
    jm.origin(jk)
    tm.origin(tk)
    assert tm.get_keys() == jm.get_keys()
    assert tm.exists(tk) and jm.exists(jk)
    for k in (MT.CoordinateMapKey((8, 8, 8), ""), MT.CoordinateMapKey(3)):
        assert not tm.exists(k)
    assert not jm.exists(ME.CoordinateMapKey(3))
    cmap = tm.get_coordinate_map(tk)
    assert isinstance(cmap, MT.CoordinateMap)
    np.testing.assert_array_equal(cmap.coordinates.numpy(), np.asarray(jm.get_coordinates(jk)))
    assert cmap.tensor_stride == (1, 1, 1)


def test_clear_drops_everything():
    _, _, tm, tk = _managers()
    to = tm.stride(tk, 2)
    tm.kernel_map(tk, to, stride=2, kernel_size=2)
    tm.origin_map(tk)
    tm.clear()
    assert tm.get_keys() == [] and not tm.exists(tk)
    assert not tm.has_kernel_map(tk, to, stride=2, kernel_size=2)
    with pytest.raises(KeyError):
        tm.size(tk)
    # the manager is usable again, with the same ids as a fresh one
    k2, _ = tm.insert_and_map(torch.from_numpy(COORDS))
    assert k2.get_key() == tk.get_key()


def test_key_coordinate_size_and_selectors():
    assert MT.CoordinateMapKey(3).get_coordinate_size() == ME.CoordinateMapKey(3).get_coordinate_size() == 4
    assert MT.CoordinateMapKey((2, 2), "x").get_coordinate_size() == 3
    unset = MT.CoordinateMapKey(2)
    unset.set_key((4, 4), "a")
    assert unset.get_coordinate_size() == 3 and unset.get_tensor_stride() == (4, 4)
    for fn in ("set_gpu_allocator", "set_memory_manager_backend"):
        assert getattr(MT, fn)(MT.GPUMemoryAllocatorType.PYTORCH) is None
    assert MT.set_coordinate_map_type(MT.CoordinateMapType.CUDA) is None


@pytest.mark.parametrize("name", [
    "MinkowskiAlgorithm", "GPUMemoryAllocatorType", "CUDAKernelMapMode", "CoordinateMapType",
    "ConvolutionMode", "PoolingMode", "RegionType", "BroadcastMode",
    "SparseTensorOperationMode", "SparseTensorQuantizationMode",
])
def test_enums_match_jax(name):
    assert {m.name: int(m) for m in getattr(MT, name)} == {m.name: int(m) for m in getattr(ME, name)}


def test_int_converters():
    assert MT.convert_to_int_list(2, 3) == ME.convert_to_int_list(2, 3) == [2, 2, 2]
    assert MT.convert_to_int_list((1, 2), 2) == [1, 2]
    t = MT.convert_to_int_tensor((1, 2, 3), 3)
    assert isinstance(t, torch.IntTensor) and t.tolist() == [1, 2, 3]
    np.testing.assert_array_equal(t.numpy(), ME.convert_to_int_tensor((1, 2, 3), 3))
    with pytest.raises(ValueError):
        MT.convert_to_int_list((1, 2), 3)


@pytest.mark.parametrize("spec", [
    dict(region_type=0, kernel_size=3, axis_types=None, region_offset=None),
    dict(region_type=1, kernel_size=5, axis_types=None, region_offset=None),
    dict(region_type=3, kernel_size=3, axis_types=[0, 1, 0], region_offset=None),
    dict(region_type=2, kernel_size=3, axis_types=None,
         region_offset=np.array([[0, 0, 0], [1, 0, 0], [0, -1, 2]], np.int32)),
], ids=["cube", "cross", "hybrid", "custom"])
def test_convert_region_type_matches_jax(spec):
    args = dict(tensor_stride=4, up_stride=2, dilation=1, dimension=3)
    spec = dict(spec)
    if spec["axis_types"] is not None:
        spec_t = dict(spec, axis_types=[MT.RegionType(a) for a in spec["axis_types"]])
        spec_j = dict(spec, axis_types=[ME.RegionType(a) for a in spec["axis_types"]])
    else:
        spec_t = spec_j = spec
    rt, off, vol = MT.convert_region_type(**spec_t, **args)
    jrt, joff, jvol = ME.convert_region_type(**spec_j, **args)
    assert int(rt) == int(jrt) and vol == jvol
    np.testing.assert_array_equal(off, joff)
    if spec["axis_types"] is None:
        assert MT.get_kernel_volume(spec["region_type"], (spec["kernel_size"],) * 3,
                                    spec["region_offset"], None, 3) == vol
