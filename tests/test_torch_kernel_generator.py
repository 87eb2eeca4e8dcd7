"""Port parity: kernel offsets and their order equal the JAX package's.

The offset order fixes which weight slice W[k] meets which neighbour, so it
must match exactly (no tolerance).
"""

import numpy as np
import pytest

from minkowskiengine_tpu import kernel_generator as jkg
from minkowskiengine_tpu.coords.manager import region_offsets_for as j_region_offsets_for
from minkowskiengine_tpu_torch import kernel_generator as tkg
from minkowskiengine_tpu_torch.coords.manager import (
    region_offsets_for as t_region_offsets_for,
)
from minkowskiengine_tpu_torch.types import RegionType


@pytest.mark.parametrize("is_transpose", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("D", [2, 3, 4])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_cube_offsets_match_jax(k, D, stride, is_transpose):
    for ts in (stride, 2 * stride, 4 * stride):
        tensor_stride = (ts,) * D
        j = jkg.KernelGenerator(kernel_size=k, stride=stride, dimension=D)
        t = tkg.KernelGenerator(kernel_size=k, stride=stride, dimension=D)
        assert t.kernel_volume == j.kernel_volume == k**D
        jr = j.get_kernel(tensor_stride, is_transpose)
        tr = t.get_kernel(tensor_stride, is_transpose)
        assert tr.offsets.dtype == np.int32
        np.testing.assert_array_equal(tr.offsets, jr.offsets)
        assert int(tr.region_type) == int(jr.region_type)


def test_k4_transposed_region_at_stride_64_matches_jax():
    """CompletionNet's first generative conv: k = 4, stride 2, from tensor
    stride 64; its 64 offsets are 0..3 times the output stride 32, dim 0
    fastest."""
    j = jkg.KernelGenerator(kernel_size=4, stride=2, is_transpose=True, dimension=3)
    t = tkg.KernelGenerator(kernel_size=4, stride=2, is_transpose=True, dimension=3)
    tr, jr = t.get_kernel((64,) * 3, True), j.get_kernel((64,) * 3, True)
    np.testing.assert_array_equal(tr.offsets, jr.offsets)
    assert tr.volume == 64 and tr.offsets[:5, 0].tolist() == [0, 32, 64, 96, 0]
    assert sorted(set(tr.offsets.ravel().tolist())) == [0, 32, 64, 96]


def test_even_kernel_is_one_sided_and_dim0_fastest():
    off = tkg.KernelGenerator(kernel_size=2, dimension=3).get_kernel((1, 1, 1), False).offsets
    assert off[:3].tolist() == [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    assert off.min() == 0 and off.max() == 1


_CUBE, _CROSS = RegionType.HYPER_CUBE, RegionType.HYPER_CROSS


@pytest.mark.parametrize(
    "region_type,axis_types",
    [(_CROSS, None), (_CUBE, (_CUBE, _CROSS, _CUBE))],  # cross; hybrid
)
def test_cross_and_hybrid_offsets_match_jax(region_type, axis_types):
    j = jkg.KernelGenerator(
        kernel_size=3,
        dimension=3,
        region_type=jkg.RegionType(int(region_type)),
        axis_types=None if axis_types is None else [jkg.RegionType(int(a)) for a in axis_types],
    )
    t = tkg.KernelGenerator(
        kernel_size=3, dimension=3, region_type=region_type, axis_types=axis_types
    )
    for ts in ((1, 1, 1), (2, 2, 2)):
        np.testing.assert_array_equal(
            t.get_kernel(ts, False).offsets, j.get_kernel(ts, False).offsets
        )


@pytest.mark.parametrize("k,D", [(2, 3), (3, 2), (5, 3)])
def test_region_offsets_for_scales_by_tensor_stride(k, D):
    for ts in (1, 2, 8):
        args = ((k,) * D, (1,) * D, (ts,) * D, None)
        t = t_region_offsets_for(RegionType.HYPER_CUBE, *args)
        j = j_region_offsets_for(jkg.RegionType.HYPER_CUBE, *args)
        np.testing.assert_array_equal(t, j)
        assert np.all(t % ts == 0)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_kernel_volume_matches_jax(k):
    for rt in (RegionType.HYPER_CUBE, RegionType.HYPER_CROSS):
        if rt == RegionType.HYPER_CROSS and k % 2 == 0:
            continue
        assert tkg.get_kernel_volume(rt, (k,) * 3, None, None, 3) == jkg.get_kernel_volume(
            int(rt), (k,) * 3, None, None, 3
        )
