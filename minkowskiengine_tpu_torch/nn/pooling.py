"""Pooling modules: local, transposed (unpooling) and global.

Counterpart of ``minkowskiengine_tpu/nn/pooling.py`` (reference:
MinkowskiEngine/MinkowskiPooling.py:113-780).  Every reduction is a gather
over a kernel map or a segment reduction (``ops/functional.py``), which
autograd differentiates; max pooling routes its gradient to the first
maximum.  Pooling with stride == kernel size takes the manager's
stride-map fast path, whose kernel-map rows are collision slots.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from ..kernel_generator import KernelGenerator
from ..ops import functional as F
from ..sparse_tensor import SparseTensor, whole_rows
from ..types import PoolingMode, RegionType
from ..utils import profiling as P
from .conv import _conv_out_key, _expected_out_ts, _resolve_out_key

_LOCAL = {
    PoolingMode.LOCAL_AVG_POOLING: lambda f, idx: F.local_pool_avg(f, idx)[0],
    PoolingMode.LOCAL_SUM_POOLING: lambda f, idx: F.local_pool_sum(f, idx)[0],
    PoolingMode.LOCAL_MAX_POOLING: F.local_pool_max,
}


class MinkowskiPoolingBase(nn.Module):
    def __init__(
        self,
        kernel_size,
        stride=1,
        dilation=1,
        kernel_generator: Optional[KernelGenerator] = None,
        is_transpose: bool = False,
        pooling_mode: PoolingMode = PoolingMode.LOCAL_AVG_POOLING,
        dimension: int = -1,
        expand_coordinates: bool = False,
    ):
        super().__init__()
        if dimension is None or dimension <= 0:
            raise ValueError(f"Invalid dimension {dimension}")
        if pooling_mode not in _LOCAL:
            raise ValueError(f"Invalid pooling mode {pooling_mode!r} for local pooling")
        if kernel_generator is None:
            kernel_generator = KernelGenerator(
                kernel_size=kernel_size,
                stride=stride,
                dilation=dilation,
                is_transpose=is_transpose,
                expand_coordinates=expand_coordinates,
                dimension=dimension,
            )
        self.is_transpose = bool(is_transpose)
        self.kernel_generator = kernel_generator
        self.pooling_mode = pooling_mode
        self.dimension = int(dimension)
        self.expand_coordinates = bool(expand_coordinates)

    def _out_key_and_kmap(self, input: SparseTensor, coordinates):
        whole_rows(input, "pooling")
        kg = self.kernel_generator
        in_key = input.coordinate_map_key
        out_key = _resolve_out_key(
            input, coordinates, _expected_out_ts(in_key, kg, self.is_transpose)
        )
        if out_key is None:
            out_key = _conv_out_key(
                input.coordinate_manager, in_key, kg, self.is_transpose, self.expand_coordinates
            )
        region = kg.get_kernel(in_key.get_tensor_stride(), self.is_transpose)
        custom = region.offsets if region.region_type == RegionType.CUSTOM else None
        kmap = input.coordinate_manager.kernel_map(
            in_key,
            out_key,
            stride=kg.kernel_stride,
            kernel_size=kg.kernel_size,
            dilation=kg.kernel_dilation,
            region_type=region.region_type,
            region_offsets=custom,
            is_transpose=self.is_transpose,
            is_pool=True,
        )
        return out_key, kmap

    def forward(self, input: SparseTensor, coordinates=None) -> SparseTensor:
        with P.span("nn.pool"):
            out_key, kmap = self._out_key_and_kmap(input, coordinates)
            outfeat = _LOCAL[self.pooling_mode](input.F, kmap.in_idx)
            return SparseTensor(
                outfeat, coordinate_map_key=out_key, coordinate_manager=input.coordinate_manager
            )

    def extra_repr(self):
        kg = self.kernel_generator
        return (
            f"kernel_size={kg.kernel_size}, stride={kg.kernel_stride}, "
            f"dilation={kg.kernel_dilation}"
        )


class MinkowskiAvgPooling(MinkowskiPoolingBase):
    """Average over each kernel neighbourhood (reference:
    MinkowskiPooling.py:195-283)."""

    def __init__(self, kernel_size=-1, stride=1, dilation=1, kernel_generator=None, dimension=None):
        super().__init__(
            kernel_size, stride, dilation, kernel_generator,
            pooling_mode=PoolingMode.LOCAL_AVG_POOLING, dimension=dimension,
        )


class MinkowskiSumPooling(MinkowskiPoolingBase):
    """Sum pooling (reference: MinkowskiPooling.py:284-368)."""

    def __init__(self, kernel_size, stride=1, dilation=1, kernel_generator=None, dimension=None):
        super().__init__(
            kernel_size, stride, dilation, kernel_generator,
            pooling_mode=PoolingMode.LOCAL_SUM_POOLING, dimension=dimension,
        )


class MinkowskiMaxPooling(MinkowskiPoolingBase):
    """Max pooling (reference: MinkowskiPooling.py:369-440)."""

    def __init__(self, kernel_size, stride=1, dilation=1, kernel_generator=None, dimension=None):
        super().__init__(
            kernel_size, stride, dilation, kernel_generator,
            pooling_mode=PoolingMode.LOCAL_MAX_POOLING, dimension=dimension,
        )


class MinkowskiPoolingTranspose(MinkowskiPoolingBase):
    """Unpooling: each upsampled row averages the coarse rows that reach it
    (reference: MinkowskiPooling.py:441-581)."""

    def __init__(
        self, kernel_size, stride, dilation=1, kernel_generator=None,
        expand_coordinates=False, dimension=None,
    ):
        super().__init__(
            kernel_size, stride, dilation, kernel_generator, is_transpose=True,
            pooling_mode=PoolingMode.LOCAL_AVG_POOLING, dimension=dimension,
            expand_coordinates=expand_coordinates,
        )


_GLOBAL = {
    PoolingMode.GLOBAL_SUM_POOLING_DEFAULT: "sum",
    PoolingMode.GLOBAL_AVG_POOLING_DEFAULT: "avg",
    PoolingMode.GLOBAL_MAX_POOLING_DEFAULT: "max",
    PoolingMode.GLOBAL_SUM_POOLING_KERNEL: "sum",
    PoolingMode.GLOBAL_AVG_POOLING_KERNEL: "avg",
    PoolingMode.GLOBAL_MAX_POOLING_KERNEL: "max",
    PoolingMode.GLOBAL_SUM_POOLING_PYTORCH_INDEX: "sum",
    PoolingMode.GLOBAL_AVG_POOLING_PYTORCH_INDEX: "avg",
    PoolingMode.GLOBAL_MAX_POOLING_PYTORCH_INDEX: "max",
}


def _origin(input):
    """(origin key, origin row of each row) of a SparseTensor or TensorField."""
    whole_rows(input, "global pooling")
    manager = input.coordinate_manager
    if isinstance(input, SparseTensor):
        return manager.origin_map(input.coordinate_map_key)
    return manager.origin_field_map(input.coordinate_field_map_key)


class MinkowskiGlobalPooling(nn.Module):
    """Pool the rows of each batch item into one row at its origin
    (reference: MinkowskiPooling.py:632-681).  Takes a SparseTensor or,
    as the reference allows, a TensorField."""

    def __init__(self, mode: PoolingMode = PoolingMode.GLOBAL_AVG_POOLING_PYTORCH_INDEX):
        super().__init__()
        if mode not in _GLOBAL:
            raise ValueError(f"Mode must be a global PoolingMode, got {mode!r}")
        self.pooling_mode = mode

    def forward(self, input, coordinates=None) -> SparseTensor:
        with P.span("nn.pool"):
            origin_key, origin_rows = _origin(input)
            num = input.coordinate_manager.size(origin_key)
            pooled, _ = F.global_pool(input.F, origin_rows, num, _GLOBAL[self.pooling_mode])
            return SparseTensor(
                pooled, coordinate_map_key=origin_key, coordinate_manager=input.coordinate_manager
            )

    def extra_repr(self):
        return f"mode={self.pooling_mode!s}"


class MinkowskiGlobalSumPooling(MinkowskiGlobalPooling):
    def __init__(self, mode=PoolingMode.GLOBAL_SUM_POOLING_PYTORCH_INDEX):
        super().__init__(mode=mode)


class MinkowskiGlobalAvgPooling(MinkowskiGlobalPooling):
    def __init__(self, mode=PoolingMode.GLOBAL_AVG_POOLING_PYTORCH_INDEX):
        super().__init__(mode=mode)


class MinkowskiGlobalMaxPooling(MinkowskiGlobalPooling):
    def __init__(self, mode=PoolingMode.GLOBAL_MAX_POOLING_PYTORCH_INDEX):
        super().__init__(mode=mode)


def direct_max_pool(in_map, out_map, in_feat, out_nrows: int, is_sorted=False):
    """Max pooling over supplied pairs: ``in_feat[in_map[i]]`` contributes to
    output row ``out_map[i]`` (reference: src/direct_max_pool.cpp:77-196)."""
    in_map = in_map.to(in_feat.device)
    gathered = F.take_rows(in_feat, in_map)
    ids = out_map.to(in_feat.device).masked_fill(in_map < 0, -1)
    return F.segment_max(gathered, ids, out_nrows)


class MinkowskiDirectMaxPoolingFunction:
    """Functional shim for the reference's autograd Function."""

    @staticmethod
    def apply(in_map, out_map, in_feat, out_nrows, is_sorted=False):
        return direct_max_pool(in_map, out_map, in_feat, out_nrows, is_sorted)


def _pool_kmap(kg, in_key, out_key, manager, is_transpose):
    return manager.kernel_map(
        in_key, out_key, stride=kg.kernel_stride, kernel_size=kg.kernel_size,
        dilation=kg.kernel_dilation, is_transpose=is_transpose, is_pool=True,
    )


class MinkowskiLocalPoolingFunction:
    """Functional shim (reference: MinkowskiPooling.py:42-110)."""

    @staticmethod
    def apply(input_features, pooling_mode, kernel_generator, in_coordinate_map_key,
              out_coordinate_map_key, coordinate_manager):
        kmap = _pool_kmap(kernel_generator, in_coordinate_map_key, out_coordinate_map_key,
                          coordinate_manager, is_transpose=False)
        return _LOCAL.get(pooling_mode, _LOCAL[PoolingMode.LOCAL_AVG_POOLING])(
            input_features, kmap.in_idx
        )


class MinkowskiLocalPoolingTransposeFunction:
    """Functional shim (reference: MinkowskiPooling.py:441-512)."""

    @staticmethod
    def apply(input_features, pooling_mode, kernel_generator, in_coordinate_map_key,
              out_coordinate_map_key, coordinate_manager):
        kmap = _pool_kmap(kernel_generator, in_coordinate_map_key, out_coordinate_map_key,
                          coordinate_manager, is_transpose=True)
        return F.local_pool_avg(input_features, kmap.in_idx)[0]


class MinkowskiGlobalPoolingFunction:
    """Functional shim (reference: MinkowskiPooling.py:583-631)."""

    @staticmethod
    def apply(input_features, pooling_mode, in_coordinate_map_key,
              out_coordinate_map_key, coordinate_manager):
        origin_key, origin_rows = coordinate_manager.origin_map(in_coordinate_map_key)
        num = coordinate_manager.size(origin_key)
        mode = _GLOBAL.get(pooling_mode, "avg")
        return F.global_pool(input_features, origin_rows, num, mode)[0]
