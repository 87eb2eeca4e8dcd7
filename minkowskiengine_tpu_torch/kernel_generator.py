"""Kernel region specification and offset enumeration.

Counterpart of ``minkowskiengine_tpu/kernel_generator.py`` (reference:
MinkowskiEngine/MinkowskiKernelGenerator.py:38-337,
src/kernel_region.hpp:198-247).  Offsets are materialized once per
(tensor_stride, is_transpose) as a small host ``(volume, D)`` int32 numpy
array of absolute coordinate deltas.  Their order is the reference's
(dimension 0 fastest; even kernels one-sided ``0..k-1``, odd kernels
centred; HYPER_CROSS is the centre followed by per-axis arms), so kernel
weights line up index for index with reference checkpoints and with the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .types import RegionType, as_tuple


def hyper_cube_offsets(
    kernel_size: Sequence[int],
    dilation: Sequence[int],
    tensor_stride: Sequence[int],
) -> np.ndarray:
    """HYPER_CUBE offsets, dim 0 fastest (reference: src/kernel_region.hpp:204-220)."""
    per_dim = []
    for ks, dil, ts in zip(kernel_size, dilation, tensor_stride):
        idx = np.arange(ks, dtype=np.int64)
        if ks % 2 != 0:
            idx = idx - ks // 2
        per_dim.append(idx * dil * ts)
    grids = np.meshgrid(*per_dim, indexing="ij")
    # 'ij' + reshape(order='F') makes axis 0 vary fastest.
    cols = [g.reshape(-1, order="F") for g in grids]
    return np.stack(cols, axis=1).astype(np.int32)


def hyper_cross_offsets(
    kernel_size: Sequence[int],
    dilation: Sequence[int],
    tensor_stride: Sequence[int],
) -> np.ndarray:
    """HYPER_CROSS offsets (reference: src/kernel_region.hpp:224-243): the
    centre, then per axis ``+1..+r`` followed by ``-r..-1``."""
    D = len(kernel_size)
    rows = [np.zeros(D, dtype=np.int64)]
    for axis, (ks, dil, ts) in enumerate(zip(kernel_size, dilation, tensor_stride)):
        if ks % 2 == 0:
            raise ValueError("HYPER_CROSS requires odd kernel sizes")
        r = (ks - 1) // 2
        for ind in range(ks - 1):
            off = ind + 1 if ind < r else ind - 2 * r
            row = np.zeros(D, dtype=np.int64)
            row[axis] = off * dil * ts
            rows.append(row)
    return np.stack(rows, axis=0).astype(np.int32)


def hybrid_offsets(
    kernel_size: Sequence[int],
    dilation: Sequence[int],
    tensor_stride: Sequence[int],
    axis_types: Sequence[RegionType],
) -> np.ndarray:
    """HYBRID → CUSTOM expansion (reference: MinkowskiKernelGenerator.py:153-222)."""
    D = len(kernel_size)
    offsets = [[0] * D]
    for d, (axis_type, ks) in enumerate(zip(axis_types, kernel_size)):
        if axis_type != RegionType.HYPER_CUBE:
            continue
        center = (ks - 1) // 2
        new_rows = []
        for base in offsets:
            for i in range(ks):
                if i == center:
                    continue
                row = list(base)
                row[d] = (i - center) * dilation[d] * tensor_stride[d]
                new_rows.append(row)
        offsets.extend(new_rows)
    for d, (axis_type, ks) in enumerate(zip(axis_types, kernel_size)):
        if axis_type != RegionType.HYPER_CROSS:
            continue
        center = (ks - 1) // 2
        for i in range(ks):
            if i == center:
                continue
            row = [0] * D
            row[d] = (i - center) * dilation[d] * tensor_stride[d]
            offsets.append(row)
    return np.asarray(offsets, dtype=np.int32)


def region_offsets(
    region_type: RegionType,
    kernel_size: Sequence[int],
    dilation: Sequence[int],
    tensor_stride: Sequence[int],
    custom_offsets: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Absolute (volume, D) int32 coordinate deltas for a kernel region."""
    if region_type == RegionType.HYPER_CUBE:
        return hyper_cube_offsets(kernel_size, dilation, tensor_stride)
    if region_type == RegionType.HYPER_CROSS:
        return hyper_cross_offsets(kernel_size, dilation, tensor_stride)
    if region_type == RegionType.CUSTOM:
        if custom_offsets is None:
            raise ValueError("CUSTOM region requires explicit offsets")
        return np.asarray(custom_offsets, dtype=np.int32)
    raise NotImplementedError(f"region_type {region_type}")


def get_kernel_volume(region_type, kernel_size, region_offset, axis_types, dimension):
    """Offset count of a kernel region (reference:
    MinkowskiKernelGenerator.py:38-102)."""
    region_type = RegionType(region_type)
    if region_type == RegionType.HYPER_CUBE:
        if region_offset is not None and np.size(region_offset) > 0:
            raise ValueError("Region offset must be None for HYPER_CUBE")
        if axis_types is not None:
            raise ValueError("Axis types must be None for HYPER_CUBE")
        return int(np.prod(kernel_size))
    if region_type == RegionType.HYPER_CROSS:
        ks = np.asarray(kernel_size, dtype=np.int64)
        if int(np.prod(ks % 2)) != 1:
            raise ValueError("kernel_size must be odd for HYPER_CROSS")
        return int(np.sum(ks - 1) + 1)
    if region_type == RegionType.CUSTOM:
        ro = np.asarray(region_offset)
        if ro.size == 0:
            raise ValueError("region_offset must be non-empty for CUSTOM")
        if ro.shape[1] != dimension:
            raise ValueError("region_offset dimension mismatch")
        return int(ro.shape[0])
    raise NotImplementedError(f"region_type {region_type}")


def convert_region_type(
    region_type,
    tensor_stride,
    kernel_size,
    up_stride,
    dilation,
    region_offset,
    axis_types,
    dimension,
    center: bool = True,
):
    """Resolve a region spec to ``(region_type, offsets, volume)``
    (reference: MinkowskiKernelGenerator.py:105-242).  HYBRID specs expand
    to CUSTOM offsets scaled by ``dilation * tensor_stride / up_stride``;
    CUSTOM passes its offsets through; the others return their volume and
    the given offsets (empty when none).  Offsets are (volume, D) int32 numpy."""
    region_type = RegionType(region_type)
    tensor_stride = as_tuple(tensor_stride, dimension)
    kernel_size = as_tuple(kernel_size, dimension)
    up_stride = as_tuple(up_stride, dimension)
    dilation = as_tuple(dilation, dimension)
    scale_stride = tuple(ts // us for ts, us in zip(tensor_stride, up_stride))

    if region_type == RegionType.HYBRID or axis_types is not None:
        if region_offset is not None and np.size(region_offset) > 0:
            raise ValueError("Region offset must be empty for HYBRID")
        offsets = hybrid_offsets(kernel_size, dilation, scale_stride, tuple(axis_types))
        return RegionType.CUSTOM, offsets, int(offsets.shape[0])
    if region_type == RegionType.CUSTOM:
        ro = np.asarray(region_offset, dtype=np.int32)
        if ro.size == 0:
            raise ValueError("region_offset must be non-empty for CUSTOM")
        return RegionType.CUSTOM, ro, int(ro.shape[0])
    volume = get_kernel_volume(region_type, kernel_size, None, None, dimension)
    if region_offset is None or np.size(region_offset) == 0:
        region_offset = np.zeros((0, dimension), dtype=np.int32)
    return region_type, np.asarray(region_offset, np.int32), volume


class KernelRegion:
    """A fully resolved kernel region for one tensor stride."""

    def __init__(self, region_type: RegionType, offsets: np.ndarray):
        self.region_type = RegionType(region_type)
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int32)

    @property
    def volume(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.offsets.shape[1])


class KernelGenerator:
    """Kernel shape spec, cached per (tensor_stride, is_transpose)
    (reference: MinkowskiKernelGenerator.py:244-337)."""

    def __init__(
        self,
        kernel_size=-1,
        stride=1,
        dilation=1,
        is_transpose: bool = False,
        region_type: RegionType = RegionType.HYPER_CUBE,
        region_offsets: Optional[np.ndarray] = None,
        axis_types: Optional[Sequence[RegionType]] = None,
        dimension: int = -1,
        expand_coordinates: bool = False,
    ):
        if dimension <= 0:
            raise ValueError("dimension must be a positive integer")
        self.dimension = int(dimension)
        self.kernel_size = as_tuple(kernel_size, dimension)
        self.kernel_stride = as_tuple(stride, dimension)
        self.kernel_dilation = as_tuple(dilation, dimension)
        self.is_transpose = bool(is_transpose)
        self.region_type = RegionType(region_type)
        self.axis_types = tuple(axis_types) if axis_types is not None else None
        self.expand_coordinates = bool(expand_coordinates)
        self.requires_strided_coordinates = all(s == 1 for s in self.kernel_stride)
        self._custom_offsets = (
            np.asarray(region_offsets, dtype=np.int32)
            if region_offsets is not None and np.size(region_offsets) > 0
            else None
        )

        if self.region_type == RegionType.HYPER_CUBE:
            self.kernel_volume = int(np.prod(self.kernel_size))
        elif self.region_type == RegionType.HYPER_CROSS:
            if any(k % 2 == 0 for k in self.kernel_size):
                raise ValueError("kernel_size must be odd for HYPER_CROSS")
            self.kernel_volume = int(sum(k - 1 for k in self.kernel_size) + 1)
        elif self.region_type == RegionType.CUSTOM:
            if self._custom_offsets is None:
                raise ValueError("CUSTOM region requires region_offsets")
            self.kernel_volume = int(self._custom_offsets.shape[0])
        else:
            raise NotImplementedError(f"region_type {self.region_type}")

        self._cache = {}

    def get_kernel(self, tensor_stride, is_transpose: bool) -> KernelRegion:
        """Region for coordinates at ``tensor_stride``.

        A transposed kernel's offsets are scaled by the *output* (finer)
        tensor stride ``tensor_stride / kernel_stride``, as the reference
        builds transpose regions with the out map's stride
        (src/coordinate_map_manager.cpp:793-801).
        """
        tensor_stride = as_tuple(tensor_stride, self.dimension)
        cache_key = (tensor_stride, bool(is_transpose))
        if cache_key in self._cache:
            return self._cache[cache_key]

        if is_transpose:
            for ts, ks in zip(tensor_stride, self.kernel_stride):
                if ts % ks != 0:
                    raise ValueError(
                        f"Invalid up stride {self.kernel_stride} on tensor "
                        f"stride {tensor_stride}"
                    )
            scale_stride = tuple(
                ts // ks for ts, ks in zip(tensor_stride, self.kernel_stride)
            )
        else:
            scale_stride = tensor_stride

        if self.region_type == RegionType.CUSTOM and self.axis_types is None:
            offsets = self._custom_offsets
            region_type = RegionType.CUSTOM
        elif self.axis_types is not None:
            offsets = hybrid_offsets(
                self.kernel_size, self.kernel_dilation, scale_stride, self.axis_types
            )
            region_type = RegionType.CUSTOM
        else:
            offsets = region_offsets(
                self.region_type,
                self.kernel_size,
                self.kernel_dilation,
                scale_stride,
                self._custom_offsets,
            )
            region_type = self.region_type

        region = KernelRegion(region_type, offsets)
        self._cache[cache_key] = region
        return region

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(kernel_size={self.kernel_size}, "
            f"stride={self.kernel_stride}, dilation={self.kernel_dilation}, "
            f"region_type={self.region_type.name}, volume={self.kernel_volume})"
        )
