"""Coordinate engine: packed keys, sorted maps, kernel maps, the manager,
and geometry replay for training on fresh point clouds."""

from .kernel_map import KernelMap, build_kernel_map, build_stride_map
from .manager import (
    CapacityFloorExceeded,
    CoordinateManager,
    CoordinateMapKey,
    UntraceableReplay,
)
from .map import CoordinateFieldMap, CoordinateMap, bucket_capacity
from .geometry import (
    CompiledReplayer,
    Geometry,
    GeometryReplayer,
    index_geometry,
    squeeze_geometry,
    stack_geometries,
)

__all__ = [
    "CapacityFloorExceeded",
    "CompiledReplayer",
    "CoordinateFieldMap",
    "CoordinateManager",
    "CoordinateMap",
    "CoordinateMapKey",
    "Geometry",
    "GeometryReplayer",
    "KernelMap",
    "UntraceableReplay",
    "bucket_capacity",
    "build_kernel_map",
    "build_stride_map",
    "index_geometry",
    "squeeze_geometry",
    "stack_geometries",
]
