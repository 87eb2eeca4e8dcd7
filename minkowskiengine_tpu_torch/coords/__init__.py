"""Coordinate engine: packed keys, sorted maps, kernel maps, the manager."""

from .kernel_map import KernelMap, build_kernel_map
from .manager import CoordinateManager, CoordinateMapKey
from .map import CoordinateMap

__all__ = [
    "CoordinateManager",
    "CoordinateMap",
    "CoordinateMapKey",
    "KernelMap",
    "build_kernel_map",
]
