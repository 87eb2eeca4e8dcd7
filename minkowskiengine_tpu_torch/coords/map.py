"""CoordinateMap: an immutable, sorted coordinate set on one device, and
CoordinateFieldMap: the continuous coordinates behind a TensorField.

Counterpart of ``minkowskiengine_tpu/coords/map.py``.  Rows are stored in
ascending packed-key order (the canonical batch-major order) with their
keys beside them, so lookups are binary searches.  Unlike the JAX package
the map holds exactly ``size`` rows: the power-of-two capacity buckets
existed for XLA's static shapes and are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CoordinateMap:
    """Sorted coordinate map.

    Attributes:
      coordinates: (N, D+1) int32, batch-first rows in ascending key order.
      keys: (N,) int64 packed keys (coords/keys.py), ascending and unique.
      tensor_stride: D-tuple of ints.
    """

    coordinates: torch.Tensor
    keys: torch.Tensor
    tensor_stride: Tuple[int, ...]

    @property
    def size(self) -> int:
        return int(self.coordinates.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.coordinates.shape[1]) - 1

    @property
    def device(self) -> torch.device:
        return self.coordinates.device


@dataclasses.dataclass(frozen=True)
class CoordinateFieldMap:
    """Continuous (float) coordinate store backing ``TensorField``.

    Counterpart of ``CoordinateFieldMap`` in
    ``minkowskiengine_tpu/coords/manager.py`` (reference:
    ``CoordinateFieldMapCPU``, src/coordinate_map_cpu.hpp:945-1146): a plain
    row store in input order, no hashing, exactly ``size`` rows.

    Attributes:
      coordinates: (N, D+1) float32; column 0 is the batch index.
      tensor_stride: D-tuple of ints.
    """

    coordinates: torch.Tensor
    tensor_stride: Tuple[int, ...]

    @property
    def size(self) -> int:
        return int(self.coordinates.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.coordinates.shape[1]) - 1

    @property
    def device(self) -> torch.device:
        return self.coordinates.device
