"""CoordinateMap: an immutable, sorted coordinate set on one device, and
CoordinateFieldMap: the continuous coordinates behind a TensorField.

Counterpart of ``minkowskiengine_tpu/coords/map.py``.  Rows are stored in
ascending packed-key order (the canonical batch-major order) with their
keys beside them, so lookups are binary searches.  Unlike the JAX package
the map holds exactly ``size`` rows.  The power-of-two capacity buckets
(``bucket_capacity``) serve one purpose here: geometry replay builds its
maps at floored capacities (``PaddedCoordinateMap``), with counts on the
device, so that a whole coordinate phase runs without a host sync and fits
one CUDA graph; one transfer then reads every count and the maps are cut
to exact ``CoordinateMap``s before any model sees them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

MIN_CAPACITY = 128


def bucket_capacity(n: int, minimum: int = MIN_CAPACITY) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CoordinateMap:
    """Sorted coordinate map.

    Attributes:
      coordinates: (N, D+1) int32, batch-first rows in ascending key order.
      keys: packed int64 keys (coords/keys.py), ascending and unique: (N,)
        for D <= 6, (N, L) words compared lexicographically for D >= 7.
      tensor_stride: D-tuple of ints.
    """

    coordinates: torch.Tensor
    keys: torch.Tensor
    tensor_stride: Tuple[int, ...]

    @property
    def size(self) -> int:
        return int(self.coordinates.shape[0])

    @property
    def rows(self) -> int:
        """Stored rows: ``size`` here, the capacity of a padded map."""
        return int(self.coordinates.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.coordinates.shape[1]) - 1

    @property
    def device(self) -> torch.device:
        return self.coordinates.device

    @property
    def batch_indices(self) -> torch.Tensor:
        """The batch column of the stored rows."""
        return self.coordinates[:, 0]

    def valid_mask(self):
        """None: every stored row is valid."""
        return None

    def to_numpy(self) -> np.ndarray:
        """The map's rows as a host (size, D+1) int32 array."""
        return self.coordinates[: self.size].cpu().numpy()


@dataclasses.dataclass(frozen=True)
class PaddedCoordinateMap(CoordinateMap):
    """A map at a fixed capacity, only inside geometry replay.

    The first ``count`` rows are the map; the tail holds ``PAD_KEY`` keys
    (in every word) and zero coordinates.  ``count`` is a 0-d int64 tensor
    on the device and may exceed the capacity (the floor did not hold: the
    replay's check reports it).  ``size`` raises: reading the count is a host sync.

    Attributes (beyond CoordinateMap's):
      count: () int64 device tensor, the unique rows found.
    """

    count: torch.Tensor

    @property
    def size(self) -> int:
        raise RuntimeError(
            "a padded map's row count is on the device; geometry replay cuts "
            "the map to its exact rows after its one host sync"
        )

    @property
    def capacity(self) -> int:
        return int(self.coordinates.shape[0])

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.count

    def exact(self, n: int) -> CoordinateMap:
        """The first ``n`` rows as an exact map that owns its tensors."""
        if n > self.capacity:
            raise ValueError(f"{n} rows > capacity {self.capacity}")
        return CoordinateMap(
            self.coordinates[:n].clone(), self.keys[:n].clone(), self.tensor_stride
        )


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
