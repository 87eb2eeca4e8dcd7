"""SparseTensor: features on a discrete coordinate map.

Counterpart of ``minkowskiengine_tpu/sparse_tensor.py`` (reference:
MinkowskiEngine/MinkowskiSparseTensor.py).  Feature rows are exact-size
and follow the map's canonical batch-major key order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .coords.manager import CoordinateManager, CoordinateMapKey
from .ops.functional import take_rows
from .tensor import (
    global_coordinate_manager,
    set_global_coordinate_manager,
    sparse_tensor_operation_mode,
)
from .types import SparseTensorOperationMode, SparseTensorQuantizationMode


class SparseTensor:
    """An (N, ch) feature matrix attached to a coordinate map.

    Construction paths (reference: MinkowskiSparseTensor.py:122-345):

    * ``SparseTensor(features, coordinates)`` quantizes the coordinates
      (unique + inverse); duplicate coordinates keep their first row's
      features (RANDOM_SUBSAMPLE / NO_QUANTIZATION).
    * ``SparseTensor(features, coordinate_map_key=key,
      coordinate_manager=mgr)`` attaches features to an existing map, in
      the map's row order.

    A new manager lives on ``device`` (default: the features' device).
    """

    def __init__(
        self,
        features,
        coordinates=None,
        *,
        tensor_stride: Union[int, Sequence[int]] = 1,
        coordinate_map_key: Optional[CoordinateMapKey] = None,
        coordinate_manager: Optional[CoordinateManager] = None,
        quantization_mode: SparseTensorQuantizationMode = (
            SparseTensorQuantizationMode.RANDOM_SUBSAMPLE
        ),
        device=None,
    ):
        if coordinates is None and (
            coordinate_map_key is None or coordinate_manager is None
        ):
            raise ValueError(
                "Either coordinates or (coordinate_map_key, coordinate_manager) "
                "must be provided"
            )
        features = torch.as_tensor(features, device=device)
        if features.ndim != 2:
            raise ValueError(f"features must be rank-2, got {tuple(features.shape)}")
        self.unique_index = None
        self.inverse_mapping = None

        if coordinates is not None:
            Q = SparseTensorQuantizationMode
            if quantization_mode not in (Q.RANDOM_SUBSAMPLE, Q.NO_QUANTIZATION):
                raise NotImplementedError(
                    f"quantization mode {quantization_mode!r} is not ported yet"
                )
            coordinates = torch.as_tensor(coordinates)
            if coordinates.ndim != 2:
                raise ValueError(
                    f"coordinates must be rank-2, got {tuple(coordinates.shape)}"
                )
            if features.shape[0] != coordinates.shape[0]:
                raise ValueError(
                    "features and coordinates must have matching rows: "
                    f"{features.shape[0]} vs {coordinates.shape[0]}"
                )
            D = coordinates.shape[1] - 1
            if coordinate_manager is None:
                shared = (
                    sparse_tensor_operation_mode()
                    == SparseTensorOperationMode.SHARE_COORDINATE_MANAGER
                )
                if shared:
                    coordinate_manager = global_coordinate_manager()
                if coordinate_manager is None:
                    coordinate_manager = CoordinateManager(D=D, device=features.device)
                    if shared:
                        set_global_coordinate_manager(coordinate_manager)
            coordinate_map_key, (unique_map, inverse_map) = (
                coordinate_manager.insert_and_map(coordinates, tensor_stride)
            )
            self.unique_index = unique_map
            self.inverse_mapping = inverse_map
            features = take_rows(features, unique_map.to(features.device))
        elif features.shape[0] != coordinate_manager.size(coordinate_map_key):
            raise ValueError(
                f"features rows ({features.shape[0]}) != coordinate map size "
                f"({coordinate_manager.size(coordinate_map_key)})"
            )

        self._F = features
        self.coordinate_map_key = coordinate_map_key
        self._manager = coordinate_manager

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def coordinate_manager(self) -> CoordinateManager:
        return self._manager

    @property
    def D(self) -> int:
        return self._manager.D

    @property
    def tensor_stride(self) -> Tuple[int, ...]:
        return self.coordinate_map_key.get_tensor_stride()

    @property
    def size(self) -> int:
        """Number of rows."""
        return int(self._F.shape[0])

    @property
    def F(self) -> torch.Tensor:
        """(N, ch) features."""
        return self._F

    @property
    def C(self) -> torch.Tensor:
        """(N, D+1) int32 coordinates, batch first."""
        return self._manager.get_coordinates(self.coordinate_map_key)

    @property
    def device(self):
        return self._F.device

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _wrap(self, features: torch.Tensor, key=None) -> "SparseTensor":
        """New SparseTensor with this coordinate structure (or ``key``)."""
        return SparseTensor(
            features,
            coordinate_map_key=key or self.coordinate_map_key,
            coordinate_manager=self._manager,
        )

    def __add__(self, other):
        if isinstance(other, SparseTensor):
            if self._manager is not other._manager:
                raise ValueError(
                    "Both SparseTensors must share a coordinate manager for "
                    "mixed-coordinate arithmetic"
                )
            if self.coordinate_map_key != other.coordinate_map_key:
                raise NotImplementedError(
                    "mixed-coordinate arithmetic (the union path) is not "
                    "ported yet"
                )
            return self._wrap(self._F + other._F)
        return self._wrap(self._F + other)

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(size={self.size}, "
            f"channels={self._F.shape[1]}, "
            f"coordinate_map_key={self.coordinate_map_key}, "
            f"device={self.device})"
        )
