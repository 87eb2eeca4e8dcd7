"""TensorField: features on continuous (float) coordinates.

Counterpart of ``minkowskiengine_tpu/tensor_field.py`` (reference:
MinkowskiEngine/MinkowskiTensorField.py).  A TensorField holds raw,
unquantized points; ``.sparse()`` voxelizes it onto a SparseTensor, and the
manager keeps the field-to-sparse row map so that ``SparseTensor.slice``
can carry voxel features back to the points.  ``.splat()`` (and
``sparse()`` in SPLAT_LINEAR_INTERPOLATION mode) spreads each point's
features over the 2^D lattice corners around it with multilinear weights.
"""

from __future__ import annotations

from typing import Optional

import torch

from .coords.manager import CoordinateManager, CoordinateMapKey, _interp_corner_coords
from .ops import functional as F
from .sparse_tensor import (
    SparseTensor, as_input_features, default_manager, quantize_features,
)
from .types import SparseTensorQuantizationMode, as_tuple
from .utils import profiling as P


class TensorField:
    """An (N, ch) feature matrix on N float points (batch index in column 0).

    ``device``: where the features and a new manager live.  By default a
    feature tensor stays on its device and host data goes to the card.
    ``allocator_type`` and ``minkowski_algorithm`` are taken and select
    nothing, as in JAX (whose TensorField does not hand them to its new
    manager); ``requires_grad`` sets the features' flag, as ``SparseTensor``.
    """

    def __init__(
        self,
        features,
        coordinates=None,
        *,
        tensor_stride=1,
        coordinate_field_map_key: Optional[CoordinateMapKey] = None,
        coordinate_manager: Optional[CoordinateManager] = None,
        quantization_mode: SparseTensorQuantizationMode = (
            SparseTensorQuantizationMode.UNWEIGHTED_AVERAGE
        ),
        allocator_type=None,
        minkowski_algorithm=None,
        requires_grad=None,
        device=None,
    ):
        if coordinates is None and (
            coordinate_field_map_key is None or coordinate_manager is None
        ):
            raise ValueError(
                "Either coordinates or (coordinate_field_map_key, "
                "coordinate_manager) must be provided"
            )
        features = as_input_features(features, device, requires_grad)
        if features.ndim != 2:
            raise ValueError(f"features must be rank-2, got {tuple(features.shape)}")
        self.quantization_mode = quantization_mode
        if coordinates is not None:
            coordinates = torch.as_tensor(coordinates)
            if coordinates.ndim != 2 or features.shape[0] != coordinates.shape[0]:
                raise ValueError(
                    f"features {tuple(features.shape)} and coordinates "
                    f"{tuple(coordinates.shape)} must be rank-2 with matching rows"
                )
            with P.span("tensor.field"):
                if coordinate_manager is None:
                    coordinate_manager = default_manager(coordinates.shape[1] - 1, features.device)
                coordinate_field_map_key = coordinate_manager.insert_field(
                    coordinates, tensor_stride
                )
        n = coordinate_manager._get_field_map(coordinate_field_map_key).size
        if features.shape[0] != n:
            raise ValueError(f"features rows ({features.shape[0]}) != field size ({n})")
        self._F = features
        self.coordinate_field_map_key = coordinate_field_map_key
        self._manager = coordinate_manager

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def coordinate_manager(self) -> CoordinateManager:
        return self._manager

    @property
    def D(self) -> int:
        return self._manager.D

    @property
    def F(self) -> torch.Tensor:
        """(N, ch) features."""
        return self._F

    @property
    def C(self) -> torch.Tensor:
        """(N, D+1) float32 coordinates, batch first."""
        return self._manager.get_coordinate_field(self.coordinate_field_map_key)

    @property
    def features(self) -> torch.Tensor:
        return self.F

    @property
    def coordinates(self) -> torch.Tensor:
        return self.C

    @property
    def dtype(self):
        return self._F.dtype

    @property
    def size(self) -> int:
        return int(self._F.shape[0])

    @property
    def shape(self):
        return tuple(self._F.shape)

    @property
    def device(self):
        return self._F.device

    def __len__(self):
        return self.size

    def _wrap(self, features: torch.Tensor) -> "TensorField":
        """New TensorField on these points."""
        return TensorField(
            features,
            coordinate_field_map_key=self.coordinate_field_map_key,
            coordinate_manager=self._manager,
            quantization_mode=self.quantization_mode,
        )

    # ------------------------------------------------------------------
    # conversion (reference: MinkowskiTensorField.py:286-450)
    # ------------------------------------------------------------------
    def sparse(
        self,
        tensor_stride=1,
        coordinate_map_key: Optional[CoordinateMapKey] = None,
        quantization_mode: Optional[SparseTensorQuantizationMode] = None,
    ) -> SparseTensor:
        """Voxelize onto a SparseTensor: the points of a voxel are reduced by
        ``quantization_mode`` (default: the field's).  Without a
        ``coordinate_map_key`` the voxels form a new map at
        ``tensor_stride``; a second call on the same field gets a new key
        (``map-N``), as in the JAX package.  SPLAT_LINEAR_INTERPOLATION is
        ``splat()``, on the unit lattice only (the reference asserts here
        and asks for ``.splat()``; JAX, and so the port, wire it through)."""
        if quantization_mode is None:
            quantization_mode = self.quantization_mode
        if quantization_mode == SparseTensorQuantizationMode.SPLAT_LINEAR_INTERPOLATION:
            ts = tensor_stride if coordinate_map_key is None else coordinate_map_key.get_tensor_stride()
            if as_tuple(ts, self.D) != (1,) * self.D:
                raise ValueError(
                    "SPLAT_LINEAR_INTERPOLATION voxelizes onto the unit lattice (tensor_stride 1)"
                )
            return self.splat()
        if quantization_mode == SparseTensorQuantizationMode.NO_QUANTIZATION:
            raise ValueError("a TensorField quantizes: NO_QUANTIZATION does not apply")
        with P.span("tensor.sparse"):
            unique_map = None
            if coordinate_map_key is None:
                coordinate_map_key, (unique_map, _) = self._manager.field_to_sparse_insert_and_map(
                    self.coordinate_field_map_key, tensor_stride
                )
            feats = quantize_features(
                self._F, self.inverse_mapping(coordinate_map_key),
                self._manager.size(coordinate_map_key), quantization_mode, unique_map,
            )
            return SparseTensor(
                feats, coordinate_map_key=coordinate_map_key, coordinate_manager=self._manager
            )

    def splat(self) -> SparseTensor:
        """Scatter the features onto the lattice corners around each point
        with multilinear weights (reference: MinkowskiTensorField.py:381-406).
        The corner set, the 2^D corners of every point, is built on the
        field's device; then the manager is called in the JAX package's order
        (``insert_and_map``, ``interpolation_map_weight``), so the new map's
        key is JAX's: ``(1, ..., 1)`` with id ``""``, or ``map-N`` when taken."""
        with P.span("tensor.sparse"):
            coords, D = self.C, self.D
            corners, _ = _interp_corner_coords(coords, (1,) * D)
            key, _ = self._manager.insert_and_map(corners.reshape(-1, D + 1), (1,) * D)
            rows, weights = self._manager.interpolation_map_weight(key, coords)
            feats = F.splat_features(self._F, rows, weights, self._manager.size(key))
            return SparseTensor(feats, coordinate_map_key=key, coordinate_manager=self._manager)

    def inverse_mapping(self, sparse_tensor_map_key: CoordinateMapKey) -> torch.Tensor:
        """(N,) sparse row of each point, for a sparse map quantized from
        this field's points at that map's tensor stride."""
        return self._manager.field_to_sparse_map(
            self.coordinate_field_map_key, sparse_tensor_map_key
        )

    def __add__(self, other):
        return self._wrap(self._F + (other._F if isinstance(other, TensorField) else other))

    def __mul__(self, other):
        return self._wrap(self._F * (other._F if isinstance(other, TensorField) else other))

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(size={self.size}, channels={self._F.shape[1]}, "
            f"coordinate_field_map_key={self.coordinate_field_map_key}, device={self.device})"
        )
