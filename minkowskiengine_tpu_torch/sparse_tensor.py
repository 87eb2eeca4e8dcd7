"""SparseTensor: features on a discrete coordinate map.

Counterpart of ``minkowskiengine_tpu/sparse_tensor.py`` (reference:
MinkowskiEngine/MinkowskiSparseTensor.py).  Feature rows are exact-size
and follow the map's canonical batch-major key order.  ``slice`` and
``cat_slice`` carry features back to the TensorField they came from.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .coords.manager import CoordinateManager, CoordinateMapKey
from .ops import functional as F
from .ops.functional import take_rows
from .tensor import (
    global_coordinate_manager,
    set_global_coordinate_manager,
    sparse_tensor_operation_mode,
)
from .types import SparseTensorOperationMode, SparseTensorQuantizationMode, resolve_device

_SPLAT_PENDING = (
    "SPLAT_LINEAR_INTERPOLATION (TensorField.splat) waits for the "
    "interpolation slice, ROADMAP queue 1 item 9"
)


def as_features(features, device=None) -> torch.Tensor:
    """Features as a tensor.  ``device`` when given; otherwise a tensor stays
    on its device and host data (numpy, lists) goes to the card."""
    if isinstance(features, torch.Tensor):
        return features if device is None else features.to(device)
    return torch.as_tensor(features, device=resolve_device(device))


def default_manager(D: int, device) -> CoordinateManager:
    """The manager of a tensor built from raw coordinates: the global one in
    SHARE_COORDINATE_MANAGER mode, else a new one on ``device``."""
    if sparse_tensor_operation_mode() != SparseTensorOperationMode.SHARE_COORDINATE_MANAGER:
        return CoordinateManager(D=D, device=device)
    manager = global_coordinate_manager()
    if manager is None:
        manager = CoordinateManager(D=D, device=device)
        set_global_coordinate_manager(manager)
    return manager


def quantize_features(features, inverse_map, n_out: int, mode, unique_map=None) -> torch.Tensor:
    """Reduce the feature rows that share a voxel (``inverse_map``: the
    voxel of each row, -1 for none): the voxel's first row
    (RANDOM_SUBSAMPLE, NO_QUANTIZATION; ``unique_map`` when the caller has
    it), or the rows' mean (UNWEIGHTED_AVERAGE), sum (UNWEIGHTED_SUM) or
    max (MAX_POOL) (reference: MinkowskiSparseTensor.py:311-345)."""
    Q = SparseTensorQuantizationMode
    if mode in (Q.RANDOM_SUBSAMPLE, Q.NO_QUANTIZATION):
        if unique_map is None:
            rows = torch.arange(inverse_map.shape[0], device=inverse_map.device)
            first = torch.full((n_out + 1,), inverse_map.shape[0], device=inverse_map.device)
            ids = torch.where(inverse_map >= 0, inverse_map.long(), n_out)
            unique_map = first.scatter_reduce(0, ids, rows, "amin")[:n_out]
        return take_rows(features, unique_map.to(features.device))
    if mode == Q.UNWEIGHTED_AVERAGE:
        return F.segment_mean(features, inverse_map, n_out)
    if mode == Q.UNWEIGHTED_SUM:
        return F.segment_sum(features, inverse_map, n_out)
    if mode == Q.MAX_POOL:
        return F.segment_max(features, inverse_map, n_out)
    if mode == Q.SPLAT_LINEAR_INTERPOLATION:
        raise NotImplementedError(_SPLAT_PENDING)
    raise ValueError(f"Unsupported quantization mode {mode!r}")


class SparseTensor:
    """An (N, ch) feature matrix attached to a coordinate map.

    Construction paths (reference: MinkowskiSparseTensor.py:122-345):

    * ``SparseTensor(features, coordinates)`` quantizes the coordinates
      (unique + inverse); the rows of a duplicate coordinate are reduced
      by ``quantization_mode``: the first row (RANDOM_SUBSAMPLE,
      NO_QUANTIZATION), their mean (UNWEIGHTED_AVERAGE), sum
      (UNWEIGHTED_SUM) or max (MAX_POOL).
    * ``SparseTensor(features, coordinate_map_key=key,
      coordinate_manager=mgr)`` attaches features to an existing map, in
      the map's row order.

    ``device``: where the features and a new manager live.  By default a
    feature tensor stays on its device and host data goes to the card.
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
        features = as_features(features, device)
        if features.ndim != 2:
            raise ValueError(f"features must be rank-2, got {tuple(features.shape)}")
        self.unique_index = None
        self.inverse_mapping = None

        if coordinates is not None:
            if quantization_mode == SparseTensorQuantizationMode.SPLAT_LINEAR_INTERPOLATION:
                raise NotImplementedError(_SPLAT_PENDING)
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
            if coordinate_manager is None:
                coordinate_manager = default_manager(coordinates.shape[1] - 1, features.device)
            coordinate_map_key, (unique_map, inverse_map) = (
                coordinate_manager.insert_and_map(coordinates, tensor_stride)
            )
            self.unique_index = unique_map
            self.inverse_mapping = inverse_map
            features = quantize_features(
                features, inverse_map, unique_map.shape[0], quantization_mode, unique_map
            )
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

    # ------------------------------------------------------------------
    # arithmetic (reference: MinkowskiTensor.py:511-585)
    # ------------------------------------------------------------------
    def _binary(self, other, op):
        """``op`` on the features.  Two tensors on different maps of one
        manager meet on the union of their coordinates (a ``merged`` map):
        a row absent from one operand takes 0 for it, as in JAX.  (The
        reference leaves rows found only in the left operand untouched, so
        under ``*`` and ``/`` it keeps their value; ROADMAP queue 3.)"""
        if not isinstance(other, SparseTensor):
            return self._wrap(op(self._F, other))
        if self._manager is not other._manager:
            raise ValueError(
                "Both SparseTensors must share a coordinate manager for "
                "mixed-coordinate arithmetic"
            )
        if self.coordinate_map_key == other.coordinate_map_key:
            return self._wrap(op(self._F, other._F))
        keys = [self.coordinate_map_key, other.coordinate_map_key]
        union_key = self._manager.merge(keys)
        n = self._manager.size(union_key)
        inv = [_invert_union_map(m, n) for m in self._manager.union_map(keys, union_key)]
        return SparseTensor(
            op(take_rows(self._F, inv[0]), take_rows(other._F, inv[1])),
            coordinate_map_key=union_key,
            coordinate_manager=self._manager,
        )

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._binary(other, lambda a, b: b + a)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binary(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._binary(other, lambda a, b: a / b)

    def __neg__(self):
        return self._wrap(-self._F)

    def __pow__(self, p):
        return self._wrap(self._F**p)

    # ------------------------------------------------------------------
    # field bridges (reference: MinkowskiSparseTensor.py:559-688)
    # ------------------------------------------------------------------
    def slice(self, X):
        """This tensor's features on the points of the TensorField ``X`` it
        was quantized from: each point takes its voxel's row."""
        from .tensor_field import TensorField

        if not isinstance(X, TensorField):
            raise TypeError("slice requires a TensorField input")
        feats = take_rows(self._F, X.inverse_mapping(self.coordinate_map_key))
        return X._wrap(feats)

    def cat_slice(self, X):
        """``X``'s own features, then the sliced features, side by side."""
        from .tensor_field import TensorField

        if not isinstance(X, TensorField):
            raise TypeError("cat_slice requires a TensorField input")
        sliced = take_rows(self._F, X.inverse_mapping(self.coordinate_map_key))
        return X._wrap(torch.cat([X.F, sliced], dim=1))

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(size={self.size}, "
            f"channels={self._F.shape[1]}, "
            f"coordinate_map_key={self.coordinate_map_key}, "
            f"device={self.device})"
        )


def _invert_union_map(in_to_union: torch.Tensor, n_union: int) -> torch.Tensor:
    """Invert an injective row map: the source row of each union row, or -1.
    Absent rows are scattered to one spare slot past the end, which is
    dropped, so the inversion needs no host sync."""
    src = torch.arange(in_to_union.shape[0], dtype=torch.int32, device=in_to_union.device)
    tgt = torch.where(in_to_union >= 0, in_to_union.long(), n_union)
    out = torch.full((n_union + 1,), -1, dtype=torch.int32, device=in_to_union.device)
    return out.scatter_(0, tgt, src)[:n_union]
