"""SparseTensor: features on a discrete coordinate map.

Counterpart of ``minkowskiengine_tpu/sparse_tensor.py`` (reference:
MinkowskiEngine/MinkowskiSparseTensor.py).  Feature rows are exact-size
and follow the map's canonical batch-major key order.  ``slice`` and
``cat_slice`` carry features back to the TensorField they came from;
``interpolate`` and ``features_at_coordinates`` sample them at float
points; ``dense`` and ``sparse`` export them.

**Row blocks** (spatial execution, ``parallel/spatial.py``): a SparseTensor
made by ``parallel.shard_sparse_tensor`` holds one row block of its map's
features, the map itself being whole on every rank.  Its ``row_block``
(a ``parallel.spatial.RowBlock``: the mesh axis, so rank r of n) says
which: block r of every map, by ``torch.tensor_split``'s rule.  The
descriptor, not a padded or global tensor, carries the sharding, so the
exact-row-count maps and kernels stay as they are.  ``F`` and ``C`` are
the block's rows.  Ops that keep the key and work row by row carry the
descriptor through ``_wrap`` (nonlinearities, ``cat`` at the skip joins,
arithmetic on one map); the conv modules run the halo path and their
outputs take the same descriptor on the new map; batch norm sums its
statistics over the group.  Every op that needs all rows of the cloud
raises on a block through ``whole_rows`` (pooling, union, pruning,
broadcast, interpolation, instance norm, ``dense``, ``sparse``,
decomposition, slicing, arithmetic across maps): none computes on the
block as if it were the cloud.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

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
from .utils import profiling as P


def as_features(features, device=None) -> torch.Tensor:
    """Features as a tensor.  ``device`` when given; otherwise a tensor stays
    on its device and host data (numpy, lists) goes to the card."""
    if isinstance(features, torch.Tensor):
        return features if device is None else features.to(device)
    return torch.as_tensor(features, device=resolve_device(device))


def default_manager(D: int, device, allocator_type=None, minkowski_algorithm=None) -> CoordinateManager:
    """The manager of a tensor built from raw coordinates: the global one in
    SHARE_COORDINATE_MANAGER mode, else a new one on ``device``; a new
    manager keeps the reference's backend keywords, as JAX's does."""
    def new():
        return CoordinateManager(D=D, allocator_type=allocator_type,
                                 minkowski_algorithm=minkowski_algorithm, device=device)

    if sparse_tensor_operation_mode() != SparseTensorOperationMode.SHARE_COORDINATE_MANAGER:
        return new()
    manager = global_coordinate_manager()
    if manager is None:
        manager = new()
        set_global_coordinate_manager(manager)
    return manager


def as_input_features(features, device, requires_grad) -> torch.Tensor:
    """``as_features``; ``requires_grad`` (not None) sets the features' flag
    first, as the reference's tensors do (MinkowskiTensor.py); JAX takes
    the keyword and ignores it."""
    features = as_features(features, device)
    if requires_grad is not None:
        features.requires_grad_(requires_grad)
    return features


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
    raise ValueError(f"Unsupported quantization mode {mode!r}")


class SparseTensor:
    """An (N, ch) feature matrix attached to a coordinate map.

    Construction paths (reference: MinkowskiSparseTensor.py:122-345):

    * ``SparseTensor(features, coordinates)`` quantizes the coordinates
      (unique + inverse); the rows of a duplicate coordinate are reduced
      by ``quantization_mode``: the first row (RANDOM_SUBSAMPLE,
      NO_QUANTIZATION), their mean (UNWEIGHTED_AVERAGE), sum
      (UNWEIGHTED_SUM) or max (MAX_POOL).  SPLAT_LINEAR_INTERPOLATION takes
      float coordinates and splats them onto the unit lattice
      (``TensorField.splat``).
    * ``SparseTensor(features, coordinate_map_key=key,
      coordinate_manager=mgr)`` attaches features to an existing map, in
      the map's row order.

    ``device``: where the features and a new manager live.  By default a
    feature tensor stays on its device and host data goes to the card.
    ``row_block``: the features are this rank's row block of the map
    (spatial execution; the module docstring says what follows).
    ``allocator_type`` and ``minkowski_algorithm`` go to a new manager, as
    in JAX; ``requires_grad`` (not None) sets the features' flag, as the
    reference does (JAX ignores it).
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
        allocator_type=None,
        minkowski_algorithm=None,
        requires_grad=None,
        device=None,
        row_block=None,
    ):
        if coordinates is None and (
            coordinate_map_key is None or coordinate_manager is None
        ):
            raise ValueError(
                "Either coordinates or (coordinate_map_key, coordinate_manager) "
                "must be provided"
            )
        if row_block is not None and coordinates is not None:
            raise ValueError("a row block attaches features to an existing map, not to coordinates")
        features = as_input_features(features, device, requires_grad)
        if features.ndim != 2:
            raise ValueError(f"features must be rank-2, got {tuple(features.shape)}")
        self.quantization_mode = quantization_mode
        self.unique_index = None
        self.inverse_mapping = None

        if coordinates is not None and (
            quantization_mode == SparseTensorQuantizationMode.SPLAT_LINEAR_INTERPOLATION
        ):
            # float coordinates splatted onto the unit lattice, as JAX does
            from .tensor_field import TensorField

            with P.span("tensor.sparse"):
                st = TensorField(
                    features, torch.as_tensor(coordinates).to(torch.float32),
                    coordinate_manager=coordinate_manager, quantization_mode=quantization_mode,
                ).splat()
            features, coordinate_map_key, coordinate_manager = st._F, st.coordinate_map_key, st._manager
        elif coordinates is not None:
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
            with P.span("tensor.sparse"):
                if coordinate_manager is None:
                    coordinate_manager = default_manager(
                        coordinates.shape[1] - 1, features.device, allocator_type,
                        minkowski_algorithm,
                    )
                coordinate_map_key, (unique_map, inverse_map) = (
                    coordinate_manager.insert_and_map(coordinates, tensor_stride)
                )
                self.unique_index = unique_map
                self.inverse_mapping = inverse_map
                features = quantize_features(
                    features, inverse_map, unique_map.shape[0], quantization_mode, unique_map
                )
        elif row_block is not None:
            lo, hi = row_block.bounds(coordinate_manager.size(coordinate_map_key))
            if features.shape[0] != hi - lo:
                raise ValueError(
                    f"features rows ({features.shape[0]}) != rows {lo}..{hi} of the "
                    f"row block of a {coordinate_manager.size(coordinate_map_key)}-row map"
                )
        elif features.shape[0] != coordinate_manager.size(coordinate_map_key):
            raise ValueError(
                f"features rows ({features.shape[0]}) != coordinate map size "
                f"({coordinate_manager.size(coordinate_map_key)})"
            )

        self._F = features
        self.coordinate_map_key = coordinate_map_key
        self._manager = coordinate_manager
        self.row_block = row_block

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
        """(N, D+1) int32 coordinates, batch first (a row block's rows)."""
        C = self._manager.get_coordinates(self.coordinate_map_key)
        if self.row_block is not None:
            lo, hi = self.row_block.bounds(C.shape[0])
            C = C[lo:hi]
        return C

    @property
    def features(self) -> torch.Tensor:
        return self.F

    @property
    def coordinates(self) -> torch.Tensor:
        return self.C

    @property
    def coordinate_map(self):
        """The manager's ``CoordinateMap`` at this tensor's key."""
        return self._manager.get_coordinate_map(self.coordinate_map_key)

    @property
    def device(self):
        return self._F.device

    @property
    def dimension(self) -> int:
        return self.D

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self._F.shape)

    @property
    def dtype(self):
        return self._F.dtype

    def __len__(self):
        return self.size

    @property
    def requires_grad(self) -> bool:
        return self._F.requires_grad

    def detach(self) -> "SparseTensor":
        return self._wrap(self._F.detach())

    # ------------------------------------------------------------------
    # batch decomposition (reference: MinkowskiTensor.py:277-423); rows
    # are batch-major, so each batch item is one run of rows
    # ------------------------------------------------------------------
    def _batch_runs(self) -> List[int]:
        whole_rows(self, "batch decomposition")
        _, counts = torch.unique_consecutive(self.C[:, 0], return_counts=True)
        return counts.tolist()

    @property
    def decomposed_coordinates(self) -> List[torch.Tensor]:
        """Per batch item present, in batch order, its (n_b, D) coordinates."""
        return list(torch.split(self.C[:, 1:], self._batch_runs()))

    @property
    def decomposed_features(self) -> List[torch.Tensor]:
        return list(torch.split(self._F, self._batch_runs()))

    @property
    def decomposed_coordinates_and_features(self):
        return self.decomposed_coordinates, self.decomposed_features

    def coordinates_at(self, batch_index: int) -> torch.Tensor:
        whole_rows(self, "coordinates_at")
        C = self.C
        return C[C[:, 0] == batch_index, 1:]

    def features_at(self, batch_index: int) -> torch.Tensor:
        whole_rows(self, "features_at")
        return self._F[(self.C[:, 0] == batch_index).to(self._F.device)]

    # ------------------------------------------------------------------
    # conversion (reference: MinkowskiSparseTensor.py:348-457)
    # ------------------------------------------------------------------
    def dense(self, shape=None, min_coordinate=None, contract_stride: bool = True):
        """Densify to (B, ch, *spatial), channels first as in the reference,
        on the features' device.  Returns (dense, min_coordinate (D,) int32,
        tensor_stride).  ``shape`` (B, ch, *spatial) fixes the size;
        ``min_coordinate`` the corner, which must not exceed any coordinate."""
        whole_rows(self, "dense")
        dev = self._F.device
        coords = self.C.to(dev)
        n = coords.shape[0]
        if min_coordinate is None:
            min_coordinate = (
                coords[:, 1:].amin(0) if n else torch.zeros(self.D, dtype=torch.int32, device=dev)
            )
        else:
            min_coordinate = torch.as_tensor(min_coordinate, device=dev).to(torch.int32)
            if (coords[:, 1:] < min_coordinate).any():
                raise ValueError("min_coordinate is larger than some coordinates")
        spatial = coords[:, 1:] - min_coordinate
        if contract_stride:
            ts = torch.tensor(self.tensor_stride, dtype=torch.int32, device=dev)
            spatial = torch.div(spatial, ts, rounding_mode="floor")
        batch = coords[:, 0].long()
        B = int(batch.max()) + 1 if n else 1
        if shape is not None:
            if len(shape) != self.D + 2:
                raise ValueError(f"shape must have {self.D + 2} entries (B, ch, *spatial)")
            B = max(B, int(shape[0]))
            sp_shape = tuple(int(s) for s in shape[2:])
        else:
            sp_shape = tuple(int(s) + 1 for s in spatial.amax(0)) if n else (1,) * self.D
        dense = self._F.new_zeros((B, self._F.shape[1]) + sp_shape)
        spatial = spatial.long()
        dense[(batch, slice(None)) + tuple(spatial[:, d] for d in range(self.D))] = self._F
        return dense, min_coordinate, self.tensor_stride

    def sparse(self, min_coords=None, max_coords=None, contract_coords: bool = True):
        """Export as ``(torch.sparse_coo_tensor, min_coords, tensor_stride)``,
        a hybrid COO tensor of shape (B, *spatial, ch), the reference's
        format.  ``min_coords`` and ``max_coords`` (inclusive) fix the window
        and must be divisible by the tensor stride; ``contract_coords``
        divides the coordinates by it."""
        whole_rows(self, "sparse")
        dev = self._F.device
        coords = self.C.to(dev).long()
        ts = torch.tensor(self.tensor_stride, dtype=torch.int64, device=dev)
        spatial = coords[:, 1:]

        def window(value, name):
            c = torch.as_tensor(value, device=dev).to(torch.int64).reshape(-1)
            if c.numel() != self.D:
                raise ValueError(f"{name} must have {self.D} elements, got {c.numel()}")
            if (c % ts).any():
                kind = "minimum" if name == "min_coords" else "maximum"
                raise ValueError(f"The {kind} coordinates must be divisible by the tensor stride.")
            return c

        if min_coords is not None:
            min_c = window(min_coords, "min_coords")
        elif coords.shape[0]:
            min_c = spatial.amin(0)
        else:
            min_c = torch.zeros(self.D, dtype=torch.int64, device=dev)
        max_c = None if max_coords is None else window(max_coords, "max_coords")

        spatial = spatial - min_c
        if contract_coords:
            spatial = torch.div(spatial, ts, rounding_mode="floor")
            if max_c is not None:
                max_c = torch.div(max_c, ts, rounding_mode="floor")
            min_c = torch.div(min_c, ts, rounding_mode="floor")

        B = int(coords[:, 0].max()) + 1 if coords.shape[0] else 1
        if max_c is not None:
            sp_shape = tuple(int(s) for s in (max_c - min_c + 1))
        elif coords.shape[0]:
            sp_shape = tuple(int(s) + 1 for s in spatial.amax(0))
        else:
            sp_shape = (1,) * self.D
        indices = torch.cat([coords[:, :1], spatial], dim=1).T
        out = torch.sparse_coo_tensor(
            indices, self._F, (B,) + sp_shape + (self._F.shape[1],), check_invariants=True
        ).coalesce()
        return out, min_c.to(torch.int32), self.tensor_stride

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _wrap(self, features: torch.Tensor, key=None) -> "SparseTensor":
        """New SparseTensor with this coordinate structure (or ``key``) and
        row block."""
        return SparseTensor(
            features,
            coordinate_map_key=key or self.coordinate_map_key,
            coordinate_manager=self._manager,
            row_block=self.row_block,
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
            if self.row_block != other.row_block:
                raise ValueError("both SparseTensors must hold the same rows (row_block)")
            return self._wrap(op(self._F, other._F))
        whole_rows(self, "arithmetic across maps")
        with P.span("nn.union"):
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
        whole_rows(self, "slice")
        with P.span("nn.interpolate"):
            feats = take_rows(self._F, X.inverse_mapping(self.coordinate_map_key))
            return X._wrap(feats)

    def cat_slice(self, X):
        """``X``'s own features, then the sliced features, side by side."""
        from .tensor_field import TensorField

        if not isinstance(X, TensorField):
            raise TypeError("cat_slice requires a TensorField input")
        whole_rows(self, "cat_slice")
        with P.span("nn.interpolate"):
            sliced = take_rows(self._F, X.inverse_mapping(self.coordinate_map_key))
            return X._wrap(torch.cat([X.F, sliced], dim=1))

    def features_at_coordinates(self, query_coordinates) -> torch.Tensor:
        """(N, ch) features interpolated multilinearly at float query
        coordinates (N, D+1), batch first; a lattice corner absent from the
        map adds 0 (reference: MinkowskiSparseTensor.py:690-718)."""
        whole_rows(self, "features_at_coordinates")
        with P.span("nn.interpolate"):
            rows, weights = self._manager.interpolation_map_weight(
                self.coordinate_map_key, query_coordinates
            )
            return F.interpolate_features(self._F, rows, weights)

    def interpolate(self, X) -> torch.Tensor:
        """This tensor's features interpolated at a TensorField's points."""
        from .tensor_field import TensorField

        if not isinstance(X, TensorField):
            raise TypeError("interpolate requires a TensorField input")
        return self.features_at_coordinates(X.C)

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(size={self.size}, "
            f"channels={self._F.shape[1]}, "
            f"coordinate_map_key={self.coordinate_map_key}, "
            f"device={self.device})"
        )


def whole_rows(x, op: str) -> None:
    """Raise if ``x`` holds a row block (spatial execution): ``op`` needs
    every row of the cloud."""
    if getattr(x, "row_block", None) is not None:
        raise ValueError(
            f"{op} needs every row of the cloud, and this tensor holds one row block "
            "(spatial execution): gather the rows first (parallel.spatial.gather_rows)"
        )


def _invert_union_map(in_to_union: torch.Tensor, n_union: int) -> torch.Tensor:
    """Invert an injective row map: the source row of each union row, or -1.
    Absent rows are scattered to one spare slot past the end, which is
    dropped, so the inversion needs no host sync."""
    src = torch.arange(in_to_union.shape[0], dtype=torch.int32, device=in_to_union.device)
    tgt = torch.where(in_to_union >= 0, in_to_union.long(), n_union)
    out = torch.full((n_union + 1,), -1, dtype=torch.int32, device=in_to_union.device)
    return out.scatter_(0, tgt, src)[:n_union]
