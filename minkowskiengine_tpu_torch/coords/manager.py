"""CoordinateManager: the cache of coordinate maps and kernel maps.

Counterpart of the eager part of ``minkowskiengine_tpu/coords/manager.py``
(reference: src/coordinate_map_manager.hpp:87-565, .cpp:349-1414).  The
coordinate phase runs eagerly on the manager's device (the card unless
the caller passes ``device="cpu"``): each op sorts or searches packed
int64 keys and caches its result under the reference's cache keys
(``kernel_map_key_type``, src/types.hpp:183-192).  Maps hold exact row
counts.  Field maps (a TensorField's float coordinates), origin maps,
stride maps and field-to-sparse maps live beside the coordinate maps.

Every op that builds a map records itself in the oplog, in the JAX
package's form and order, so that ``replay`` can run the recipe again on a
new point cloud without the model (fresh-geometry training, see
``coords/geometry.py``).  Replay has three modes: sync (the eager ops),
deferred (each map at its ratcheted capacity floor with its count on the
device, then one host transfer reads every count and cuts the maps to
exact rows) and traced (no host sync at all: the caller reads
``traced_ok()`` with the counts, and ``CompiledReplayer`` captures the
whole replay in one CUDA graph).

Each map's bounding box is read in the same host transfer as its row count
(``_register_unique``, ``prune``).  From it the manager builds the map's
dense plan and row grid (``dense_plan``, ``ops/dense_conv.py``), recorded
in the oplog as JAX records it, and looks coordinates up in any map whose
grid holds at most ``_MAX_GRID_CELLS`` cells by one gather from the grid
(``_probe_grid_for``): kernel maps, stride maps, origin, union and
field-to-sparse maps, interpolation.  This holds on the CPU and on the
card, as in JAX; the maps equal the search's index for index.  Replay
carries the grid floors (each map's grid shape) as it carries the capacity
floors.  The JAX package's slab and join floors are TPU machinery and are
not carried over.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernel_generator import KernelRegion, region_offsets
from ..types import (
    GPUMemoryAllocatorType, MinkowskiAlgorithm, RegionType, as_tuple, resolve_device,
)
from ..utils import profiling as P
from . import keys as K
from .kernel_map import (
    KernelMap, build_kernel_map, build_stride_map, grid_lookup, stride_map_to_kernel_map,
)
from .lookup import find_rows
from .map import CoordinateFieldMap, CoordinateMap, PaddedCoordinateMap, bucket_capacity
from .serialize import (
    CURVES, MAX_DEPTH, Serialization, WindowPlan, build_window_plan, serialize_rows,
)
from .unique import unique_coordinates, unique_coordinates_padded
from ..ops.dense_conv import (
    DensePlan, bbox_values, build_dense_plan, build_dense_plan_traced, build_row_grid,
)

# row grids above this many cells leave their map to the key search (64 MB
# of int32 cells); the grids of real scans lie far below it
_MAX_GRID_CELLS = 1 << 24


class UntraceableReplay(RuntimeError):
    """A traced replay reached an op with no ratcheted floor, so its
    capacity is unknown: warm the replayer with a sync pass first."""


class CapacityFloorExceeded(RuntimeError):
    """A deferred or traced replay found more rows than a ratcheted floor
    holds; the sync replay runs instead and ratchets the floor."""


class CoordinateMapKey:
    """Handle of a coordinate map inside a manager: ``(tensor_stride, string id)``
    (reference: pybind/extern.hpp:744-765).  ``CoordinateMapKey(D)`` with an
    int is an unset key, for an op to fill (``set_key``)."""

    def __init__(self, tensor_stride_or_dim, string_id: str = ""):
        if isinstance(tensor_stride_or_dim, int):
            self._dimension = tensor_stride_or_dim
            self._key = None
        else:
            self.set_key(tensor_stride_or_dim, string_id)
            self._dimension = len(self._key[0])

    def is_key_set(self) -> bool:
        return self._key is not None

    def set_key(self, tensor_stride, string_id: str = ""):
        self._key = (tuple(int(t) for t in tensor_stride), string_id)

    def get_key(self) -> Tuple[Tuple[int, ...], str]:
        if self._key is None:
            raise RuntimeError("CoordinateMapKey is not set")
        return self._key

    def get_coordinate_size(self) -> int:
        """Columns of the map's coordinates: the batch index and D."""
        return self._dimension + 1

    def get_tensor_stride(self) -> Tuple[int, ...]:
        return self.get_key()[0]

    def __eq__(self, other):
        return (
            isinstance(other, CoordinateMapKey)
            and self._key is not None
            and self._key == other._key
        )

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        return f"CoordinateMapKey({self._key})"


def set_gpu_allocator(backend) -> None:
    """API-parity no-op (reference: MinkowskiCoordinateManager.py:46-72):
    PyTorch's caching allocator holds every tensor of the port."""


def set_memory_manager_backend(backend) -> None:
    """API-parity no-op (alias of ``set_gpu_allocator``)."""


def set_coordinate_map_type(map_type) -> None:
    """API-parity no-op (reference: MinkowskiCoordinateManager.py:75-97): one
    coordinate engine serves the CPU and the card."""


def region_offsets_for(
    region_type: RegionType,
    kernel_size: Tuple[int, ...],
    dilation: Tuple[int, ...],
    tensor_stride: Tuple[int, ...],
    custom_offsets: Optional[np.ndarray],
) -> np.ndarray:
    """Absolute offsets for a region at a tensor stride."""
    return region_offsets(
        RegionType(region_type), kernel_size, dilation, tensor_stride, custom_offsets
    )


def _quantize_field(field_coords: torch.Tensor, tensor_stride) -> torch.Tensor:
    """Float field coordinates → int32 voxel coordinates at ``tensor_stride``:
    ``floor(coord / stride) * stride``, divided in float32 as the JAX
    package's ``_quantize_field`` does (a float64 division would move points
    on voxel boundaries).  The batch column is truncated to int32."""
    with P.host_read("quantize_field.stride"):
        ts = torch.tensor(tensor_stride, dtype=torch.int32, device=field_coords.device)
    spatial = torch.floor(field_coords[:, 1:] / ts.to(field_coords.dtype)).to(torch.int32) * ts
    return torch.cat([field_coords[:, :1].to(torch.int32), spatial], dim=1)


def _interp_corner_coords(samples: torch.Tensor, tensor_stride):
    """(2^D, N, D+1) int32 lattice corners of float samples and their (2^D,
    N) multilinear weights, corners in ``itertools.product((0, 1),
    repeat=D)`` order.  The same float32 operations in the same order as
    the JAX package's ``_interp_corner_coords``: ``p = x / stride``,
    ``floor``, ``frac = p - floor``, corner ``(floor + bit) * stride``
    truncated to int32; the batch column is truncated too."""
    D = samples.shape[1] - 1
    dev = samples.device
    with P.host_read("interp.stride"):
        ts = torch.tensor(tensor_stride, dtype=torch.float32, device=dev)
    with P.host_read("interp.corners"):
        corners = torch.tensor(
            list(itertools.product((0, 1), repeat=D)), dtype=torch.float32, device=dev
        )
    p = samples[:, 1:] / ts
    base = torch.floor(p)
    frac = p - base
    corner_pos = base[None, :, :] + corners[:, None, :]
    batch = samples[:, :1].to(torch.int32).expand(len(corners), -1, -1)
    coords = torch.cat([batch, (corner_pos * ts).to(torch.int32)], dim=-1)
    w = torch.where(corners[:, None, :] == 1, frac[None, :, :], 1.0 - frac[None, :, :])
    return coords, w.prod(dim=-1)


def _overflow_message(D: int) -> str:
    (blo, bhi), (lo, hi) = K.field_ranges(D)[:2]
    return (
        f"Coordinate out of packed-key range for dimension {D}: the batch index "
        f"must lie in [{blo}, {bhi}] and each coordinate in [{lo}, {hi}] "
        "(coords/keys.py field_ranges)"
    )


def _origin_coords(coords: torch.Tensor) -> torch.Tensor:
    """(b, 0, ..., 0) for every row."""
    out = torch.zeros_like(coords)
    out[:, 0] = coords[:, 0]
    return out


class CoordinateManager:
    """Caches coordinate maps and kernel maps on ``device`` (default: the
    CUDA card; ``device="cpu"`` for the CPU).

    The reference's backend keywords (MinkowskiCoordinateManager.py:107-160)
    are taken as the JAX package takes them: ``num_threads``, and
    ``coordinate_map_type``, ``allocator_type`` and ``minkowski_algorithm``
    (default ``MinkowskiAlgorithm.DEFAULT``), which are kept as attributes.
    None of them selects anything: the port has one coordinate engine and
    one allocator, torch's."""

    def __init__(
        self,
        D: int = 0,
        num_threads: int = -1,
        coordinate_map_type=None,
        allocator_type: Optional[GPUMemoryAllocatorType] = None,
        minkowski_algorithm: Optional[MinkowskiAlgorithm] = None,
        device=None,
    ):
        if D < 1:
            raise ValueError(f"Invalid dimension {D}")
        self.D = int(D)
        self.coordinate_map_type = coordinate_map_type
        self.allocator_type = allocator_type
        self.minkowski_algorithm = (
            MinkowskiAlgorithm.DEFAULT if minkowski_algorithm is None else minkowski_algorithm
        )
        self.device = resolve_device(device)
        self._maps: Dict[Tuple[Tuple[int, ...], str], CoordinateMap] = {}
        self._field_maps: Dict[Tuple[Tuple[int, ...], str], CoordinateFieldMap] = {}
        self._kernel_maps: Dict[tuple, KernelMap] = {}
        # stride maps, origin maps and origin field maps: row maps by key pair
        self._stride_maps: Dict[tuple, torch.Tensor] = {}
        self._origin_keys: Dict[tuple, CoordinateMapKey] = {}
        # (field key, sparse key) -> sparse row of each field row
        self._field_to_sparse: Dict[tuple, torch.Tensor] = {}
        self._id_counter = itertools.count()
        # the coordinate-op recipe (geometry replay); a frozen view
        # (from_geometry) builds nothing
        self._oplog: List[tuple] = []
        self._frozen = False
        self._entry_key: Optional[CoordinateMapKey] = None
        # (unique_map, inverse_map) of each inserted map, for reduce_features
        self._insert_results: Dict[tuple, tuple] = {}
        # ratchets carried across replays: the largest capacity bucket seen
        # for each map (by (tensor_stride, string id)), and the most inputs
        # per voxel of each pooling fast-path map (by ("kmax", cache key))
        self._cap_floors: Dict[tuple, int] = {}
        # the grid shape of each map's dense plan, ratcheted the same way
        self._grid_floors: Dict[tuple, tuple] = {}
        self._overprovision = 1.0  # > 1 while recovering from a violated floor
        self._deferred: Optional[dict] = None  # deferred/traced replay state
        # per map: its host bbox (read with its row count), its dense plan
        # (None for an empty map) and its row grid
        self._bboxes: Dict[tuple, np.ndarray] = {}
        self._dense_plans: Dict[tuple, Optional[DensePlan]] = {}
        self._row_grids: Dict[tuple, torch.Tensor] = {}
        # serialized attention: each map's rows along a curve, by (map, curve);
        # its scenes' row offsets (device, host) and curve depth, by map; its
        # window plans, by (map, curve, window size)
        self._serializations: Dict[tuple, Serialization] = {}
        self._scene_offsets: Dict[tuple, tuple] = {}
        self._window_plans: Dict[tuple, WindowPlan] = {}

    def _record(self, *entry) -> None:
        if not self._frozen:
            self._oplog.append(entry)

    def _check_not_frozen(self, what: str) -> None:
        if self._frozen:
            raise RuntimeError(
                f"cannot build {what}: this manager is a frozen Geometry view; "
                "the op was not in the recorded coordinate phase (re-run the "
                "eager forward to record it)"
            )

    def oplog(self) -> List[tuple]:
        """The recorded coordinate-op recipe (see coords/geometry.py)."""
        return list(self._oplog)

    def _ratchet(self, floor_key: tuple, n: int) -> None:
        """Raise a map's capacity floor to the bucket of ``n`` rows (times
        the over-provision while recovering)."""
        cap = bucket_capacity(math.ceil(n * self._overprovision))
        self._cap_floors[floor_key] = max(self._cap_floors.get(floor_key, 0), cap)

    # ------------------------------------------------------------------
    # map bookkeeping
    # ------------------------------------------------------------------
    def _unique_string_id(
        self, tensor_stride: Tuple[int, ...], string_id: str, field: bool = False
    ) -> str:
        """First free string id.  Field maps and coordinate maps have
        separate key spaces, as in the JAX package (a field map and the
        sparse map it quantizes to share ``(stride, "")``); both draw from
        one counter, so a second quantization of a field gets ``map-N``."""
        taken = self._field_maps if field else self._maps
        sid = string_id
        while (tensor_stride, sid) in taken:
            sid = f"{string_id or 'map'}-{next(self._id_counter)}"
        return sid

    def _get_map(self, key: CoordinateMapKey) -> CoordinateMap:
        k = key.get_key()
        if k not in self._maps:
            raise KeyError(f"Coordinate map {k} not found in manager")
        return self._maps[k]

    def _get_field_map(self, key: CoordinateMapKey) -> CoordinateFieldMap:
        k = key.get_key()
        if k not in self._field_maps:
            raise KeyError(f"Coordinate field map {k} not found in manager")
        return self._field_maps[k]

    def exists(self, key: CoordinateMapKey) -> bool:
        return key.is_key_set() and key.get_key() in self._maps

    def size(self, key: CoordinateMapKey) -> int:
        return self._get_map(key).size

    def get_coordinate_map(self, key: CoordinateMapKey) -> CoordinateMap:
        return self._get_map(key)

    def get_keys(self):
        """The ``(tensor_stride, string_id)`` of every coordinate map, in
        insertion order."""
        return list(self._maps.keys())

    def clear(self):
        """Drop every map, kernel map and row map this manager holds."""
        self._maps.clear()
        self._field_maps.clear()
        self._kernel_maps.clear()
        self._stride_maps.clear()
        self._origin_keys.clear()
        self._field_to_sparse.clear()
        self._insert_results.clear()
        self._bboxes.clear()
        self._dense_plans.clear()
        self._row_grids.clear()
        self._serializations.clear()
        self._scene_offsets.clear()
        self._window_plans.clear()

    def get_coordinates(self, key: CoordinateMapKey) -> torch.Tensor:
        return self._get_map(key).coordinates

    def get_coordinate_field(self, key: CoordinateMapKey) -> torch.Tensor:
        return self._get_field_map(key).coordinates

    def _find_rows_in(
        self, key: CoordinateMapKey, coords: torch.Tensor, valid=None
    ) -> torch.Tensor:
        """Row of each integer query coordinate in a map, or -1 (int32); -1
        too where ``valid`` is false.  One gather from the map's row grid
        when it has one, else a search of its sorted keys."""
        pg = self._probe_grid_for(key)
        if pg is not None:
            rows = grid_lookup(*pg, coords)
            return rows if valid is None else rows.masked_fill_(~valid, -1)
        rows = find_rows(self._get_map(key).keys, K.pack(coords))
        invalid = K.overflow_mask(coords)
        if valid is not None:
            invalid |= ~valid
        return rows.masked_fill_(invalid, -1)

    def __repr__(self):
        lines = [f"CoordinateManager(D={self.D}, device={self.device})"]
        for k, m in self._maps.items():
            lines.append(f"  map {k}: size={m.size}")
        lines.append(f"  kernel maps: {len(self._kernel_maps)}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # insertion
    # ------------------------------------------------------------------
    def _register_unique(
        self,
        coords: torch.Tensor,
        tensor_stride: Tuple[int, ...],
        string_id: str,
        valid: Optional[torch.Tensor] = None,
    ):
        """Unique the rows of ``coords`` where ``valid`` (all rows when None)
        into a new registered map.

        Returns (key, unique_map, inverse_map).  In a deferred or traced
        replay, a map with a capacity floor is built at that capacity with
        its count on the device (``PaddedCoordinateMap``) and both maps are
        padded (see ``unique_padded``).
        """
        self._check_not_frozen("a coordinate map")
        with P.span("coords.unique"):
            tensor_stride = tuple(tensor_stride)
            sid = self._unique_string_id(tensor_stride, string_id)
            key = CoordinateMapKey(tensor_stride, sid)
            d = self._deferred
            if d is not None and key.get_key() in self._cap_floors:
                if valid is None:
                    valid = torch.ones(coords.shape[0], dtype=torch.bool, device=coords.device)
                res, u_coords, overflow = unique_coordinates_padded(
                    coords, valid, self._cap_floors[key.get_key()]
                )
                cmap = PaddedCoordinateMap(u_coords, res.sorted_keys, tensor_stride, res.count)
                self._maps[key.get_key()] = cmap
                d["maps"].append((key.get_key(), overflow))
                d["bboxes"][key.get_key()] = bbox_values(u_coords, cmap.valid_mask()).view(2, -1)
                return key, res.unique_map, res.inverse_map
            if d is not None and d["traced"]:
                raise UntraceableReplay(
                    f"no capacity floor for map {key.get_key()}; warm the replayer "
                    "with a sync pass first"
                )
            if valid is not None:
                with P.host_read("register_unique.mask"):
                    coords = coords[valid]
            res, u_coords, overflow = unique_coordinates(coords)
            # the overflow flag and the bbox in one transfer
            values = torch.cat([overflow.reshape(1).to(torch.int64), bbox_values(u_coords)])
            with P.host_read("register_unique.bbox"):
                values = values.tolist()
            if values[0]:
                raise ValueError(_overflow_message(self.D))
            self._bboxes[key.get_key()] = np.asarray(values[1:]).reshape(2, -1)
            self._maps[key.get_key()] = CoordinateMap(u_coords, res.sorted_keys, tensor_stride)
            self._ratchet(key.get_key(), u_coords.shape[0])
            return key, res.unique_map, res.inverse_map

    def insert_and_map(self, coordinates, tensor_stride=1, string_id: str = "", n_valid=None):
        """Insert coordinates, returning (key, (unique_map, inverse_map)).

        Reference: CoordinateMapManager::insert_and_map
        (src/coordinate_map_manager.cpp:349-399);
        ``coords[unique_map][inverse_map] == coords``.  Records the insert
        (the first one is the geometry's entry key).

        ``n_valid``: a 0-d device tensor, the count of valid leading rows
        when ``coordinates`` is padded to a fixed bucket (the traced
        replay's calling convention); the maps are then padded too.
        """
        with P.coords_call("insert_and_map"):
            ts = as_tuple(tensor_stride, self.D)
            coords = torch.as_tensor(coordinates, device=self.device).to(torch.int32)
            if coords.ndim != 2 or coords.shape[1] != self.D + 1:
                raise ValueError(
                    f"coordinates must be (N, {self.D + 1}), got {tuple(coords.shape)}"
                )
            valid = None
            if n_valid is not None:
                valid = torch.arange(coords.shape[0], device=coords.device) < n_valid
            key, unique_map, inverse_map = self._register_unique(coords, ts, string_id, valid)
            self._record("insert", ts, string_id, key.get_key())
            if self._entry_key is None:
                self._entry_key = key
            self._insert_results[key.get_key()] = (unique_map, inverse_map)
            if self._deferred is not None:
                self._deferred["inserts"].append((key.get_key(), n_valid))
            return key, (unique_map, inverse_map)

    def insert_field(self, coordinates, tensor_stride=1, string_id: str = "") -> CoordinateMapKey:
        """Insert continuous coordinates, the store behind a TensorField
        (reference: insert_field, src/coordinate_map_manager.cpp:139-186)."""
        with P.coords_call("insert_field"):
            self._check_not_frozen("a coordinate field map")
            ts = as_tuple(tensor_stride, self.D)
            coords = torch.as_tensor(coordinates, device=self.device).to(torch.float32)
            if coords.ndim != 2 or coords.shape[1] != self.D + 1:
                raise ValueError(
                    f"coordinates must be (N, {self.D + 1}), got {tuple(coords.shape)}"
                )
            sid = self._unique_string_id(ts, string_id, field=True)
            key = CoordinateMapKey(ts, sid)
            self._field_maps[key.get_key()] = CoordinateFieldMap(coords, ts)
            return key

    # ------------------------------------------------------------------
    # derived maps
    # ------------------------------------------------------------------
    def stride(self, key: CoordinateMapKey, stride, string_id: str = "") -> CoordinateMapKey:
        """Strided (downsampled) coordinate map: coordinates are floor-divided
        then re-multiplied (reference: src/coordinate_map.hpp:58-76)."""
        in_map = self._get_map(key)
        s = as_tuple(stride, self.D)
        if all(x == 1 for x in s):
            return key
        out_ts = tuple(t * st for t, st in zip(in_map.tensor_stride, s))
        # derived maps inherit the input's lineage id, so the decoder's
        # transposed convs land back on the encoder's maps
        sid = string_id or key.get_key()[1]
        if (out_ts, sid) in self._maps:
            return CoordinateMapKey(out_ts, sid)
        with P.coords_call("stride"):
            c = in_map.coordinates
            ts = K.device_constant(out_ts, torch.int32, c.device)
            spatial = torch.div(c[:, 1:], ts, rounding_mode="floor") * ts
            strided = torch.cat([c[:, :1], spatial], dim=1)
            new_key, _, _ = self._register_unique(strided, out_ts, sid, in_map.valid_mask())
            self._record("stride", key.get_key(), s, string_id)
            return new_key

    def stride_region(
        self,
        key: CoordinateMapKey,
        region: KernelRegion,
        out_tensor_stride,
        expand_coordinates: bool,
        is_transpose: bool,
        string_id: str = "",
    ) -> CoordinateMapKey:
        """Region-expanded coordinate map (reference: src/coordinate_map_cpu.hpp:446-487).

        Candidates are ``coords ⊕ offsets``; non-transpose keeps only those
        aligned to the output tensor stride.  When a map already exists at
        the output stride and ``expand_coordinates`` is False, that map is
        reused: this is how a UNet's transposed convs land back on the
        encoder's coordinates.
        """
        out_ts = as_tuple(out_tensor_stride, self.D)
        sid = string_id or key.get_key()[1]
        if (out_ts, sid) in self._maps and not expand_coordinates:
            return CoordinateMapKey(out_ts, sid)
        with P.coords_call("stride_region"):
            in_map = self._get_map(key)
            c = in_map.coordinates
            offs = np.zeros((region.volume, self.D + 1), np.int32)
            offs[:, 1:] = region.offsets
            offs = K.device_constant(offs, torch.int32, c.device)
            cand = (c[None, :, :] + offs[:, None, :]).reshape(-1, self.D + 1)
            valid = in_map.valid_mask()
            if valid is not None:
                valid = valid.repeat(region.volume)
            if not is_transpose:
                ts = K.device_constant(out_ts, torch.int32, c.device)
                aligned = torch.all(torch.remainder(cand[:, 1:], ts) == 0, dim=1)
                valid = aligned if valid is None else valid & aligned
            new_key, _, _ = self._register_unique(cand, out_ts, sid, valid)
            self._record(
                "stride_region", key.get_key(), int(region.region_type), region.offsets.tobytes(),
                region.offsets.shape, out_ts, bool(expand_coordinates), bool(is_transpose),
                string_id,
            )
            return new_key

    def origin(self, key: CoordinateMapKey) -> CoordinateMapKey:
        """Map of the per-batch origins (b, 0, ..., 0) (reference: origin,
        src/coordinate_map_cpu.hpp:492-513)."""
        k = key.get_key()
        if k not in self._origin_keys:
            with P.coords_call("origin"):
                in_map = self._get_map(key)
                self._origin_keys[k], _, _ = self._register_unique(
                    _origin_coords(in_map.coordinates), (1,) * self.D, f"origin-{k[1]}",
                    in_map.valid_mask(),
                )
                self._record("origin", k)
        return self._origin_keys[k]

    def origin_field(self, key: CoordinateMapKey) -> CoordinateMapKey:
        """Origin map of a field map: the batch indices of its float rows."""
        k = key.get_key()
        cache_k = (k, "field-origin")
        if cache_k not in self._origin_keys:
            with P.coords_call("origin_field"):
                ocoords = _origin_coords(self._get_field_map(key).coordinates.to(torch.int32))
                self._origin_keys[cache_k], _, _ = self._register_unique(
                    ocoords, (1,) * self.D, f"origin-field-{k[1]}"
                )
        return self._origin_keys[cache_k]

    def origin_map(self, key: CoordinateMapKey) -> Tuple[CoordinateMapKey, torch.Tensor]:
        """(origin key, (N,) int32 origin row of each row): the batch segment
        id that global pooling and instance norm reduce over (reference:
        origin_map, src/coordinate_map_cpu.hpp:724-783)."""
        origin_key = self.origin(key)
        ck = (key.get_key(), origin_key.get_key())
        if ck not in self._stride_maps:
            self._check_not_frozen("an origin map")
            with P.coords_call("origin_map"):
                in_map = self._get_map(key)
                self._stride_maps[ck] = self._find_rows_in(
                    origin_key, _origin_coords(in_map.coordinates), in_map.valid_mask()
                )
                self._record("origin_map", key.get_key())
        return origin_key, self._stride_maps[ck]

    def origin_field_map(self, key: CoordinateMapKey) -> Tuple[CoordinateMapKey, torch.Tensor]:
        """``origin_map`` for a field map; the float batch column is cast to
        int32 (reference: src/global_pooling_cpu.cpp:72-85)."""
        origin_key = self.origin_field(key)
        ck = (key.get_key(), "field", origin_key.get_key())
        if ck not in self._stride_maps:
            self._check_not_frozen("an origin map")
            with P.coords_call("origin_field_map"):
                coords = self._get_field_map(key).coordinates.to(torch.int32)
                self._stride_maps[ck] = self._find_rows_in(origin_key, _origin_coords(coords))
        return origin_key, self._stride_maps[ck]

    def number_of_unique_batch_indices(self, key: CoordinateMapKey) -> int:
        return self._get_map(self.origin(key)).size

    # ------------------------------------------------------------------
    # pruning and union
    # ------------------------------------------------------------------
    def prune(
        self, key: CoordinateMapKey, keep: torch.Tensor
    ) -> Tuple[CoordinateMapKey, torch.Tensor, torch.Tensor]:
        """The map's rows where ``keep`` is true, in their sorted order
        (reference: prune, src/coordinate_map_cpu.hpp:519-536).

        Returns (new key, in_to_out, out_from_in): ``in_to_out`` (N_in,)
        int32 is the new row of each old row, or -1 if dropped;
        ``out_from_in`` (n_kept,) int32 the old row of each new row, the
        gather map of the feature copy.  The new map's string id is
        ``pruned``, or ``pruned-N`` where that is taken, as in JAX.
        """
        with P.coords_call("prune"):
            self._check_not_frozen("a pruned map")
            in_map = self._get_map(key)
            keep = torch.as_tensor(keep, device=in_map.device).to(torch.bool)
            if keep.shape != (in_map.size,):
                raise ValueError(f"keep mask of shape {tuple(keep.shape)} for {in_map.size} rows")
            n = in_map.size
            in_to_out = torch.where(
                keep, torch.cumsum(keep, 0, dtype=torch.int32) - 1, -1
            ).to(torch.int32)
            # the kept count and the kept rows' bbox in one transfer
            values = torch.cat([keep.sum().reshape(1), bbox_values(in_map.coordinates, keep)])
            with P.host_read("prune.counts"):
                values = values.tolist()
            n_kept = values[0]
            tgt = torch.where(keep, in_to_out, n_kept).long()
            rows = torch.arange(n, dtype=torch.int32, device=keep.device)
            out_from_in = rows.new_empty(n_kept + 1).scatter_(0, tgt, rows)[:n_kept]
            sid = self._unique_string_id(in_map.tensor_stride, "pruned")
            new_key = CoordinateMapKey(in_map.tensor_stride, sid)
            self._maps[new_key.get_key()] = CoordinateMap(
                in_map.coordinates[out_from_in.long()],
                K.gather_keys(in_map.keys, out_from_in.long()),
                in_map.tensor_stride,
            )
            self._bboxes[new_key.get_key()] = np.asarray(values[1:]).reshape(2, -1)
            return new_key, in_to_out, out_from_in

    def merge(self, keys) -> CoordinateMapKey:
        """The union of several maps' coordinates, all at one tensor stride,
        as a new map with string id ``merged`` (or ``merged-N``)
        (reference: merge, src/coordinate_map_cpu.hpp:538-564)."""
        with P.coords_call("merge"):
            maps = [self._get_map(k) for k in keys]
            ts = maps[0].tensor_stride
            if any(m.tensor_stride != ts for m in maps):
                raise ValueError("merge requires identical tensor strides")
            coords = torch.cat([m.coordinates for m in maps], dim=0)
            masks = [m.valid_mask() for m in maps]
            valid = None
            if any(v is not None for v in masks):
                valid = torch.cat([
                    torch.ones(m.rows, dtype=torch.bool, device=m.device) if v is None else v
                    for m, v in zip(maps, masks)
                ])
            new_key, _, _ = self._register_unique(coords, ts, "merged", valid)
            self._record("merge", tuple(k.get_key() for k in keys))
            return new_key

    def union_map(self, in_keys, out_key: CoordinateMapKey):
        """Per input map, the (N_i,) int32 row of each of its rows in the
        union map ``out_key``, -1 where absent (reference: union_map,
        src/coordinate_map_cpu.hpp:842-873)."""
        with P.coords_call("union_map"):
            return [self._find_rows_in(out_key, self._get_map(k).coordinates) for k in in_keys]

    # ------------------------------------------------------------------
    # field → sparse
    # ------------------------------------------------------------------
    def field_to_sparse_insert_and_map(
        self, field_key: CoordinateMapKey, sparse_tensor_stride, sparse_string_id: str = ""
    ) -> Tuple[CoordinateMapKey, Tuple[torch.Tensor, torch.Tensor]]:
        """Quantize a field map into a new sparse map; returns
        (sparse key, (unique_map, inverse_map)) (reference:
        src/coordinate_map_manager.cpp:193-266)."""
        with P.coords_call("field_to_sparse_insert_and_map"):
            ts = as_tuple(sparse_tensor_stride, self.D)
            qcoords = _quantize_field(self._get_field_map(field_key).coordinates, ts)
            sparse_key, unique_map, inverse_map = self._register_unique(
                qcoords, ts, sparse_string_id
            )
            inverse_map = inverse_map.to(torch.int32)
            self._field_to_sparse[(field_key.get_key(), sparse_key.get_key())] = inverse_map
            return sparse_key, (unique_map, inverse_map)

    def exists_field_to_sparse(self, field_key: CoordinateMapKey, sparse_key: CoordinateMapKey) -> bool:
        return (field_key.get_key(), sparse_key.get_key()) in self._field_to_sparse

    def field_to_sparse_map(self, field_key: CoordinateMapKey, sparse_key: CoordinateMapKey) -> torch.Tensor:
        """(N_field,) sparse row of each field row, or -1 where the field
        row's voxel is not in the sparse map."""
        ck = (field_key.get_key(), sparse_key.get_key())
        if ck not in self._field_to_sparse:
            self._check_not_frozen("a field-to-sparse map")
            with P.coords_call("field_to_sparse_map"):
                smap = self._get_map(sparse_key)
                qcoords = _quantize_field(
                    self._get_field_map(field_key).coordinates, smap.tensor_stride
                )
                self._field_to_sparse[ck] = self._find_rows_in(sparse_key, qcoords)
        return self._field_to_sparse[ck]

    # ------------------------------------------------------------------
    # interpolation
    # ------------------------------------------------------------------
    def interpolation_map_weight(
        self, key: CoordinateMapKey, samples
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Multilinear neighbour rows and weights of float samples (N, D+1),
        batch first, in the map at ``key``: (rows (N, 2^D) int32, -1 for a
        corner absent from the map; weights (N, 2^D) float32, 0 there).
        Built without autograd: gradients reach features only (reference:
        interpolation_map_weight, src/coordinate_map_cpu.hpp:138-273)."""
        with P.coords_call("interpolation_map_weight"):
            cmap = self._get_map(key)
            samples = torch.as_tensor(samples, device=self.device).to(torch.float32)
            with torch.no_grad():
                coords, w = _interp_corner_coords(samples, cmap.tensor_stride)
                rows = self._find_rows_in(key, coords)
                w = torch.where(rows >= 0, w, 0.0)
            return rows.T.contiguous(), w.T.contiguous()

    # ------------------------------------------------------------------
    # kernel maps
    # ------------------------------------------------------------------
    def _kernel_map_cache_key(
        self, in_key, out_key, stride, kernel_size, dilation,
        region_type, region_offsets, is_transpose, is_pool,
    ):
        off_key = (
            None
            if region_offsets is None or np.size(region_offsets) == 0
            else np.asarray(region_offsets, np.int32).tobytes()
        )
        return (
            in_key.get_key(),
            out_key.get_key(),
            as_tuple(kernel_size, self.D),
            as_tuple(stride, self.D),
            as_tuple(dilation, self.D),
            int(region_type),
            bool(is_transpose),
            bool(is_pool),
            off_key,
        )

    def has_kernel_map(
        self,
        in_key: CoordinateMapKey,
        out_key: CoordinateMapKey,
        stride=1,
        kernel_size=3,
        dilation=1,
        region_type: RegionType = RegionType.HYPER_CUBE,
        region_offsets: Optional[np.ndarray] = None,
        is_transpose: bool = False,
        is_pool: bool = False,
    ) -> bool:
        """Whether this kernel map is cached (nothing is built)."""
        return self.peek_kernel_map(
            in_key, out_key, stride, kernel_size, dilation,
            region_type, region_offsets, is_transpose, is_pool,
        ) is not None

    def peek_kernel_map(
        self,
        in_key: CoordinateMapKey,
        out_key: CoordinateMapKey,
        stride=1,
        kernel_size=3,
        dilation=1,
        region_type: RegionType = RegionType.HYPER_CUBE,
        region_offsets: Optional[np.ndarray] = None,
        is_transpose: bool = False,
        is_pool: bool = False,
    ) -> Optional[KernelMap]:
        """The cached kernel map, or None (never builds)."""
        return self._kernel_maps.get(self._kernel_map_cache_key(
            in_key, out_key, stride, kernel_size, dilation,
            region_type, region_offsets, is_transpose, is_pool,
        ))

    def kernel_map_dict(
        self,
        in_key: CoordinateMapKey,
        out_key: CoordinateMapKey,
        stride=1,
        kernel_size=3,
        dilation=1,
        region_type: RegionType = RegionType.HYPER_CUBE,
        region_offsets: Optional[np.ndarray] = None,
        is_transpose: bool = False,
        is_pool: bool = False,
    ):
        """The kernel map as ``{offset: (in_rows, out_rows)}`` (int64 numpy;
        offsets without a pair are left out), the reference's
        ``kernel_map_th`` format (src/coordinate_map_manager.cpp:1358).
        Always keyed by kernel offsets: a pooling request is built as the
        per-offset map, not as the stride-map fast path, whose rows are
        collision slots."""
        return self.kernel_map(
            in_key, out_key, stride, kernel_size, dilation,
            region_type, region_offsets, is_transpose, is_pool=False,
        ).to_pair_lists()

    def kernel_map(
        self,
        in_key: CoordinateMapKey,
        out_key: CoordinateMapKey,
        stride=1,
        kernel_size=3,
        dilation=1,
        region_type: RegionType = RegionType.HYPER_CUBE,
        region_offsets: Optional[np.ndarray] = None,
        is_transpose: bool = False,
        is_pool: bool = False,
    ) -> KernelMap:
        """Fetch or build the dense kernel map between two maps.

        Cache key and dispatch follow the reference manager
        (src/coordinate_map_manager.cpp:664-823): a transpose request reuses
        the swapped forward map when it is cached.
        """
        cache_key = self._kernel_map_cache_key(
            in_key, out_key, stride, kernel_size, dilation,
            region_type, region_offsets, is_transpose, is_pool,
        )
        if cache_key in self._kernel_maps:
            return self._kernel_maps[cache_key]
        with P.coords_call("kernel_map"):
            self._check_not_frozen("a kernel map")
            _, _, ks, s, dil, _, _, _, off_key = cache_key
            fast_pool = is_pool and s == ks and off_key is None
            in_map = self._get_map(in_key)
            out_map = self._get_map(out_key)
            if not is_transpose:
                if fast_pool:
                    kmap = self._pool_kernel_map(
                        self.stride_map(in_key, out_key), in_map.rows, out_map.rows, cache_key
                    )
                else:
                    offs = region_offsets_for(
                        region_type, ks, dil, in_map.tensor_stride, region_offsets
                    )
                    pg = self._probe_grid_for(in_key)
                    pg_out = self._probe_grid_for(out_key)
                    kmap = build_kernel_map(in_map, out_map, offs, probe=pg, probe_out=pg_out)
            else:
                swapped_key = (
                    out_key.get_key(), in_key.get_key(), ks, s, dil,
                    int(region_type), False, bool(is_pool), off_key,
                )
                if swapped_key in self._kernel_maps:
                    kmap = self._kernel_maps[swapped_key].swap()
                elif fast_pool:
                    kmap = self._pool_kernel_map(
                        self.stride_map(out_key, in_key), out_map.rows, in_map.rows, cache_key
                    ).swap()
                else:
                    # build out→in with offsets at the *output's* (finer)
                    # stride, then swap (src/coordinate_map_manager.cpp:759-813)
                    offs = region_offsets_for(
                        region_type, ks, dil, out_map.tensor_stride, region_offsets
                    )
                    pg = self._probe_grid_for(out_key)  # the probed (first) map
                    pg_out = self._probe_grid_for(in_key)
                    kmap = build_kernel_map(
                        out_map, in_map, offs, probe=pg, probe_out=pg_out
                    ).swap()
            self._kernel_maps[cache_key] = kmap
            self._record(
                "kernel_map", in_key.get_key(), out_key.get_key(), s, ks, dil, int(region_type),
                None if off_key is None else (off_key, np.asarray(region_offsets, np.int32).shape),
                bool(is_transpose), bool(is_pool),
            )
            return kmap

    def _pool_kernel_map(self, in_to_out, n_in: int, n_out: int, cache_key) -> KernelMap:
        """The pooling fast path's map (``stride_map_to_kernel_map``), with
        ``Kmax`` from its floor in a deferred or traced replay."""
        with P.span("coords.pool_map"):
            floor_key = ("kmax", cache_key)
            d = self._deferred
            if d is not None and floor_key in self._cap_floors:
                kmap, max_rank = stride_map_to_kernel_map(
                    in_to_out, n_in, n_out, self._cap_floors[floor_key]
                )
                d["kmax"].append((cache_key, max_rank))
                return kmap
            if d is not None and d["traced"]:
                raise UntraceableReplay(f"no Kmax floor for pooling map {cache_key[:2]}")
            kmap, _ = stride_map_to_kernel_map(in_to_out, n_in, n_out)
            self._cap_floors[floor_key] = max(
                self._cap_floors.get(floor_key, 0), kmap.kernel_volume
            )
            return kmap

    def stride_map(self, in_key: CoordinateMapKey, out_key: CoordinateMapKey) -> torch.Tensor:
        """(N_in,) int32 output row of each input row, cached (the pooling
        fast path's map; reference: src/coordinate_map_cpu.hpp:672-722)."""
        ck = (in_key.get_key(), out_key.get_key())
        if ck not in self._stride_maps:
            self._check_not_frozen("a stride map")
            with P.coords_call("stride_map"):
                out_map = self._get_map(out_key)
                self._stride_maps[ck] = build_stride_map(
                    self._get_map(in_key), out_map, out_map.tensor_stride,
                    probe=self._probe_grid_for(out_key),
                )
                self._record("stride_map", in_key.get_key(), out_key.get_key())
        return self._stride_maps[ck]

    # ------------------------------------------------------------------
    # serialization (coords/serialize.py)
    # ------------------------------------------------------------------
    def serialize(self, key: CoordinateMapKey, orders=CURVES) -> List[Serialization]:
        """The map's rows along each curve of ``orders``, each built once and
        cached under the map's key.  The first call on a map reads its
        scenes' row offsets (one host read, ``sync.serialize.offsets``); the
        curves' depth comes from the bbox read with the map's row count."""
        k = key.get_key()
        missing = [c for c in dict.fromkeys(orders) if (k, c) not in self._serializations]
        if missing:
            with P.coords_call("serialize"):
                m = self._get_map(key)
                if k not in self._scene_offsets:
                    self._scene_offsets[k] = self._offsets_and_depth(key)
                depth = self._scene_offsets[k][2]
                for c in missing:
                    self._serializations[(k, c)] = serialize_rows(
                        m.coordinates, m.tensor_stride, depth, c)
        return [self._serializations[(k, c)] for c in orders]

    def _offsets_and_depth(self, key: CoordinateMapKey):
        """(offsets on the device, the same on the host, curve depth): the
        first row of each scene and the end, and the bit length of the
        largest grid coordinate."""
        if self.D != 3:
            raise ValueError(f"serialization orders 3-D maps; this manager has D = {self.D}")
        m = self._get_map(key)
        bbox = self._bboxes.get(key.get_key())
        if bbox is None:  # a map built in replay: its bbox was not read
            with P.host_read("serialize.bbox"):
                bbox = np.asarray(bbox_values(m.coordinates).tolist()).reshape(2, -1)
        if m.size and bbox[0, 1:].min() < 0:
            raise ValueError("serialization takes non-negative coordinates (each scene's grid "
                             "relative to its minimum)")
        top = max((int(bbox[1, 1 + d]) // s for d, s in enumerate(m.tensor_stride)), default=0)
        depth = int(top).bit_length() if m.size else 0
        if depth > MAX_DEPTH:
            raise ValueError(f"serialization depth {depth} above {MAX_DEPTH}")
        scenes = int(bbox[1, 0]) + 1 if m.size else 0
        batch = m.coordinates[:, 0].contiguous()
        offsets = torch.searchsorted(batch, torch.arange(scenes + 1, device=batch.device,
                                                         dtype=batch.dtype))
        with P.host_read("serialize.offsets", coords=True):
            host = offsets.tolist()
        return offsets, host, depth

    def window_plan(self, key: CoordinateMapKey, curve: str, patch_size: int) -> WindowPlan:
        """The window plan of serialized attention on the map along
        ``curve`` with windows of ``patch_size`` rows, built once and cached
        under (map, curve, window size)."""
        ck = (key.get_key(), curve, int(patch_size))
        if ck not in self._window_plans:
            (ser,) = self.serialize(key, (curve,))
            with P.attn_part("plan"):
                offsets, host, _ = self._scene_offsets[key.get_key()]
                self._window_plans[ck] = build_window_plan(ser, offsets, host, patch_size)
        return self._window_plans[ck]

    # ------------------------------------------------------------------
    # dense bbox grids
    # ------------------------------------------------------------------
    def dense_plan(self, key: CoordinateMapKey) -> Optional[DensePlan]:
        """The map's dense plan (``ops/dense_conv.py``), built once and
        cached; None for an empty map.  Its grid shape ratchets the map's
        grid floor.  In a deferred replay a map with a grid floor gets its
        plan at the floor's shape with no host sync, and the check that
        the map fits goes with the counts; a map without one gets its plan
        after the one transfer.  A traced replay needs the floor: without
        it, ``UntraceableReplay``."""
        key_t = key.get_key()
        if key_t in self._dense_plans:
            return self._dense_plans[key_t]
        with P.coords_call("dense_plan"):
            self._check_not_frozen("a dense plan")
            d = self._deferred
            if d is not None:
                floor = self._grid_floors.get(key_t)
                bbox_dev = d["bboxes"].get(key_t)
                if d["traced"] and (floor is None or bbox_dev is None):
                    raise UntraceableReplay(f"no dense-grid floor for map {key_t}")
                if floor is None or bbox_dev is None:
                    if key_t not in d["plans"]:
                        d["plans"].append(key_t)
                        self._record("dense_plan", key_t)
                    return None  # built in _finalized
                plan, ok = build_dense_plan_traced(self._get_map(key), bbox_dev, floor)
                d["grid_checks"].append((key_t, ok))
            else:
                plan = build_dense_plan(
                    self._get_map(key), bbox=self._bboxes.get(key_t),
                    extent_floor=self._grid_floors.get(key_t), margin=self._overprovision,
                )
                if plan is not None:
                    self._grid_floors[key_t] = plan.grid_shape
            self._dense_plans[key_t] = plan
            self._record("dense_plan", key_t)
            return plan

    def _probe_grid_for(self, key: CoordinateMapKey):
        """The map's grid probe, (row_grid, mins, grid_shape, tensor_stride),
        or None: no plan yet (a deferred replay without its floor), an
        empty map, or a grid over ``_MAX_GRID_CELLS`` (huge sparse extents),
        where the key search serves.  A traced replay asks for no plan the
        sync pass did not floor within the cap."""
        key_t = key.get_key()
        floor = self._grid_floors.get(key_t)
        if self._deferred is not None and self._deferred["traced"] and (
            floor is None or math.prod(floor) > _MAX_GRID_CELLS
        ):
            return None
        grid = self._row_grids.get(key_t)
        if grid is not None:
            plan = self._dense_plans[key_t]
        else:
            with P.span("coords.probe_grid"):
                plan = self.dense_plan(key)
                if plan is None or plan.cells > _MAX_GRID_CELLS:
                    return None
                grid = self._row_grids[key_t] = build_row_grid(plan.flat_idx, plan.cells)
        return grid, plan.mins, plan.grid_shape, self._get_map(key).tensor_stride

    # ------------------------------------------------------------------
    # quantized features of an insert
    # ------------------------------------------------------------------
    def reduce_features(
        self, key: CoordinateMapKey, features, quantization_mode=None
    ) -> torch.Tensor:
        """The features of an inserted map's input rows reduced onto its
        rows by the quantization mode (RANDOM_SUBSAMPLE by default): what
        ``SparseTensor``'s constructor does, for use after ``replay``, where
        the insert has already happened.  bf16 sums stay float32 until the
        end, as in ``ops.functional.segment_sum``.  On a traced replay's
        padded maps the result is padded too (zero rows past the count)."""
        from ..sparse_tensor import quantize_features
        from ..types import SparseTensorQuantizationMode as Q

        res = self._insert_results.get(key.get_key())
        if res is None:
            raise KeyError(f"no insert recorded for {key.get_key()}")
        unique_map, inverse_map = res
        feats = torch.as_tensor(features, device=self.device)
        mode = Q.RANDOM_SUBSAMPLE if quantization_mode is None else quantization_mode
        return quantize_features(feats, inverse_map, unique_map.shape[0], mode, unique_map)

    # ------------------------------------------------------------------
    # geometry export and replay (coords/geometry.py)
    # ------------------------------------------------------------------
    def export_geometry(self):
        """The cached coordinate state as a ``Geometry``: maps, kernel maps,
        stride and origin maps, dense plans, origin keys and the entry
        key."""
        from .geometry import Geometry

        if self._deferred is not None:
            raise RuntimeError("a traced replay's maps are padded: finalize it first")
        return Geometry(
            D=self.D,
            maps=dict(self._maps),
            kernel_maps=dict(self._kernel_maps),
            stride_maps=dict(self._stride_maps),
            dense_plans=dict(self._dense_plans),
            origin_keys={k: v.get_key() for k, v in self._origin_keys.items()},
            entry_key_tuple=self._entry_key.get_key() if self._entry_key else None,
        )

    @classmethod
    def from_geometry(cls, geometry) -> "CoordinateManager":
        """A frozen view over a Geometry: every lookup hits its caches, and
        any build raises ``RuntimeError``."""
        if geometry.row_shapes is not None:
            raise ValueError("a stacked Geometry: take one with index_geometry first")
        mgr = cls(D=geometry.D, device=geometry.device)
        mgr._maps = dict(geometry.maps)
        mgr._kernel_maps = dict(geometry.kernel_maps)
        mgr._stride_maps = dict(geometry.stride_maps)
        mgr._dense_plans = dict(geometry.dense_plans)
        mgr._origin_keys = {k: CoordinateMapKey(*v) for k, v in geometry.origin_keys.items()}
        if geometry.entry_key_tuple is not None:
            mgr._entry_key = CoordinateMapKey(*geometry.entry_key_tuple)
        mgr._frozen = True
        return mgr

    def traced_ok(self) -> torch.Tensor:
        """0-d device bool: every floor of this traced replay held (each
        map's count within its capacity, no coordinate out of the key
        range, each pooling map's Kmax and each dense grid's extents within
        their floors).  Read it once per batch; on False, replay the batch
        in sync mode, which ratchets."""
        d = self._deferred
        checks = [torch.ones((), dtype=torch.bool, device=self.device)]
        if d is not None:
            for key_t, overflow in d["maps"]:
                m = self._maps[key_t]
                checks.append((m.count <= m.capacity) & ~overflow)
            for cache_key, max_rank in d["kmax"]:
                checks.append(max_rank <= self._cap_floors[("kmax", cache_key)])
            checks += [ok for _, ok in d["grid_checks"]]
        return torch.stack(checks).all()

    def _begin_deferred(self, traced: bool) -> None:
        self._deferred = {
            "maps": [], "kmax": [], "inserts": [], "traced": traced,
            # per map its device bbox; maps whose plan waits for the
            # transfer; (map, device bool) of each plan built at its floor
            "bboxes": {}, "plans": [], "grid_checks": [],
        }

    def _pending_scalars(self) -> torch.Tensor:
        """(n,) int64 device tensor of what ``_finalized`` reads, in its
        order: each padded map's count and overflow flag, each floored
        Kmax, each traced insert's valid rows, each map's bbox (minima then
        maxima) and each floored grid's check."""
        d = self._deferred
        out = [self._maps[k].count for k, _ in d["maps"]]
        out += [ovf for _, ovf in d["maps"]]
        out += [r for _, r in d["kmax"]]
        out += [n for _, n in d["inserts"] if isinstance(n, torch.Tensor)]
        out += list(d["bboxes"].values())
        out += [ok for _, ok in d["grid_checks"]]
        if not out:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        return torch.cat([t.to(torch.int64).reshape(-1) for t in out])

    def _finalize_deferred(self) -> "CoordinateManager":
        """One host transfer of every pending value, then ``_finalized``."""
        values = self._pending_scalars()
        with P.host_read("replay.pending"):
            values = values.tolist()
        return self._finalized(values)

    def _finalized(self, values: Sequence[int]) -> "CoordinateManager":
        """A new exact manager from this deferred one, given the host values
        of ``_pending_scalars``: every padded map, kernel map, stride map
        and insert result cut to its exact rows (copies, which own their
        memory), floors ratcheted.  This manager is left as it was, so a
        CUDA graph's outputs can be read again after the next replay.
        Raises CapacityFloorExceeded if a floor did not hold."""
        d = self._deferred
        it = iter(values)
        counts = {k: next(it) for k, _ in d["maps"]}
        overflow = [next(it) for _ in d["maps"]]
        kmax = {ck: next(it) for ck, _ in d["kmax"]}
        n_in = {k: (next(it) if isinstance(n, torch.Tensor) else None) for k, n in d["inserts"]}
        width = 2 * (self.D + 1)
        bboxes = {k: np.asarray([next(it) for _ in range(width)]).reshape(2, -1) for k in d["bboxes"]}
        grid_ok = {k: next(it) for k, _ in d["grid_checks"]}
        if any(overflow):
            raise ValueError(_overflow_message(self.D))
        over = [k for k, n in counts.items() if n > self._maps[k].capacity]
        over += [ck[:2] for ck, r in kmax.items() if r > self._cap_floors[("kmax", ck)]]
        over += [k for k, ok in grid_ok.items() if not ok]
        if over:
            raise CapacityFloorExceeded(f"floors too small for {over}")

        new = type(self)(D=self.D, device=self.device)
        n_ids = next(self._id_counter)
        self._id_counter, new._id_counter = itertools.count(n_ids), itertools.count(n_ids)
        new._oplog = list(self._oplog)
        new._entry_key = self._entry_key
        new._origin_keys = dict(self._origin_keys)
        new._cap_floors = dict(self._cap_floors)
        new._grid_floors = dict(self._grid_floors)
        new._bboxes = {**self._bboxes, **bboxes}
        new._overprovision = self._overprovision
        rows = {}
        for k, m in self._maps.items():
            if k in counts:
                new._maps[k], rows[k] = m.exact(counts[k]), counts[k]
                new._ratchet(k, counts[k])
            else:
                new._maps[k], rows[k] = m, m.rows
        for ck, km in self._kernel_maps.items():
            # a transposed pooling map is its forward map swapped: same Kmax
            pool_ck = ck if ck in kmax else (ck[1], ck[0], *ck[2:6], False, *ck[7:])
            if ck[0] in counts or ck[1] in counts or pool_ck in kmax:
                kv = max(kmax[pool_ck], 1) if pool_ck in kmax else km.kernel_volume
                km = KernelMap(
                    km.in_idx[:kv, : rows[ck[1]]].clone(memory_format=torch.contiguous_format),
                    km.out_idx_t[:kv, : rows[ck[0]]].clone(memory_format=torch.contiguous_format),
                    rows[ck[0]], rows[ck[1]],
                )
            new._kernel_maps[ck] = km
        for ck, sm in self._stride_maps.items():
            new._stride_maps[ck] = sm[: counts[ck[0]]].clone() if ck[0] in counts else sm
        for k, (um, im) in self._insert_results.items():
            if k in counts:
                rows_in = im.shape[0] if n_in[k] is None else n_in[k]
                um, im = um[: counts[k]].clone(), im[:rows_in].clone()
            new._insert_results[k] = (um, im)
        for k, plan in self._dense_plans.items():
            if plan is not None and k in counts:
                plan = DensePlan(plan.flat_idx[: counts[k]].clone(), plan.grid_shape, plan.mins.clone())
            new._dense_plans[k] = plan
        for k in d["plans"]:  # the plans that waited for the bboxes
            plan = build_dense_plan(
                new._maps[k], bbox=new._bboxes.get(k), extent_floor=new._grid_floors.get(k),
                margin=new._overprovision,
            )
            new._dense_plans[k] = plan
            if plan is not None:
                new._grid_floors[k] = plan.grid_shape
        return new

    @classmethod
    def replay(
        cls,
        oplog: Sequence[tuple],
        coordinates,
        tensor_stride=1,
        cap_floors: Optional[Dict[tuple, int]] = None,
        grid_floors: Optional[Dict[tuple, tuple]] = None,
        deferred: Optional[bool] = None,
        traced: bool = False,
        n_valids=None,
        overprovision: float = 1.0,
        device=None,
    ) -> "CoordinateManager":
        """Run a recorded coordinate-op recipe again on new coordinates.

        The fresh-geometry path: record the ops once (the first eager
        forward), then replay them per batch without the model and export a
        ``Geometry`` for the training step.  With capacity floors (deferred
        by default then), every map is built at its floored capacity with
        its count on the device and ONE host transfer resolves them all; a
        floor that proves too small makes the sync replay run instead,
        which ratchets it.  ``traced=True`` makes no host sync at all: the
        maps stay padded, ``traced_ok()`` is the device bool to read, and a
        missing floor raises ``UntraceableReplay`` (``CompiledReplayer`` is
        the per-batch runner).

        ``coordinates``: one (N, D+1) array, or a list with one per recorded
        ``insert``.  ``n_valids``: per insert, a 0-d device tensor counting
        the valid leading rows of a padded array (traced convention).
        ``tensor_stride`` is taken from the recipe and kept for the JAX
        signature.  ``grid_floors``: each map's dense grid shape, ratcheted
        as the capacities are.  ``device``: where the maps go; by default
        the coordinates' device, or the card for host data.
        """
        if traced:
            return cls._replay_once(
                oplog, coordinates, cap_floors, "traced", n_valids, 1.0, device, grid_floors
            )
        if deferred is None:
            deferred = bool(cap_floors)
        if deferred:
            try:
                return cls._replay_once(
                    oplog, coordinates, cap_floors, True, n_valids, overprovision, device,
                    grid_floors,
                )
            except CapacityFloorExceeded:
                pass  # the sync replay below ratchets the floors
        return cls._replay_once(
            oplog, coordinates, cap_floors, False, n_valids, overprovision, device, grid_floors
        )

    @classmethod
    def _replay_once(
        cls, oplog, coordinates, cap_floors, mode, n_valids, overprovision, device,
        grid_floors=None,
    ) -> "CoordinateManager":
        if not isinstance(coordinates, (list, tuple)):
            coordinates = [coordinates]
        if n_valids is not None and not isinstance(n_valids, (list, tuple)):
            n_valids = [n_valids]
        coords_iter = iter(coordinates)
        nvalid_iter = iter(n_valids) if n_valids is not None else None
        mgr = None
        for entry in oplog:
            op = entry[0]
            if op == "insert":
                _, ts, sid, produced = entry
                c = next(coords_iter)
                if mgr is None:
                    dev = device
                    if dev is None and isinstance(c, torch.Tensor):
                        dev = c.device
                    mgr = cls(D=int(c.shape[1]) - 1, device=dev)
                    mgr._overprovision = float(overprovision)
                    mgr._cap_floors.update(cap_floors or {})
                    mgr._grid_floors.update(grid_floors or {})
                    if mode:
                        mgr._begin_deferred(traced=mode == "traced")
                key, _ = mgr.insert_and_map(
                    c, ts, sid, n_valid=next(nvalid_iter) if nvalid_iter is not None else None
                )
                if key.get_key() != produced:
                    raise RuntimeError(
                        f"replay produced key {key.get_key()}, recorded {produced}: "
                        "op order diverged"
                    )
                continue
            if mgr is None:
                raise RuntimeError("oplog does not start with an insert")
            if op == "stride":
                _, in_k, stride, sid = entry
                mgr.stride(CoordinateMapKey(*in_k), stride, sid)
            elif op == "stride_region":
                _, in_k, rtype, off_bytes, off_shape, out_ts, expand, is_t, sid = entry
                offsets = np.frombuffer(off_bytes, np.int32).reshape(off_shape)
                region = KernelRegion(RegionType(rtype), offsets)
                mgr.stride_region(CoordinateMapKey(*in_k), region, out_ts, expand, is_t, sid)
            elif op == "origin":
                mgr.origin(CoordinateMapKey(*entry[1]))
            elif op == "origin_map":
                mgr.origin_map(CoordinateMapKey(*entry[1]))
            elif op == "kernel_map":
                _, in_k, out_k, stride, ks, dil, rtype, off, is_t, is_pool = entry
                region_offs = (
                    None if off is None else np.frombuffer(off[0], np.int32).reshape(off[1])
                )
                mgr.kernel_map(
                    CoordinateMapKey(*in_k), CoordinateMapKey(*out_k), stride, ks, dil,
                    RegionType(rtype), region_offs, is_t, is_pool,
                )
            elif op == "stride_map":
                _, in_k, out_k = entry
                mgr.stride_map(CoordinateMapKey(*in_k), CoordinateMapKey(*out_k))
            elif op == "merge":
                mgr.merge([CoordinateMapKey(*k) for k in entry[1]])
            elif op == "dense_plan":
                mgr.dense_plan(CoordinateMapKey(*entry[1]))
            else:
                raise RuntimeError(f"unknown oplog entry {op!r}")
        if mgr is None:
            raise RuntimeError("empty oplog")
        if mode == "traced":
            return mgr  # the checks stay on the device: see traced_ok()
        if mode:
            return mgr._finalize_deferred()
        return mgr
