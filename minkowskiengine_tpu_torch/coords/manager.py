"""CoordinateManager: the cache of coordinate maps and kernel maps.

Counterpart of the eager part of ``minkowskiengine_tpu/coords/manager.py``
(reference: src/coordinate_map_manager.hpp:87-565, .cpp:349-1414).  The
coordinate phase runs eagerly on the manager's device (the card unless
the caller passes ``device="cpu"``): each op sorts or searches packed
int64 keys and caches its result under the reference's cache keys
(``kernel_map_key_type``, src/types.hpp:183-192).  Maps hold exact row
counts.  Field maps (a TensorField's float coordinates), origin maps,
stride maps and field-to-sparse maps live beside the coordinate maps.
The JAX package's oplog and replay, slab floors and grid probes are TPU
machinery and are not carried over.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernel_generator import KernelRegion, region_offsets
from ..types import RegionType, as_tuple, resolve_device
from . import keys as K
from .kernel_map import KernelMap, build_kernel_map, build_stride_map, stride_map_to_kernel_map
from .lookup import find_rows
from .map import CoordinateFieldMap, CoordinateMap
from .unique import unique_coordinates


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
    ts = torch.tensor(tensor_stride, dtype=torch.float32, device=dev)
    corners = torch.tensor(list(itertools.product((0, 1), repeat=D)), dtype=torch.float32, device=dev)
    p = samples[:, 1:] / ts
    base = torch.floor(p)
    frac = p - base
    corner_pos = base[None, :, :] + corners[:, None, :]
    batch = samples[:, :1].to(torch.int32).expand(len(corners), -1, -1)
    coords = torch.cat([batch, (corner_pos * ts).to(torch.int32)], dim=-1)
    w = torch.where(corners[:, None, :] == 1, frac[None, :, :], 1.0 - frac[None, :, :])
    return coords, w.prod(dim=-1)


def _origin_coords(coords: torch.Tensor) -> torch.Tensor:
    """(b, 0, ..., 0) for every row."""
    out = torch.zeros_like(coords)
    out[:, 0] = coords[:, 0]
    return out


class CoordinateManager:
    """Caches coordinate maps and kernel maps on ``device`` (default: the
    CUDA card; ``device="cpu"`` for the CPU)."""

    def __init__(self, D: int, device=None):
        if D < 1:
            raise ValueError(f"Invalid dimension {D}")
        self.D = int(D)
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

    def get_coordinates(self, key: CoordinateMapKey) -> torch.Tensor:
        return self._get_map(key).coordinates

    def get_coordinate_field(self, key: CoordinateMapKey) -> torch.Tensor:
        return self._get_field_map(key).coordinates

    def _find_rows_in(self, key: CoordinateMapKey, coords: torch.Tensor) -> torch.Tensor:
        """Row of each integer query coordinate in a map, or -1 (int32)."""
        rows = find_rows(self._get_map(key).keys, K.pack(coords))
        return rows.masked_fill_(K.overflow_mask(coords), -1)

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
        self, coords: torch.Tensor, tensor_stride: Tuple[int, ...], string_id: str
    ):
        """Unique ``coords`` into a new registered map.

        Returns (key, unique_map, inverse_map).
        """
        res, u_coords, overflow = unique_coordinates(coords)
        if bool(overflow):
            raise ValueError(
                "Coordinate out of packed-key range for dimension "
                f"{self.D}; see coords/keys.py field_ranges"
            )
        sid = self._unique_string_id(tensor_stride, string_id)
        key = CoordinateMapKey(tensor_stride, sid)
        self._maps[key.get_key()] = CoordinateMap(
            u_coords, res.sorted_keys, tuple(tensor_stride)
        )
        return key, res.unique_map, res.inverse_map

    def insert_and_map(self, coordinates, tensor_stride=1, string_id: str = ""):
        """Insert coordinates, returning (key, (unique_map, inverse_map)).

        Reference: CoordinateMapManager::insert_and_map
        (src/coordinate_map_manager.cpp:349-399);
        ``coords[unique_map][inverse_map] == coords``.
        """
        ts = as_tuple(tensor_stride, self.D)
        coords = torch.as_tensor(coordinates, device=self.device).to(torch.int32)
        if coords.ndim != 2 or coords.shape[1] != self.D + 1:
            raise ValueError(
                f"coordinates must be (N, {self.D + 1}), got {tuple(coords.shape)}"
            )
        key, unique_map, inverse_map = self._register_unique(coords, ts, string_id)
        return key, (unique_map, inverse_map)

    def insert_field(self, coordinates, tensor_stride=1, string_id: str = "") -> CoordinateMapKey:
        """Insert continuous coordinates, the store behind a TensorField
        (reference: insert_field, src/coordinate_map_manager.cpp:139-186)."""
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
        c = in_map.coordinates
        ts = torch.tensor(out_ts, dtype=torch.int32, device=c.device)
        spatial = torch.div(c[:, 1:], ts, rounding_mode="floor") * ts
        strided = torch.cat([c[:, :1], spatial], dim=1)
        new_key, _, _ = self._register_unique(strided, out_ts, sid)
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
        c = self._get_map(key).coordinates
        offs = torch.zeros((region.volume, self.D + 1), dtype=torch.int32, device=c.device)
        offs[:, 1:] = torch.as_tensor(region.offsets, device=c.device)
        cand = (c[None, :, :] + offs[:, None, :]).reshape(-1, self.D + 1)
        if not is_transpose:
            ts = torch.tensor(out_ts, dtype=torch.int32, device=c.device)
            cand = cand[torch.all(torch.remainder(cand[:, 1:], ts) == 0, dim=1)]
        new_key, _, _ = self._register_unique(cand, out_ts, sid)
        return new_key

    def origin(self, key: CoordinateMapKey) -> CoordinateMapKey:
        """Map of the per-batch origins (b, 0, ..., 0) (reference: origin,
        src/coordinate_map_cpu.hpp:492-513)."""
        k = key.get_key()
        if k not in self._origin_keys:
            ocoords = _origin_coords(self._get_map(key).coordinates)
            self._origin_keys[k], _, _ = self._register_unique(
                ocoords, (1,) * self.D, f"origin-{k[1]}"
            )
        return self._origin_keys[k]

    def origin_field(self, key: CoordinateMapKey) -> CoordinateMapKey:
        """Origin map of a field map: the batch indices of its float rows."""
        k = key.get_key()
        cache_k = (k, "field-origin")
        if cache_k not in self._origin_keys:
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
            ocoords = _origin_coords(self._get_map(key).coordinates)
            self._stride_maps[ck] = self._find_rows_in(origin_key, ocoords)
        return origin_key, self._stride_maps[ck]

    def origin_field_map(self, key: CoordinateMapKey) -> Tuple[CoordinateMapKey, torch.Tensor]:
        """``origin_map`` for a field map; the float batch column is cast to
        int32 (reference: src/global_pooling_cpu.cpp:72-85)."""
        origin_key = self.origin_field(key)
        ck = (key.get_key(), "field", origin_key.get_key())
        if ck not in self._stride_maps:
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
        in_map = self._get_map(key)
        keep = torch.as_tensor(keep, device=in_map.device).to(torch.bool)
        if keep.shape != (in_map.size,):
            raise ValueError(f"keep mask of shape {tuple(keep.shape)} for {in_map.size} rows")
        out_from_in = keep.nonzero().flatten().to(torch.int32)
        in_to_out = torch.where(keep, torch.cumsum(keep, 0, dtype=torch.int32) - 1, -1).to(torch.int32)
        sid = self._unique_string_id(in_map.tensor_stride, "pruned")
        new_key = CoordinateMapKey(in_map.tensor_stride, sid)
        self._maps[new_key.get_key()] = CoordinateMap(
            in_map.coordinates[out_from_in.long()], in_map.keys[out_from_in.long()],
            in_map.tensor_stride,
        )
        return new_key, in_to_out, out_from_in

    def merge(self, keys) -> CoordinateMapKey:
        """The union of several maps' coordinates, all at one tensor stride,
        as a new map with string id ``merged`` (or ``merged-N``)
        (reference: merge, src/coordinate_map_cpu.hpp:538-564)."""
        maps = [self._get_map(k) for k in keys]
        ts = maps[0].tensor_stride
        if any(m.tensor_stride != ts for m in maps):
            raise ValueError("merge requires identical tensor strides")
        coords = torch.cat([m.coordinates for m in maps], dim=0)
        new_key, _, _ = self._register_unique(coords, ts, "merged")
        return new_key

    def union_map(self, in_keys, out_key: CoordinateMapKey):
        """Per input map, the (N_i,) int32 row of each of its rows in the
        union map ``out_key``, -1 where absent (reference: union_map,
        src/coordinate_map_cpu.hpp:842-873)."""
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
        ts = as_tuple(sparse_tensor_stride, self.D)
        qcoords = _quantize_field(self._get_field_map(field_key).coordinates, ts)
        sparse_key, unique_map, inverse_map = self._register_unique(qcoords, ts, sparse_string_id)
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
            smap = self._get_map(sparse_key)
            qcoords = _quantize_field(self._get_field_map(field_key).coordinates, smap.tensor_stride)
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
        _, _, ks, s, dil, _, _, _, off_key = cache_key
        fast_pool = is_pool and s == ks and off_key is None
        in_map = self._get_map(in_key)
        out_map = self._get_map(out_key)
        if not is_transpose:
            if fast_pool:
                kmap = stride_map_to_kernel_map(
                    self.stride_map(in_key, out_key), in_map.size, out_map.size
                )
            else:
                offs = region_offsets_for(
                    region_type, ks, dil, in_map.tensor_stride, region_offsets
                )
                kmap = build_kernel_map(in_map, out_map, offs)
        else:
            swapped_key = (
                out_key.get_key(), in_key.get_key(), ks, s, dil,
                int(region_type), False, bool(is_pool), off_key,
            )
            if swapped_key in self._kernel_maps:
                kmap = self._kernel_maps[swapped_key].swap()
            elif fast_pool:
                kmap = stride_map_to_kernel_map(
                    self.stride_map(out_key, in_key), out_map.size, in_map.size
                ).swap()
            else:
                # build out→in with offsets at the *output's* (finer)
                # stride, then swap (src/coordinate_map_manager.cpp:759-813)
                offs = region_offsets_for(
                    region_type, ks, dil, out_map.tensor_stride, region_offsets
                )
                kmap = build_kernel_map(out_map, in_map, offs).swap()
        self._kernel_maps[cache_key] = kmap
        return kmap

    def stride_map(self, in_key: CoordinateMapKey, out_key: CoordinateMapKey) -> torch.Tensor:
        """(N_in,) int32 output row of each input row, cached (the pooling
        fast path's map; reference: src/coordinate_map_cpu.hpp:672-722)."""
        ck = (in_key.get_key(), out_key.get_key())
        if ck not in self._stride_maps:
            out_map = self._get_map(out_key)
            self._stride_maps[ck] = build_stride_map(
                self._get_map(in_key), out_map, out_map.tensor_stride
            )
        return self._stride_maps[ck]
