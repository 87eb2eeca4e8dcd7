"""CoordinateManager: the cache of coordinate maps and kernel maps.

Counterpart of the eager part of ``minkowskiengine_tpu/coords/manager.py``
(reference: src/coordinate_map_manager.hpp:87-565, .cpp:349-1414).  The
coordinate phase runs eagerly on the manager's device: each op sorts or
searches packed int64 keys and caches its result under the reference's
cache keys (``kernel_map_key_type``, src/types.hpp:183-192).  Maps hold
exact row counts.  The JAX package's oplog and replay, slab floors and
grid probes are TPU machinery and are not carried over.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernel_generator import KernelRegion, region_offsets
from ..types import RegionType, as_tuple
from .kernel_map import KernelMap, build_kernel_map
from .map import CoordinateMap
from .unique import unique_coordinates


class CoordinateMapKey:
    """Handle of a coordinate map inside a manager: ``(tensor_stride, string id)``
    (reference: pybind/extern.hpp:744-765)."""

    def __init__(self, tensor_stride, string_id: str = ""):
        self._key = (tuple(int(t) for t in tensor_stride), string_id)

    def get_key(self) -> Tuple[Tuple[int, ...], str]:
        return self._key

    def get_tensor_stride(self) -> Tuple[int, ...]:
        return self._key[0]

    def __eq__(self, other):
        return isinstance(other, CoordinateMapKey) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        return f"CoordinateMapKey({self._key})"


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


class CoordinateManager:
    """Caches coordinate maps and kernel maps on ``device``."""

    def __init__(self, D: int, device="cpu"):
        if D < 1:
            raise ValueError(f"Invalid dimension {D}")
        self.D = int(D)
        self.device = torch.device(device)
        self._maps: Dict[Tuple[Tuple[int, ...], str], CoordinateMap] = {}
        self._kernel_maps: Dict[tuple, KernelMap] = {}
        self._id_counter = itertools.count()

    # ------------------------------------------------------------------
    # map bookkeeping
    # ------------------------------------------------------------------
    def _unique_string_id(self, tensor_stride: Tuple[int, ...], string_id: str) -> str:
        sid = string_id
        while (tensor_stride, sid) in self._maps:
            sid = f"{string_id or 'map'}-{next(self._id_counter)}"
        return sid

    def _get_map(self, key: CoordinateMapKey) -> CoordinateMap:
        k = key.get_key()
        if k not in self._maps:
            raise KeyError(f"Coordinate map {k} not found in manager")
        return self._maps[k]

    def size(self, key: CoordinateMapKey) -> int:
        return self._get_map(key).size

    def get_coordinates(self, key: CoordinateMapKey) -> torch.Tensor:
        return self._get_map(key).coordinates

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
        if is_pool and s == ks and off_key is None:
            raise NotImplementedError(
                "the stride-map pooling fast path is not ported yet"
            )
        in_map = self._get_map(in_key)
        out_map = self._get_map(out_key)
        if not is_transpose:
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
            else:
                # build out→in with offsets at the *output's* (finer)
                # stride, then swap (src/coordinate_map_manager.cpp:759-813)
                offs = region_offsets_for(
                    region_type, ks, dil, out_map.tensor_stride, region_offsets
                )
                kmap = build_kernel_map(out_map, in_map, offs).swap()
        self._kernel_maps[cache_key] = kmap
        return kmap
