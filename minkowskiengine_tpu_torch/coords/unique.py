"""Sort-based unique / inverse-map construction.

Counterpart of ``minkowskiengine_tpu/coords/unique.py``.  One stable sort of
the packed int64 keys (``(N,)`` for D <= 6, ``(N, L)`` words above, sorted
lexicographically by ``keys.sort_keys``) gives the unique rows in canonical
key order, ``unique_map`` (the first input row of each unique key) and
``inverse_map`` (the unique row of each input row), with the reference's
contract (src/coordinate_map_cpu.hpp:340-352)::

    unique_coordinates = input_coordinates[unique_map]
    unique_coordinates[inverse_map] == input_coordinates

Row counts are exact: there is no capacity padding, except in
``unique_padded``, the form geometry replay uses: the same sort at a fixed
output capacity, with the count on the device and no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling as P
from . import keys as K


class UniqueResult(NamedTuple):
    """Exact-size unique/inverse maps.

    Attributes:
      unique_map: (U,) int64, input row of each unique key's first occurrence.
      inverse_map: (N,) int64, unique row of each input row.
      sorted_keys: (U,) or (U, L) int64, ascending unique keys.
    """

    unique_map: torch.Tensor
    inverse_map: torch.Tensor
    sorted_keys: torch.Tensor


def unique_from_keys(keys: torch.Tensor) -> UniqueResult:
    """Unique + inverse over packed int64 keys, (N,) or (N, L)."""
    s_keys, order = K.sort_keys(keys)
    is_new = torch.ones(order.shape, dtype=torch.bool, device=order.device)
    is_new[1:] = K.keys_differ(s_keys)
    seg_id = torch.cumsum(is_new, 0) - 1
    inverse = torch.empty_like(order)
    inverse[order] = seg_id
    # stable sort: the first row of each equal-key run has the least index
    with P.host_read("unique.first_rows"):
        first = order[is_new]
    with P.host_read("unique.keys"):
        u_keys = s_keys[is_new]
    return UniqueResult(first, inverse, u_keys)


def unique_coordinates(coords: torch.Tensor):
    """Unique over (N, D+1) integer coordinates.

    Returns (UniqueResult, unique coordinates (U, D+1) int32, overflow flag
    as a 0-d bool tensor on the coordinates' device).
    """
    res = unique_from_keys(K.pack(coords))
    overflow = K.overflow_mask(coords).any()
    return res, coords[res.unique_map].to(torch.int32), overflow


class PaddedUniqueResult(NamedTuple):
    """Unique/inverse maps at a fixed capacity, all on the device.

    Attributes:
      sorted_keys: (capacity,) or (capacity, L) int64, ascending unique
        keys, then PAD_KEY rows.
      unique_map: (capacity,) int64, first input row of each unique key;
        -1 past ``count``.
      inverse_map: (N,) int64, unique row of each valid input row; -1 for
        an invalid row.
      count: () int64, unique keys among the valid rows (may exceed the
        capacity: the rows past it are dropped).
    """

    sorted_keys: torch.Tensor
    unique_map: torch.Tensor
    inverse_map: torch.Tensor
    count: torch.Tensor


def unique_padded(keys: torch.Tensor, valid: torch.Tensor, capacity: int) -> PaddedUniqueResult:
    """``unique_from_keys`` over ``keys[valid]``, written into ``capacity``
    rows by a scatter in place of a boolean-mask compaction, so nothing
    waits on the host.  Invalid rows sort last as ``PAD_KEY``; on the first
    ``count`` rows the result equals ``unique_from_keys`` index for index."""
    s_keys, order = K.sort_keys(K.mask_keys(keys, valid))
    real = ~K.is_pad(s_keys)
    is_new = torch.ones_like(real)
    is_new[1:] = K.keys_differ(s_keys)
    is_new &= real
    seg_id = torch.cumsum(is_new, 0) - 1
    inverse = torch.empty_like(order)
    inverse[order] = torch.where(real, seg_id, -1)
    tgt = torch.where(is_new & (seg_id < capacity), seg_id, capacity)
    unique_map = order.new_full((capacity + 1,), -1).scatter_(0, tgt, order)[:capacity]
    rows = tgt.view((-1,) + (1,) * (s_keys.dim() - 1)).expand_as(s_keys)
    sorted_keys = K.pad_keys(s_keys, capacity + 1).scatter_(0, rows, s_keys)[:capacity]
    return PaddedUniqueResult(sorted_keys, unique_map, inverse, is_new.sum())


def unique_coordinates_padded(coords: torch.Tensor, valid: torch.Tensor, capacity: int):
    """``unique_padded`` over (N, D+1) integer coordinates.

    Returns (PaddedUniqueResult, unique coordinates (capacity, D+1) int32
    with zero rows past the count, overflow flag over the valid rows as a
    0-d bool tensor)."""
    res = unique_padded(K.pack(coords), valid, capacity)
    overflow = (K.overflow_mask(coords) & valid).any()
    u_coords = coords[res.unique_map.clamp_min(0)].to(torch.int32)
    u_coords = u_coords.masked_fill_((res.unique_map < 0)[:, None], 0)
    return res, u_coords, overflow
