"""Sort-based unique / inverse-map construction.

Counterpart of ``minkowskiengine_tpu/coords/unique.py``.  One stable sort of
the packed int64 keys gives the unique rows in canonical key order,
``unique_map`` (the first input row of each unique key) and
``inverse_map`` (the unique row of each input row), with the reference's
contract (src/coordinate_map_cpu.hpp:340-352)::

    unique_coordinates = input_coordinates[unique_map]
    unique_coordinates[inverse_map] == input_coordinates

Row counts are exact: there is no capacity padding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import keys as K


class UniqueResult(NamedTuple):
    """Exact-size unique/inverse maps.

    Attributes:
      unique_map: (U,) int64, input row of each unique key's first occurrence.
      inverse_map: (N,) int64, unique row of each input row.
      sorted_keys: (U,) int64, ascending unique keys.
    """

    unique_map: torch.Tensor
    inverse_map: torch.Tensor
    sorted_keys: torch.Tensor


def unique_from_keys(keys: torch.Tensor) -> UniqueResult:
    """Unique + inverse over packed int64 keys."""
    s_keys, order = torch.sort(keys, stable=True)
    is_new = torch.ones_like(s_keys, dtype=torch.bool)
    is_new[1:] = s_keys[1:] != s_keys[:-1]
    seg_id = torch.cumsum(is_new, 0) - 1
    inverse = torch.empty_like(order)
    inverse[order] = seg_id
    # stable sort: the first row of each equal-key run has the least index
    return UniqueResult(order[is_new], inverse, s_keys[is_new])


def unique_coordinates(coords: torch.Tensor):
    """Unique over (N, D+1) integer coordinates.

    Returns (UniqueResult, unique coordinates (U, D+1) int32, overflow flag
    as a 0-d bool tensor on the coordinates' device).
    """
    res = unique_from_keys(K.pack(coords))
    overflow = K.overflow_mask(coords).any()
    return res, coords[res.unique_map].to(torch.int32), overflow
