"""The dense bbox grid of a coordinate map: its plan and its row grid.

Counterpart of ``DensePlan``, ``build_dense_plan`` and ``build_row_grid``
in the JAX package's ``ops``.  A ``DensePlan`` numbers the cells of a
map's bounding box, batch-major, in units of its tensor stride:
``flat_idx[r]`` is row r's cell.  Its inverse, the row grid
(``build_row_grid``), holds each cell's row or -1, plus one sentinel cell
that stays -1.  The grid is there for lookups: finding a coordinate's row
is then one gather from the row grid (``kernel_map.py::grid_lookup``) in
place of a sorted-key search, which the manager does for every map whose
grid fits (``manager.py::_probe_grid_for``) when it builds kernel, stride,
origin, union and interpolation maps, on the CPU and on the card alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import profiling as P

_BIG = 2**30  # bbox sentinel: an empty map's minima lie above its maxima


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """Scatter/gather indices between a coordinate map and its bbox grid.

    flat_idx: (N,) int32, the cell of each map row (batch-major), -1 for a
      padding row.
    grid_shape: (B, E_1..E_D) cell counts, each E a multiple of 16.
    mins: (D+1,) int32 device tensor, the bbox minima (batch first), the
      grid's origin, which the probes need.
    """

    flat_idx: torch.Tensor
    grid_shape: Tuple[int, ...]
    mins: Optional[torch.Tensor] = None

    @property
    def cells(self) -> int:
        # math.prod over Python ints: exact at any D
        return math.prod(self.grid_shape)


def _bbox(coords: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """Device (mins, maxs) over the valid rows; with none, mins lie above
    maxs (2^30 and -2^30)."""
    n, width = coords.shape
    if n == 0:
        return (coords.new_full((width,), _BIG), coords.new_full((width,), -_BIG))
    if valid is None:
        return coords.amin(0), coords.amax(0)
    v = valid[:, None]
    return (torch.where(v, coords, _BIG).amin(0), torch.where(v, coords, -_BIG).amax(0))


def bbox_values(coords: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(2·(D+1),) int64: ``_bbox``'s minima then maxima, to be read in one
    transfer with other scalars."""
    mins, maxs = _bbox(coords, valid)
    return torch.cat([mins, maxs]).to(torch.int64)


def _flat_indices(coords, valid, mins, extents, tensor_stride) -> torch.Tensor:
    """Batch-major cell of each row, -1 where ``valid`` is false; int32
    wrapping as JAX's (only grids within the probe's cap are read)."""
    flat = (coords[:, 0] - mins[0]).to(torch.int64)
    for d, (e, t) in enumerate(zip(extents, tensor_stride)):
        rel = (coords[:, 1 + d] - mins[1 + d]).to(torch.int64)
        flat = flat * int(e) + torch.div(rel, int(t), rounding_mode="floor")
    flat = flat.to(torch.int32)
    return flat if valid is None else flat.masked_fill_(~valid, -1)


def grid_shape_from_bbox(bbox, tensor_stride, extent_floor=None, margin=1.0):
    """(batches, *extents) for a host bbox: 16-multiple extents, for shapes
    that stay put under geometry jitter, raised to ``extent_floor``;
    ``margin`` > 1 overshoots the spatial extents (a recovering replay's
    ratchet)."""
    mins, maxs = np.asarray(bbox[0]), np.asarray(bbox[1])
    ts = np.asarray(tensor_stride, np.int64)
    extents = np.maximum((maxs[1:] - mins[1:]) // ts + 1, 1)
    if margin > 1.0:
        extents = np.ceil(extents * margin).astype(extents.dtype)
    extents = ((extents + 15) // 16) * 16
    batches = int(maxs[0] - mins[0] + 1)
    if extent_floor is not None:
        batches = max(batches, int(extent_floor[0]))
        extents = np.maximum(extents, np.asarray(extent_floor[1:]))
    return (batches,) + tuple(int(e) for e in extents)


def build_dense_plan(coordinate_map, bbox=None, extent_floor=None, margin=1.0) -> Optional[DensePlan]:
    """Dense plan of a coordinate map, or None for an empty map.

    ``bbox``: host (2, D+1) minima and maxima, which the manager reads in
    the same transfer as the map's row count; without it the bbox is read
    here (one host sync).  ``extent_floor``: an earlier grid shape, the
    ratchet that keeps the shape stable across batches.  The minima the
    plan keeps are taken on the device, so it copies nothing from the host.
    """
    coords = coordinate_map.coordinates
    valid = coordinate_map.valid_mask()
    mins_dev, maxs_dev = _bbox(coords, valid)
    if bbox is None:
        bbox = torch.stack([mins_dev, maxs_dev])
        with P.host_read("dense_plan.bbox"):
            bbox = bbox.tolist()
    mins, maxs = np.asarray(bbox[0]), np.asarray(bbox[1])
    if (maxs < mins).any():
        return None
    ts = coordinate_map.tensor_stride
    grid_shape = grid_shape_from_bbox((mins, maxs), ts, extent_floor, margin)
    mins_dev = mins_dev.to(torch.int32)
    return DensePlan(_flat_indices(coords, valid, mins_dev, grid_shape[1:], ts), grid_shape, mins_dev)


def build_dense_plan_traced(coordinate_map, bbox_dev, grid_shape_floor):
    """Dense plan at a known (floored) grid shape, with no host sync.

    ``bbox_dev``: the (2, D+1) device minima and maxima of the map's valid
    rows.  Returns (plan, ok): ``ok`` is a 0-d device bool, true when the
    map's extents fit the floor; a traced replay folds it into
    ``traced_ok``, a deferred one reads it with its counts.
    """
    coords = coordinate_map.coordinates
    ts = coordinate_map.tensor_stride
    mins, maxs = bbox_dev[0].to(torch.int32), bbox_dev[1].to(torch.int32)
    floor = tuple(int(g) for g in grid_shape_floor)
    flat = _flat_indices(coords, coordinate_map.valid_mask(), mins, floor[1:], ts)
    ok = maxs[0] - mins[0] + 1 <= floor[0]
    for d, (e, t) in enumerate(zip(floor[1:], ts)):
        ok = ok & (torch.div(maxs[1 + d] - mins[1 + d], int(t), rounding_mode="floor") < e)
    return DensePlan(flat, floor, mins), ok


def build_row_grid(flat_idx: torch.Tensor, cells: int) -> torch.Tensor:
    """(cells + 1,) int32 inverse of a plan: the row of each cell, -1 where
    empty.  The sentinel cell at index ``cells`` stays -1, so a probe out of
    the grid can be sent there."""
    grid = torch.full((cells + 2,), -1, dtype=torch.int32, device=flat_idx.device)
    # padding rows, and rows past the grid (a floor that did not hold: its
    # check fails the replay), go to the spare cell past the sentinel, which
    # is dropped
    flat = flat_idx.to(torch.int64)
    safe = torch.where((flat >= 0) & (flat < cells), flat, cells + 1)
    rows = torch.arange(flat_idx.shape[0], dtype=torch.int32, device=flat_idx.device)
    return grid.scatter_(0, safe, rows)[: cells + 1]
