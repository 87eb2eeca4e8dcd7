"""The dense bbox grid of a coordinate map: its plan, its row grid, and the
dense-grid convolution route.

Counterpart of ``minkowskiengine_tpu/ops/dense_conv.py``.  A ``DensePlan``
numbers the cells of a map's bounding box, batch-major, in units of its
tensor stride: ``flat_idx[r]`` is row r's cell.  Its inverse, the row grid
(``build_row_grid``), holds each cell's row or -1, plus one sentinel cell
that stays -1; a coordinate lookup is then one gather from the grid
(``coords/kernel_map.py::grid_lookup``), which the manager uses for every
map whose grid fits (``coords/manager.py::_probe_grid_for``) on the CPU and
on the card alike.

``dense_conv`` evaluates a stride-1 sparse convolution on the grid:
scatter the rows into it, run one ``F.conv1d``/``conv2d``/``conv3d``,
gather the rows back.  JAX computes that conv with
``lax.conv_general_dilated``, outside any Pallas kernel, so cuDNN is its
counterpart here.  ``dense_conv_beneficial`` is the gate: a cost model of
the route against the sparse conv (K1 and K2), fitted on the card
(``chip_smoke.py`` phase 41b).  The JAX package's z-fold core and its
patches, shifted-slice and filter-grad dW choices are TPU lowerings of the
same function and are not carried over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiling as P

# The gate's cost model, in microseconds per training use of a conv
# (forward, input gradient and weight gradient), fitted by least squares on
# relative residuals (tools/fit_dense_gate.py over two chip_smoke.py runs)
# to phase 41b's CUDA-event times of MinkUNet34's 16 stride-1 conv shapes
# on a batch of two surface-26k scans and phase 41a's kernel-map builds
# (NVIDIA H100 80GB HBM3, power limit 700.00 W).  The route pays for every
# cell of the grid, occupied or not, per offset and per multiply-add:
#     dense  = _DENSE_US_FIXED + cells·K·(_DENSE_US_PER_CELL_OFFSET
#                                         + cin·cout·_DENSE_US_PER_MAC)
# K1 and K2 pay for every slot of the dense kernel map, with Cin and Cout
# rounded up to their 32-wide tiles (csrc/gather_gemm.cu):
#     sparse = _SPARSE_US_FIXED + rows·K·cin32·cout32·_SPARSE_US_PER_MAC
# and when the map is not cached, its build through the row grids (phase
# 41a; launch-bound at these sizes, ~1 ms whatever the map):
#              + _KMAP_BUILD_US_FIXED + rows·K·_KMAP_BUILD_US_PER_PAIR
# The route is taken when dense · _DENSE_WORST_RATIO < sparse: the ratio is
# the largest measured / fitted time of the route among the fitted convs,
# so that a near tie (the route's times scatter up to 2x between runs on
# the small grids) stays on K1 and K2.
_DENSE_US_FIXED = 930.6  # H100 80GB HBM3, 700.00 W
_DENSE_US_PER_CELL_OFFSET = 5.524e-4  # H100 80GB HBM3, 700.00 W
_DENSE_US_PER_MAC = 1.782e-7  # H100 80GB HBM3, 700.00 W
_SPARSE_US_FIXED = 90.69  # H100 80GB HBM3, 700.00 W
_SPARSE_US_PER_MAC = 1.819e-7  # H100 80GB HBM3, 700.00 W
_KMAP_BUILD_US_FIXED = 1063.0  # H100 80GB HBM3, 700.00 W
_KMAP_BUILD_US_PER_PAIR = 0.0  # H100 80GB HBM3, 700.00 W
_DENSE_WORST_RATIO = 2.051  # H100 80GB HBM3, 700.00 W
_MAX_DENSE_BYTES = 1 << 30
_BIG = 2**30  # bbox sentinel: an empty map's minima lie above its maxima


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """Scatter/gather indices between a coordinate map and its bbox grid.

    flat_idx: (N,) int32, the cell of each map row (batch-major), -1 for a
      padding row.
    grid_shape: (B, E_1..E_D) cell counts, each E a multiple of 16.
    mins: (D+1,) int32 device tensor, the bbox minima (batch first), the
      grid's origin; the probes need it, the conv does not.
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
    wrapping as JAX's (only grids within the probe's and the route's caps
    are read)."""
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


def dense_conv_beneficial(
    plan: Optional[DensePlan],
    n_points_capacity: int,
    kernel_volume: int,
    cin: int,
    cout: int,
    tile: int = 256,
    map_cached: bool = True,
    cached_slab_size: Optional[int] = None,
    cached_sub_tiles: int = 1,
    cached_ov_cap: int = 0,
) -> bool:
    """Whether the dense route costs less than the sparse conv for one
    training use of a conv on ``n_points_capacity`` rows.

    The cost model is in the constants at the top of this module; a plan
    above D = 3, which ``dense_conv`` does not take, never routes.
    ``map_cached=False`` charges the sparse side the kernel map's build: on
    fresh geometry the conv would build it.  ``tile`` and the ``cached_*``
    arguments describe the JAX package's slab maps; the port has none, so
    they are taken and ignored.
    """
    del tile, cached_slab_size, cached_sub_tiles, cached_ov_cap
    if plan is None or len(plan.grid_shape) - 1 not in _CONV:
        return False
    cells = plan.cells
    if cells * (cin + cout) * 4 > _MAX_DENSE_BYTES:
        return False
    dense_us = _DENSE_US_FIXED + cells * kernel_volume * (
        _DENSE_US_PER_CELL_OFFSET + cin * cout * _DENSE_US_PER_MAC
    )
    pairs = n_points_capacity * kernel_volume
    sparse_us = _SPARSE_US_FIXED + pairs * _tile32(cin) * _tile32(cout) * _SPARSE_US_PER_MAC
    if not map_cached:
        sparse_us += _KMAP_BUILD_US_FIXED + pairs * _KMAP_BUILD_US_PER_PAIR
    return dense_us * _DENSE_WORST_RATIO < sparse_us


def _tile32(c: int) -> int:
    return -(-c // 32) * 32


def _padding(kernel_size, dilation):
    """(lo, hi) per spatial dim: odd kernels centered, even kernels on the
    positive side only (reference: src/kernel_region.hpp:204-220)."""
    return tuple(
        (dil * (k // 2), dil * (k // 2)) if k % 2 else (0, dil * (k - 1))
        for k, dil in zip(kernel_size, dilation)
    )


def _padded_flat(flat_idx: torch.Tensor, grid_shape, pads) -> torch.Tensor:
    """Each row's cell in the grid padded by ``pads`` per spatial dim, -1
    kept for a padding row."""
    flat = flat_idx.to(torch.int64).clamp_min(0)
    parts = []
    for e in reversed(grid_shape[1:]):
        parts.append(torch.remainder(flat, e))
        flat = torch.div(flat, e, rounding_mode="floor")
    out = flat  # the batch
    for (lo, hi), e, c in zip(pads, grid_shape[1:], reversed(parts)):
        out = out * (e + lo + hi) + c + lo
    return torch.where(flat_idx >= 0, out, -1)


def _rows_to_grid(feats: torch.Tensor, flat: torch.Tensor, cells: int) -> torch.Tensor:
    """(cells, ch) grid with each row's features in its cell, zero elsewhere;
    padding rows (-1) land in a spare row that is dropped."""
    safe = torch.where(flat >= 0, flat, cells)
    grid = feats.new_zeros((cells + 1, feats.shape[1]))
    return grid.index_copy_(0, safe, feats)[:cells]


def _grid_to_rows(grid: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Each row's cell of a (cells, ch) grid; zero for a padding row."""
    rows = grid.index_select(0, flat.clamp_min(0))
    return rows.masked_fill_((flat < 0)[:, None], 0)


class _DenseConv(torch.autograd.Function):
    """Scatter → conv → gather, and its gradient: the row ↔ cell relation
    is injective, so each direction of each transfer is a gather or an
    injective copy, and the conv's gradients are autograd's own formula for
    it (``aten::convolution_backward``).  Both directions run under the
    same cuDNN flags: float32 without TF32 and deterministic algorithms, so
    that the result does not depend on the caller's global flags or on the
    run."""

    @staticmethod
    def forward(ctx, feats, w, flat, pflat, grid_shape, pads, dilation):
        B, spatial = grid_shape[0], grid_shape[1:]
        padded = tuple(e + lo + hi for e, (lo, hi) in zip(spatial, pads))
        cin, cout = feats.shape[1], w.shape[0]
        dense = _channels_first(_rows_to_grid(feats, pflat, B * math.prod(padded)), B, padded)
        with _flags():
            out = _CONV[len(spatial)](dense, w, dilation=dilation)
        ctx.save_for_backward(dense, w, flat, pflat)
        ctx.shape = (B, spatial, padded, dilation, cin, cout)
        return _grid_to_rows(_channels_last(out, cout), flat)

    @staticmethod
    def backward(ctx, g):
        dense, w, flat, pflat = ctx.saved_tensors
        B, spatial, padded, dilation, cin, cout = ctx.shape
        need_x, need_w = ctx.needs_input_grad[:2]
        g_dense = _channels_first(_rows_to_grid(g.contiguous(), flat, B * math.prod(spatial)), B, spatial)
        D = len(spatial)
        with _flags():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g_dense, dense, w, None, (1,) * D, (0,) * D, tuple(dilation), False,
                (0,) * D, 1, [need_x, need_w, False],
            )
        d_feats = _grid_to_rows(_channels_last(dx, cin), pflat) if need_x else None
        return d_feats, dw if need_w else None, None, None, None, None, None


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _flags():
    return torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True, allow_tf32=False
    )


def _channels_first(grid: torch.Tensor, B: int, spatial) -> torch.Tensor:
    """A (cells, ch) grid as an (B, ch, *spatial) view: channels-last
    memory, which cuDNN takes as it is at D = 2 and 3."""
    D = len(spatial)
    return grid.view((B,) + tuple(spatial) + (grid.shape[1],)).permute(0, D + 1, *range(1, D + 1))


def _channels_last(out: torch.Tensor, ch: int) -> torch.Tensor:
    """(B, ch, *spatial) → (cells, ch)."""
    D = out.dim() - 2
    return out.permute(0, *range(2, D + 2), 1).reshape(-1, ch)


def dense_conv(
    feats: torch.Tensor,
    weights: torch.Tensor,
    plan: DensePlan,
    kernel_size: Tuple[int, ...],
    dilation: Tuple[int, ...],
) -> torch.Tensor:
    """Stride-1 sparse convolution evaluated on the dense bbox grid.

    ``feats``: (N, Cin) rows of the plan's map; ``weights``: (K, Cin, Cout),
    offsets with dim 0 fastest (the reference's enumeration).  Returns (N,
    Cout), differentiable in both.  D = 1, 2 and 3 (``NotImplementedError``
    above, as in JAX).
    """
    spatial = plan.grid_shape[1:]
    D = len(spatial)
    if D not in _CONV:
        raise NotImplementedError(f"dense dispatch for D={D}")
    ks = tuple(int(k) for k in kernel_size)
    dil = tuple(int(d) for d in dilation)
    cin, cout = feats.shape[1], weights.shape[-1]
    # offset k = i_0 + k_0·i_1 + k_0·k_1·i_2: reshape reversed, then to
    # torch's (Cout, Cin, k_0..k_{D-1})
    w = weights.reshape(tuple(reversed(ks)) + (cin, cout))
    w = w.permute(D + 1, D, *range(D - 1, -1, -1)).contiguous()
    pads = _padding(ks, dil)
    pflat = _padded_flat(plan.flat_idx, plan.grid_shape, pads)
    return _DenseConv.apply(
        feats.contiguous(), w, plan.flat_idx.to(torch.int64), pflat, plan.grid_shape, pads, dil
    )
