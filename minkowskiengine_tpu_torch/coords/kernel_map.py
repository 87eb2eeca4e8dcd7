"""Kernel maps as dense per-offset matchings.

Counterpart of ``minkowskiengine_tpu/coords/kernel_map.py``.  For a fixed
kernel offset the in↔out relation is a partial matching: each output row
probes exactly one input row, and distinct outputs probe distinct inputs.
A kernel map is therefore two dense int32 index matrices::

    in_idx   : (K, N_out) — input row feeding output row o at offset k, or -1
    out_idx_t: (K, N_in)  — the inverse matching, or -1

The forward convolution is a gather-GEMM through ``in_idx``
(kernels/gather_gemm.py); the transposed convolution is the same object
with the two matrices swapped.  The JAX package's slab decomposition for
its TPU kernel is not carried over.

Pooling with stride == kernel size takes the stride-map fast path: a
many-to-one stride map (``build_stride_map``) wrapped as a kernel map whose
rows are collision slots, not offsets (``stride_map_to_kernel_map``).

Every lookup has two routes to one answer.  The search route looks the
query keys up in the map's sorted keys (``lookup.find_rows``).  The grid
route gathers the query's cell from the probed map's dense bbox row grid
(``grid_lookup``; ``coords/grid.py::build_row_grid``), which the manager
passes as ``probe`` for every map whose grid fits.  The inverse matching
``out_idx_t`` is then a probe of the output map with the offsets negated,
in place of ``_invert_matching``.  The grid route gathers each (offset,
row) query's own cell and checks its bounds per query, so it needs no
shifted grid and no padding of the grid (JAX's ``_pads_for_offsets``): a
base below or above the probed bbox (a misaligned strided minimum, a
coarse transpose base) finds its rows like any other.  JAX's shifted-stack
and window-slice builds of the same answer are XLA tactics for the TPU and
are not carried over.  On CUDA tensors one launch of the grid-probe kernel
(``kernels/grid_probe.py``) writes both halves of a kernel map, or the one
half that has a grid; on the CPU ``_build_in_idx_grid``, its plain
version, builds each half in whole-array ops.
``build_kernel_map.route_builds`` counts the halves each route builds:
``"kernel"`` (the grid-probe kernel), ``"ops"`` (the plain version) and
``"search"`` (the key search or the inverted matching).

Every map-building function also takes padded maps
(``PaddedCoordinateMap``, geometry replay): an output row past the map's
count pairs with nothing (-1 in every slot), and a padded input row is
never probed, so cutting the result to the exact counts gives the eager
map index for index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import grid_probe as GP
from ..utils import profiling as P
from . import keys as K
from .lookup import find_rows
from .map import CoordinateMap

ROUTES = ("kernel", "ops", "search")  # the routes of a kernel map's half (build_kernel_map)


@dataclasses.dataclass(frozen=True)
class KernelMap:
    """Dense per-offset matching between an input and an output map."""

    in_idx: torch.Tensor  # (K, N_out) int32, -1 = no pair
    out_idx_t: torch.Tensor  # (K, N_in) int32, -1 = no pair
    n_in: int
    n_out: int

    @property
    def kernel_volume(self) -> int:
        return int(self.in_idx.shape[0])

    def swap(self) -> "KernelMap":
        """The transposed map (out↔in roles flipped)."""
        return KernelMap(self.out_idx_t, self.in_idx, self.n_out, self.n_in)

    def pair_counts(self) -> np.ndarray:
        """(K,) host array of the valid pairs of each offset."""
        return (self.in_idx >= 0).sum(1).cpu().numpy()

    def to_pair_lists(self):
        """``{k: (in_rows, out_rows)}`` int64 numpy on the host, for each
        offset k with at least one pair (reference ``kernel_map_th``)."""
        in_idx = self.in_idx.cpu().numpy()
        out = {}
        for k in range(in_idx.shape[0]):
            o = np.nonzero(in_idx[k] >= 0)[0]
            if o.size:
                out[k] = (in_idx[k][o].astype(np.int64), o.astype(np.int64))
        return out


def _build_queries(out_coords: torch.Tensor, offsets: torch.Tensor):
    """Probe keys, (K, N_out) or (K, N_out, L) words, and their (K, N_out)
    overflow mask, built from the output rows' keys and the offsets' key
    deltas word by word: the (K, N_out, D+1) query coordinates are never
    formed."""
    keys = K.pack(out_coords)[None, :] + K.pack_offsets(offsets)[:, None]
    return keys, K.overflow_mask_of_sum(out_coords, offsets)


def _build_in_idx(
    in_keys: torch.Tensor, out_coords: torch.Tensor, offsets: torch.Tensor, out_valid=None
) -> torch.Tensor:
    """in_idx[k, o] = row of (out_coords[o] + offsets[k]) in the in-map, or
    -1; -1 in every slot of an output row where ``out_valid`` is false."""
    q_keys, invalid = _build_queries(out_coords, offsets)
    if out_valid is not None:
        invalid |= ~out_valid[None, :]
    rows = find_rows(in_keys, q_keys)
    return rows.masked_fill_(invalid, -1)


def _grid_rows(row_grid, mins, grid_shape, tensor_stride, columns) -> torch.Tensor:
    """Rows of query coordinates given as D+1 int32 columns (batch first,
    broadcastable to one shape) in a row grid: -1 where the query is off
    the map's lattice, out of its grid, or an empty cell."""
    cells = math.prod(grid_shape)
    b = columns[0] - mins[0]
    ok = (b >= 0) & (b < grid_shape[0])
    flat = b
    for d, (c, t, e) in enumerate(zip(columns[1:], tensor_stride, grid_shape[1:])):
        rel = c - mins[1 + d]
        if t != 1:
            ok = ok & (torch.remainder(rel, t) == 0)
            rel = torch.div(rel, t, rounding_mode="floor")
        ok = ok & (rel >= 0) & (rel < e)
        flat = flat * e + rel
    flat = torch.where(ok, flat, cells)  # the sentinel cell holds -1
    return row_grid.index_select(0, flat.reshape(-1)).view(flat.shape)


def grid_lookup(row_grid, mins, grid_shape, tensor_stride, q: torch.Tensor) -> torch.Tensor:
    """(...,) int32 rows of (..., D+1) int32 query coordinates in a map,
    through its dense bbox row grid: one gather per query, no search
    (JAX ``grid_lookup``; the reference's hash probes,
    src/coordinate_map_gpu.cu:320-359).

    ``row_grid``: (cells + 1,) int32 from ``coords.grid.build_row_grid``;
    ``mins``: (D+1,) int32 device bbox minima; ``grid_shape``: (B,
    E_1..E_D); ``tensor_stride``: the map's, a D-tuple.  -1 where absent.
    """
    return _grid_rows(row_grid, mins, grid_shape, tensor_stride, q.unbind(-1))


def _build_in_idx_grid(probe, base_coords: torch.Tensor, offsets: np.ndarray, base_valid=None):
    """``_build_in_idx`` through a row grid: rows[k, o] = row of
    (base_coords[o] + offsets[k]) in the probed map, or -1; the plain
    version of the grid-probe kernel (``csrc/grid_probe.cu``).  A direct
    (K, N) gather: each query's coordinates are formed per axis, never as
    one (K, N, D+1) tensor.  ``probe`` = (row_grid, mins, grid_shape,
    tensor_stride) of the probed map; a query outside the packed-key range
    is outside its grid too, so both routes answer -1."""
    row_grid, mins, grid_shape, ts = probe
    offs = K.device_constant(offsets, torch.int32, base_coords.device)
    columns = [base_coords[None, :, d] + offs[:, d, None] for d in range(base_coords.shape[1])]
    rows = _grid_rows(row_grid, mins, grid_shape, ts, columns)
    if base_valid is not None:
        rows.masked_fill_(~base_valid[None, :], -1)
    return rows


def _invert_matching(in_idx: torch.Tensor, n_in: int) -> torch.Tensor:
    """out_idx_t[k, i] = o where in_idx[k, o] == i, else -1.

    The matching is injective per offset, so the scatter writes each slot
    at most once and its result does not depend on write order.  Missing
    pairs land in one spare slot past the end, which is dropped; that keeps
    the build free of host syncs.
    """
    Kv, n_out = in_idx.shape
    dev = in_idx.device
    flat = torch.full((Kv * n_in + 1,), -1, dtype=torch.int32, device=dev)
    base = torch.arange(Kv, device=dev)[:, None] * n_in
    tgt = torch.where(in_idx >= 0, in_idx.long() + base, Kv * n_in)
    o = torch.arange(n_out, dtype=torch.int32, device=dev).expand(Kv, n_out)
    flat.scatter_(0, tgt.reshape(-1), o.reshape(-1))
    return flat[:-1].view(Kv, n_in)


def build_kernel_map(
    in_map: CoordinateMap, out_map: CoordinateMap, offsets: np.ndarray, probe=None, probe_out=None
) -> KernelMap:
    """Dense kernel map for absolute coordinate ``offsets`` ((K, D) or
    (K, D+1) with a leading batch delta).

    Same semantics as the reference's CPU kernel-map construction
    (src/coordinate_map_cpu.hpp:569-670): for every output coordinate and
    offset, probe ``out_coord + offset`` in the input map.  ``probe``: the
    input map's grid probe (row_grid, mins, grid_shape, tensor_stride), in
    place of the key search; ``probe_out``: the output map's, which builds
    ``out_idx_t`` as the rows of ``in_coord - offset`` in the output map
    (the rows are unique, so in_idx[k, o] == i exactly when that row is
    o).  On CUDA tensors the halves with a probe come from one launch of
    the grid-probe kernel (span ``me.coords.kernel_map.grid``); on the CPU
    from ``_build_in_idx_grid``.  Every route gives the same maps index for
    index.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    if offsets.shape[1] == in_map.dimension:  # prepend batch delta 0
        offsets = np.concatenate(
            [np.zeros((offsets.shape[0], 1), np.int64), offsets], axis=1
        )
    routes = build_kernel_map.route_builds
    in_idx = out_idx_t = None
    if out_map.device.type == "cuda" and (probe is not None or probe_out is not None):
        with P.span("coords.kernel_map.grid"):
            in_idx, out_idx_t = _probe_on_card(in_map, out_map, offsets, probe, probe_out)
        routes["kernel"] += (probe is not None) + (probe_out is not None)
    if in_idx is None:
        with P.span("coords.kernel_map.in_idx"):
            if probe is not None:
                in_idx = _build_in_idx_grid(probe, out_map.coordinates, offsets, out_map.valid_mask())
                routes["ops"] += 1
            else:
                offs = K.device_constant(offsets, device=out_map.device)
                in_idx = _build_in_idx(in_map.keys, out_map.coordinates, offs, out_map.valid_mask())
                routes["search"] += 1
    if out_idx_t is None:
        with P.span("coords.kernel_map.out_idx_t"):
            if probe_out is not None:
                out_idx_t = _build_in_idx_grid(
                    probe_out, in_map.coordinates, -offsets, in_map.valid_mask()
                )
                routes["ops"] += 1
            else:
                out_idx_t = _invert_matching(in_idx, in_map.rows)
                routes["search"] += 1
    return KernelMap(in_idx, out_idx_t, in_map.rows, out_map.rows)


def _probe_on_card(in_map, out_map, offsets: np.ndarray, probe, probe_out):
    """(in_idx, out_idx_t) from one launch of the grid-probe kernel
    (``kernels/grid_probe.py``); None for a half without a probe."""
    dev = out_map.device
    halves = {}
    if probe is not None:
        offs = K.device_constant(offsets, torch.int32, dev)
        halves["in"] = GP.Half(probe, out_map.coordinates.contiguous(), offs, out_map.valid_mask())
    if probe_out is not None:
        offs = K.device_constant(-offsets, torch.int32, dev)
        halves["out"] = GP.Half(probe_out, in_map.coordinates.contiguous(), offs, in_map.valid_mask())
    got = dict(zip(halves, GP.grid_probe(*halves.values())))
    return got.get("in"), got.get("out")


build_kernel_map.route_builds = dict.fromkeys(ROUTES, 0)


def build_stride_map(
    in_map: CoordinateMap, out_map: CoordinateMap, out_tensor_stride, probe=None
) -> torch.Tensor:
    """(N_in,) int32: the output row of each input row's strided voxel, or -1.

    Counterpart of ``build_stride_map`` in
    ``minkowskiengine_tpu/coords/kernel_map.py`` (reference: ``stride_map``,
    src/coordinate_map_cpu.hpp:672-722).  ``probe``: the output map's grid
    probe, in place of the key search (JAX ``_stride_in_to_out_grid``).
    """
    c = in_map.coordinates
    stride = K.device_constant(out_tensor_stride, torch.int32, c.device)
    spatial = torch.div(c[:, 1:], stride, rounding_mode="floor") * stride
    queries = torch.cat([c[:, :1], spatial], dim=1)
    in_valid = in_map.valid_mask()
    if probe is not None:
        rows = grid_lookup(*probe, queries)
        return rows if in_valid is None else rows.masked_fill_(~in_valid, -1)
    rows = find_rows(out_map.keys, K.pack(queries))
    invalid = K.overflow_mask(queries)
    if in_valid is not None:
        invalid |= ~in_valid
    return rows.masked_fill_(invalid, -1)


def _collision_rank(in_to_out: torch.Tensor, n_out: int):
    """rank[i] = position of input i among the inputs sharing its output
    row, in input-row order (a stable sort); and the largest count, a 0-d
    device tensor."""
    n_in = in_to_out.shape[0]
    dev = in_to_out.device
    valid = in_to_out >= 0
    tgt = torch.where(valid, in_to_out.long(), n_out)
    sorted_tgt, order = torch.sort(tgt, stable=True)
    is_new = torch.ones_like(sorted_tgt, dtype=torch.bool)
    is_new[1:] = sorted_tgt[1:] != sorted_tgt[:-1]
    pos = torch.arange(n_in, device=dev)
    seg_start = torch.cummax(torch.where(is_new, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - seg_start
    max_rank = torch.where(valid, rank, -1).max() + 1 if n_in else rank.new_zeros(())
    return rank, max_rank


def stride_map_to_kernel_map(
    in_to_out: torch.Tensor, n_in: int, n_out: int, kmax_floor: Optional[int] = None
) -> Tuple[KernelMap, torch.Tensor]:
    """Wrap a many-to-one stride map as a (Kmax, N_out) kernel map.

    Counterpart of ``_stride_map_to_kernel_map`` in
    ``minkowskiengine_tpu/coords/manager.py``.  A stride map sends every
    input row to one output voxel, so colliding inputs go to successive
    slots: slot r holds the r-th input, in input-row order, of each output
    voxel.  Max pooling's tie-break and average pooling's sum order follow
    that order.  ``Kmax`` (most inputs per voxel) is read on the host once,
    when the map is built and cached; geometry replay passes ``kmax_floor``
    instead and checks on the device that it held.  Returns the map and the
    most inputs per voxel, a 0-d device tensor.
    """
    dev = in_to_out.device
    rank, max_rank = _collision_rank(in_to_out, n_out)
    if kmax_floor is None:
        with P.host_read("pool_map.kmax"):
            kmax = max(int(max_rank), 1)
    else:
        kmax = kmax_floor
    valid = in_to_out >= 0
    # a slot past a floor that did not hold is dropped (the check reports it)
    fits = valid & (rank < kmax)
    flat_tgt = torch.where(fits, rank * n_out + in_to_out.long(), kmax * n_out)
    flat = torch.full((kmax * n_out + 1,), -1, dtype=torch.int32, device=dev)
    flat.scatter_(0, flat_tgt, torch.arange(n_in, dtype=torch.int32, device=dev))
    in_idx = flat[:-1].view(kmax, n_out)
    slots = torch.arange(kmax, device=dev)[:, None]
    out_idx_t = torch.where(
        (slots == rank[None, :]) & valid[None, :], in_to_out[None, :], -1
    ).to(torch.int32)
    return KernelMap(in_idx, out_idx_t, n_in, n_out), max_rank
