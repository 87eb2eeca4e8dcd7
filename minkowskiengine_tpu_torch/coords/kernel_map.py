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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import keys as K
from .lookup import find_rows
from .map import CoordinateMap


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


def _build_queries(out_coords: torch.Tensor, offsets: torch.Tensor):
    """Probe keys (K, N_out) and their overflow mask."""
    queries = out_coords.to(torch.int64)[None, :, :] + offsets[:, None, :]
    return K.pack(queries), K.overflow_mask(queries)


def _build_in_idx(
    in_keys: torch.Tensor, out_coords: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """in_idx[k, o] = row of (out_coords[o] + offsets[k]) in the in-map, or -1."""
    q_keys, invalid = _build_queries(out_coords, offsets)
    rows = find_rows(in_keys, q_keys)
    return rows.masked_fill_(invalid, -1)


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
    in_map: CoordinateMap, out_map: CoordinateMap, offsets: np.ndarray
) -> KernelMap:
    """Dense kernel map for absolute coordinate ``offsets`` ((K, D) or
    (K, D+1) with a leading batch delta).

    Same semantics as the reference's CPU kernel-map construction
    (src/coordinate_map_cpu.hpp:569-670): for every output coordinate and
    offset, probe ``out_coord + offset`` in the input map.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    if offsets.shape[1] == in_map.dimension:  # prepend batch delta 0
        offsets = np.concatenate(
            [np.zeros((offsets.shape[0], 1), np.int64), offsets], axis=1
        )
    offs = torch.as_tensor(offsets, device=out_map.device)
    in_idx = _build_in_idx(in_map.keys, out_map.coordinates, offs)
    out_idx_t = _invert_matching(in_idx, in_map.size)
    return KernelMap(in_idx, out_idx_t, in_map.size, out_map.size)
