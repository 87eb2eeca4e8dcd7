"""Coordinate → packed int64 key.

Counterpart of ``minkowskiengine_tpu/coords/keys.py``.  The JAX package
packs each ``(batch, x_1..x_D)`` row into uint32 lanes compared without
sign: for D <= 6, one 64-bit key with the batch field in the top bits and
each spatial coordinate biased by ``2**(dim_bits-1)``.  PyTorch sorts and
searches int64, which compares with sign, so the port stores the batch
field shifted down by half its range: ``(batch - 2**(batch_bits-1))`` in
the top bits.  That maps the unsigned key order onto the signed one
exactly, so maps sort into the same canonical batch-major order and rows
match the JAX package index for index.

Bit budget (``bit_allocation``) is the JAX package's: D <= 3 uses 16 batch
bits and 16 bits per coordinate (±32768), 4 <= D <= 6 uses 12 batch bits
and ``52 // D`` bits per coordinate.  Wider dimensions need multi-word keys
and are not ported.  Out-of-range rows are reported by ``overflow_mask``.

``PAD_KEY``, the largest int64, tags the padded tail of a map built at a
fixed capacity (geometry replay): it sorts after every real key and never
matches a query.  It is the packing of the one maximal tuple at a full
64-bit budget, which ``overflow_mask`` refuses as the JAX package refuses
its padding key; at a smaller budget every valid key lies below it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

MAX_DIMENSION = 6
PAD_KEY = torch.iinfo(torch.int64).max


@functools.lru_cache(maxsize=None)
def bit_allocation(dimension: int) -> Tuple[int, ...]:
    """Per-field bit widths ``(batch_bits, dim_bits * D)`` for D dims."""
    if dimension < 1:
        raise ValueError(f"dimension must be >= 1, got {dimension}")
    if dimension > MAX_DIMENSION:
        raise NotImplementedError(
            f"dimension {dimension} needs multi-word keys; the port packs "
            f"one int64 key and supports D <= {MAX_DIMENSION}"
        )
    if dimension <= 3:
        return (16,) + (16,) * dimension
    batch_bits = 12
    return (batch_bits,) + ((64 - batch_bits) // dimension,) * dimension


def field_ranges(dimension: int) -> Tuple[Tuple[int, int], ...]:
    """Valid [lo, hi] inclusive range per field (batch, then spatial dims)."""
    bits = bit_allocation(dimension)
    out = [(0, 2 ** bits[0] - 1)]
    for b in bits[1:]:
        bias = 2 ** (b - 1)
        out.append((-bias, bias - 1))
    return tuple(out)


def pack(coords: torch.Tensor) -> torch.Tensor:
    """Pack integer ``(..., D+1)`` batch-first coordinates into int64 keys.

    Ascending keys give the JAX package's canonical order.  Injective over
    the valid ranges; rows flagged by ``overflow_mask`` pack to garbage.
    """
    D = coords.shape[-1] - 1
    bits = bit_allocation(D)
    c = coords.to(torch.int64)
    pos = sum(bits) - bits[0]
    batch = (c[..., 0] & (2 ** bits[0] - 1)) - 2 ** (bits[0] - 1)
    # a multiply, not a shift: the batch term is negative for half the range
    key = batch * (2**pos)
    for f in range(1, D + 1):
        b = bits[f]
        pos -= b
        key = key | (((c[..., f] + 2 ** (b - 1)) & (2**b - 1)) << pos)
    return key


def overflow_mask(coords: torch.Tensor) -> torch.Tensor:
    """Boolean ``(...,)`` mask of rows whose fields exceed the bit budget."""
    D = coords.shape[-1] - 1
    ranges = field_ranges(D)
    c = coords.to(torch.int64)
    bad = torch.zeros(coords.shape[:-1], dtype=torch.bool, device=coords.device)
    for f, (lo_v, hi_v) in enumerate(ranges):
        bad = bad | (c[..., f] < lo_v) | (c[..., f] > hi_v)
    if sum(bit_allocation(D)) == 64:
        # The JAX package rejects the single maximal tuple at a full 64-bit
        # budget (it would equal its padding key); reject it here too so
        # both packages accept the same coordinates.
        is_max = torch.ones_like(bad)
        for f, (_, hi_v) in enumerate(ranges):
            is_max = is_max & (c[..., f] == hi_v)
        bad = bad | is_max
    return bad


def pack_offsets(offsets: torch.Tensor) -> torch.Tensor:
    """(K,) int64 key deltas of (K, D+1) coordinate offsets: for a query
    ``c + o`` inside the bit budget, packing is additive field by field, so
    ``pack(c + o) == pack(c) + pack_offsets(o)`` (int64 arithmetic wraps,
    and the true sum is a valid key).  A query outside the budget gets a
    meaningless key: ``overflow_mask_of_sum`` flags it."""
    bits = bit_allocation(offsets.shape[-1] - 1)
    o = offsets.to(torch.int64)
    pos = sum(bits)
    delta = torch.zeros(o.shape[:-1], dtype=torch.int64, device=o.device)
    for f, b in enumerate(bits):
        pos -= b
        delta = delta + o[..., f] * (2**pos)
    return delta


def overflow_mask_of_sum(coords: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``overflow_mask(coords[None] + offsets[:, None])`` as a (K, N) bool,
    without the (K, N, D+1) sums: each field's bounds move by the offset."""
    ranges = field_ranges(coords.shape[-1] - 1)
    c = coords.to(torch.int64)
    o = offsets.to(torch.int64)
    bad = torch.zeros((o.shape[0], c.shape[0]), dtype=torch.bool, device=c.device)
    for f, (lo_v, hi_v) in enumerate(ranges):
        bad |= c[None, :, f] < (lo_v - o[:, f])[:, None]
        bad |= c[None, :, f] > (hi_v - o[:, f])[:, None]
    if sum(bit_allocation(coords.shape[-1] - 1)) == 64:  # the maximal tuple, as overflow_mask
        is_max = torch.ones_like(bad)
        for f, (_, hi_v) in enumerate(ranges):
            is_max &= c[None, :, f] == (hi_v - o[:, f])[:, None]
        bad |= is_max
    return bad


@functools.lru_cache(maxsize=512)
def _constant(data: bytes, shape: Tuple[int, ...], dtype: str, device: str) -> torch.Tensor:
    host = torch.frombuffer(bytearray(data), dtype=getattr(torch, dtype)).reshape(shape)
    return host.to(device)


def device_constant(values, dtype=torch.int64, device="cpu") -> torch.Tensor:
    """A small host array (offsets, strides) as a tensor on ``device``,
    copied there once and cached: a CUDA graph cannot capture a copy from
    host memory, so the coordinate ops take their constants from here.
    The tensor is shared: never write to it."""
    name = str(dtype).replace("torch.", "")
    arr = np.ascontiguousarray(values, dtype=name)
    return _constant(arr.tobytes(), arr.shape, name, str(torch.device(device)))
