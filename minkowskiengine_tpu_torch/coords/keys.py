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
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

MAX_DIMENSION = 6


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
