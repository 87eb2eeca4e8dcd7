"""Coordinate → packed int64 key words.

Counterpart of ``minkowskiengine_tpu/coords/keys.py``.  The JAX package
packs each ``(batch, x_1..x_D)`` row into a tuple of uint32 lanes compared
lexicographically without sign: 2 lanes for D <= 6, 3 for 7 <= D <= 13,
and beyond that as many as keep >= 12 bits per dimension.  PyTorch sorts
and searches int64, which compares with sign, so the port packs the same
fields (the same ``bit_allocation``) into int64 words:

* D <= 6: one int64 key per row, shape ``(...,)``.  The batch field sits in
  the top bits shifted down by half its range, ``(batch -
  2**(batch_bits-1))``, and each spatial coordinate below it biased by
  ``2**(dim_bits-1)``.  That maps the unsigned key order onto the signed
  one exactly.
* D >= 7: ``L = n_words(D)`` int64 words per row, shape ``(..., L)``, most
  significant word first.  Whole fields fill each word in field order
  (batch, x_1, ..., x_D) up to 63 bits, so no field straddles two words;
  each word's top field is shifted down by half its range as the batch
  field is at D <= 6, so every word of a valid row lies in [-2**62,
  2**62).

Either way ascending keys (words compared lexicographically) give the JAX
package's canonical batch-major order, so maps sort into the same order and
rows match the JAX package index for index, and packing stays additive
word by word (``pack_offsets``).  The row primitives below (``sort_keys``,
``keys_differ``, ``is_pad``, ``mask_keys``, ``pad_keys``, ``gather_keys``)
take either shape, so callers never branch on L; ``key_less`` compares
keys given as sequences of word arrays.

Bit budget (``bit_allocation``) is the JAX package's: D <= 3 uses 16 batch
bits and 16 bits per coordinate (±32768), 4 <= D <= 6 uses 12 batch bits
and ``52 // D`` bits per coordinate, 7 <= D <= 13 16 batch bits and ``80 //
D`` (±1024 at D = 7, ±32 at D = 13), D >= 14 16 batch bits and at least 12
per coordinate (±2048 at D = 14, ±4096 at D = 16).  Out-of-range rows are
reported by ``overflow_mask``.

``PAD_KEY``, the largest int64, tags the padded tail of a map built at a
fixed capacity (geometry replay), in every word of a padded row: it sorts
after every real key and never matches a query.  At D <= 6 it is the
packing of the one maximal tuple at a full 64-bit budget, which
``overflow_mask`` refuses as the JAX package refuses its padding key; at a
smaller budget, and in every word at D >= 7, each valid key lies below it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

PAD_KEY = torch.iinfo(torch.int64).max
WORD_BITS = 63  # bits of fields per word at D >= 7


@functools.lru_cache(maxsize=None)
def _jax_lanes(dimension: int) -> int:
    """The JAX package's uint32 lane count (its ``n_lanes``): it sets the
    bit budget and the maximal-tuple rule, whatever the port's words."""
    if dimension <= 6:
        return 2
    if dimension <= 13:
        return 3
    return -(-(16 + 12 * dimension) // 32)


@functools.lru_cache(maxsize=None)
def bit_allocation(dimension: int) -> Tuple[int, ...]:
    """Per-field bit widths ``(batch_bits, dim_bits * D)`` for D dims."""
    if dimension < 1:
        raise ValueError(f"dimension must be >= 1, got {dimension}")
    if dimension <= 3:
        return (16,) + (16,) * dimension
    if dimension <= 6:
        return (12,) + ((64 - 12) // dimension,) * dimension
    return (16,) + ((32 * _jax_lanes(dimension) - 16) // dimension,) * dimension


@functools.lru_cache(maxsize=None)
def _layout(dimension: int) -> Tuple[Tuple[Tuple[int, int, int], ...], ...]:
    """Per word, most significant first, its fields as (field, bits, lsb
    position), top field first."""
    bits = bit_allocation(dimension)
    cap = 64 if sum(bits) <= 64 else WORD_BITS
    groups, used = [[]], 0
    for f, b in enumerate(bits):
        if used + b > cap:
            groups.append([])
            used = 0
        groups[-1].append((f, b))
        used += b
    words = []
    for group in groups:
        pos = sum(b for _, b in group)
        fields = []
        for f, b in group:
            pos -= b
            fields.append((f, b, pos))
        words.append(tuple(fields))
    return tuple(words)


def n_words(dimension: int) -> int:
    """int64 words per key: 1 (a ``(...,)`` key) for D <= 6, else L (a
    ``(..., L)`` key)."""
    return len(_layout(dimension))


def field_ranges(dimension: int) -> Tuple[Tuple[int, int], ...]:
    """Valid [lo, hi] inclusive range per field (batch, then spatial dims)."""
    bits = bit_allocation(dimension)
    out = [(0, 2 ** bits[0] - 1)]
    for b in bits[1:]:
        bias = 2 ** (b - 1)
        out.append((-bias, bias - 1))
    return tuple(out)


def _words(words) -> torch.Tensor:
    """One word array as the ``(...,)`` key, several stacked on a last axis."""
    return words[0] if len(words) == 1 else torch.stack(words, dim=-1)


def pack(coords: torch.Tensor) -> torch.Tensor:
    """Pack integer ``(..., D+1)`` batch-first coordinates into int64 keys:
    ``(...,)`` for D <= 6, ``(..., L)`` words for D >= 7.

    Ascending keys give the JAX package's canonical order.  Injective over
    the valid ranges; rows flagged by ``overflow_mask`` pack to garbage.
    """
    c = coords.to(torch.int64)
    words = []
    for fields in _layout(coords.shape[-1] - 1):
        (f, b, pos), rest = fields[0], fields[1:]
        bias = 0 if f == 0 else 2 ** (b - 1)
        top = ((c[..., f] + bias) & (2**b - 1)) - 2 ** (b - 1)
        # a multiply, not a shift: the top field is negative for half its range
        word = top * (2**pos)
        for f, b, pos in rest:
            word = word | (((c[..., f] + 2 ** (b - 1)) & (2**b - 1)) << pos)
        words.append(word)
    return _words(words)


def _maximal_tuple_rule(dimension: int) -> bool:
    """The JAX package rejects the single maximal tuple when its lanes are
    full (it would equal its padding key); the port rejects it too, so that
    both packages accept the same coordinates."""
    return sum(bit_allocation(dimension)) == 32 * _jax_lanes(dimension)


def overflow_mask(coords: torch.Tensor) -> torch.Tensor:
    """Boolean ``(...,)`` mask of rows whose fields exceed the bit budget."""
    D = coords.shape[-1] - 1
    ranges = field_ranges(D)
    c = coords.to(torch.int64)
    bad = torch.zeros(coords.shape[:-1], dtype=torch.bool, device=coords.device)
    for f, (lo_v, hi_v) in enumerate(ranges):
        bad = bad | (c[..., f] < lo_v) | (c[..., f] > hi_v)
    if _maximal_tuple_rule(D):
        is_max = torch.ones_like(bad)
        for f, (_, hi_v) in enumerate(ranges):
            is_max = is_max & (c[..., f] == hi_v)
        bad = bad | is_max
    return bad


def pack_offsets(offsets: torch.Tensor) -> torch.Tensor:
    """Key deltas of (K, D+1) coordinate offsets, (K,) or (K, L) as ``pack``:
    for a query ``c + o`` inside the bit budget, packing is additive field
    by field and no field crosses a word, so ``pack(c + o) == pack(c) +
    pack_offsets(o)`` word by word (int64 arithmetic wraps, and the true
    sum is a valid key).  A query outside the budget gets a meaningless
    key: ``overflow_mask_of_sum`` flags it."""
    o = offsets.to(torch.int64)
    words = []
    for fields in _layout(offsets.shape[-1] - 1):
        delta = torch.zeros(o.shape[:-1], dtype=torch.int64, device=o.device)
        for f, _, pos in fields:
            delta = delta + o[..., f] * (2**pos)
        words.append(delta)
    return _words(words)


def overflow_mask_of_sum(coords: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``overflow_mask(coords[None] + offsets[:, None])`` as a (K, N) bool,
    without the (K, N, D+1) sums: each field's bounds move by the offset."""
    D = coords.shape[-1] - 1
    ranges = field_ranges(D)
    c = coords.to(torch.int64)
    o = offsets.to(torch.int64)
    bad = torch.zeros((o.shape[0], c.shape[0]), dtype=torch.bool, device=c.device)
    for f, (lo_v, hi_v) in enumerate(ranges):
        bad |= c[None, :, f] < (lo_v - o[:, f])[:, None]
        bad |= c[None, :, f] > (hi_v - o[:, f])[:, None]
    if _maximal_tuple_rule(D):
        is_max = torch.ones_like(bad)
        for f, (_, hi_v) in enumerate(ranges):
            is_max &= c[None, :, f] == (hi_v - o[:, f])[:, None]
        bad |= is_max
    return bad


# Row primitives.  ``keys`` holds one row per index of its first axis: a
# (N,) key or (N, L) words; they never branch on L beyond the word axis.
def sort_keys(keys: torch.Tensor):
    """(ascending keys, order): a stable sort, so equal keys keep their
    input order; L stable passes, least significant word first."""
    if keys.dim() == 1:
        return torch.sort(keys, stable=True)
    order = torch.arange(keys.shape[0], device=keys.device)
    for column in reversed(keys.unbind(1)):
        order = order[torch.sort(column[order], stable=True).indices]
    return keys[order], order


def keys_differ(s_keys: torch.Tensor) -> torch.Tensor:
    """(N-1,) bool: row i+1's key differs from row i's."""
    d = s_keys[1:] != s_keys[:-1]
    return d if d.dim() == 1 else d.any(dim=1)


def is_pad(keys: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the row is padding (``PAD_KEY``)."""
    p = keys == PAD_KEY
    return p if p.dim() == 1 else p[:, 0]


def mask_keys(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``keys`` with ``PAD_KEY`` in every word of the rows where ``valid``
    is false."""
    return torch.where(valid.view(valid.shape + (1,) * (keys.dim() - 1)), keys, PAD_KEY)


def pad_keys(like: torch.Tensor, rows: int) -> torch.Tensor:
    """``rows`` padding rows (``PAD_KEY`` in every word) shaped as ``like``'s."""
    return like.new_full((rows,) + tuple(like.shape[1:]), PAD_KEY)


def gather_keys(keys: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The keys of ``rows`` (any shape of row indices)."""
    return keys[rows]


def key_less(a, b) -> torch.Tensor:
    """``a < b`` lexicographically over two sequences of L word arrays
    (most significant first; ``keys.unbind(-1)`` of (..., L) keys)."""
    less = a[-1] < b[-1]
    for aw, bw in zip(reversed(a[:-1]), reversed(b[:-1])):
        less = (aw < bw) | ((aw == bw) & less)
    return less


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
