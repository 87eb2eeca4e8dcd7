"""Batched coordinate lookup by binary search.

Counterpart of ``minkowskiengine_tpu/coords/lookup.py::find_rows``: a
lower-bound search of query keys in a map's ascending unique keys.  One-word
keys (D <= 6) take ``torch.searchsorted``; multi-word keys (D >= 7) take
the JAX package's ``find_lower_bound``: ⌈log₂(M+1)⌉ fixed steps of gather
and lexicographic compare, with no host sync, so that a CUDA graph can
capture it.  The other route to the same answer, a gather from a map's
dense bbox row grid, is ``kernel_map.py::grid_lookup``; the manager takes
it for every map whose grid fits.  The JAX package's tile join is a TPU
strategy for the same answer and is not ported.
"""

from __future__ import annotations

import torch

from .keys import key_less


def _lower_bound(words, q_words, n: int) -> torch.Tensor:
    """Rows of the map below each query: the largest count p with
    ``map[p - 1] < q``, built from the top bit down.  ``words`` are the
    map's L words as contiguous (M,) columns and ``q_words`` the queries'
    (...,) words: on the card, gathering one word at a time is far faster
    than gathering (M, L) rows (``tools/profile_request.py`` step 13)."""
    pos = torch.zeros(q_words[0].shape, dtype=torch.int64, device=q_words[0].device)
    step = 1 << (n.bit_length() - 1)
    while step:
        cand = pos + step
        at = (cand - 1).clamp_max(n - 1)
        below = key_less([w[at] for w in words], q_words) & (cand <= n)
        pos = torch.where(below, cand, pos)
        step >>= 1
    return pos


def find_rows(map_keys: torch.Tensor, q_keys: torch.Tensor) -> torch.Tensor:
    """Row of each query key in the sorted map, or -1 (int32).  Keys are
    (M,) and (...,), or (M, L) and (..., L) words; the result has the
    queries' shape without the word axis."""
    n = map_keys.shape[0]
    words = map_keys.dim() == 2
    shape = q_keys.shape[:-1] if words else q_keys.shape
    if n == 0:
        return torch.full(shape, -1, dtype=torch.int32, device=q_keys.device)
    if not words:
        pos = torch.searchsorted(map_keys, q_keys, out_int32=True)
        safe = pos.clamp_max(n - 1)
        found = (pos < n) & (map_keys[safe] == q_keys)
        return torch.where(found, safe, -1)
    columns = [w.contiguous() for w in map_keys.unbind(1)]
    q_words = q_keys.unbind(-1)
    pos = _lower_bound(columns, q_words, n)
    safe = pos.clamp_max(n - 1)
    found = pos < n
    for w, q in zip(columns, q_words):
        found &= w[safe] == q
    return torch.where(found, safe, -1).to(torch.int32)
