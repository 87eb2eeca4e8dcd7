"""Batched coordinate lookup by binary search.

Counterpart of ``minkowskiengine_tpu/coords/lookup.py::find_rows``: a
lower-bound search of query keys in a map's ascending unique keys.  The JAX
package's tile-join and grid-probe lookups are TPU strategies for the same
answer and are not ported.
"""

from __future__ import annotations

import torch


def find_rows(map_keys: torch.Tensor, q_keys: torch.Tensor) -> torch.Tensor:
    """Row of each query key in the sorted map, or -1 (int32, q's shape)."""
    n = map_keys.shape[0]
    if n == 0:
        return torch.full(q_keys.shape, -1, dtype=torch.int32, device=q_keys.device)
    pos = torch.searchsorted(map_keys, q_keys, out_int32=True)
    safe = pos.clamp_max(n - 1)
    found = (pos < n) & (map_keys[safe] == q_keys)
    return torch.where(found, safe, -1)
