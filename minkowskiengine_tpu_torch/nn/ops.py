"""Tensor combinators.

Counterpart of ``minkowskiengine_tpu/nn/ops.py``; only ``cat`` (the UNet skip
join) is ported so far.
"""

from __future__ import annotations

import torch


def _check_same_key(*tensors):
    key = tensors[0].coordinate_map_key
    for t in tensors[1:]:
        if t.coordinate_map_key != key:
            raise ValueError(
                "All inputs must share the same coordinate_map_key; use "
                "MinkowskiUnion for mixed-coordinate combination"
            )


def cat(*sparse_tensors):
    """Concatenate the features of same-coordinate tensors
    (reference: MinkowskiOps.py:70-128)."""
    if len(sparse_tensors) == 1 and isinstance(sparse_tensors[0], (list, tuple)):
        sparse_tensors = tuple(sparse_tensors[0])
    _check_same_key(*sparse_tensors)
    out = torch.cat([t.F for t in sparse_tensors], dim=1)
    return sparse_tensors[0]._wrap(out)
