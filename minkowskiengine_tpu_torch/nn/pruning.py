"""Pruning: keep the rows of a sparse tensor where a mask is true.

Counterpart of ``minkowskiengine_tpu/nn/pruning.py`` (reference:
MinkowskiEngine/MinkowskiPruning.py:38-121).  The coordinate manager
builds the pruned map; the feature copy is a row gather, so autograd
gives its gradient (the reference hand-writes the scatter,
src/pruning_cpu.cpp:43-140).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import functional as F
from ..sparse_tensor import SparseTensor, whole_rows
from ..utils import profiling as P


class MinkowskiPruning(nn.Module):
    """``forward(input, mask)``: the rows of ``input`` where the (N,) mask
    is true, on a new coordinate map, in their sorted order."""

    def forward(self, input: SparseTensor, mask) -> SparseTensor:
        whole_rows(input, "pruning")
        with P.span("nn.prune"):
            manager = input.coordinate_manager
            new_key, _, out_from_in = manager.prune(input.coordinate_map_key, torch.as_tensor(mask))
            return SparseTensor(
                F.prune_features(input.F, out_from_in),
                coordinate_map_key=new_key,
                coordinate_manager=manager,
            )


class MinkowskiPruningFunction:
    """Functional shim of the reference's autograd Function
    (MinkowskiPruning.py:38-74).  ``out_coords_key``, when given and unset,
    is filled with the pruned map's key, as the reference fills its out key
    in place; when set, it must be that key."""

    @staticmethod
    def apply(in_feat, mask, in_coords_key, out_coords_key=None, coords_manager=None):
        new_key, _, out_from_in = coords_manager.prune(in_coords_key, torch.as_tensor(mask))
        if out_coords_key is not None:
            if not out_coords_key.is_key_set():
                out_coords_key.set_key(*new_key.get_key())
            elif out_coords_key != new_key:
                raise ValueError("out_coords_key does not match the pruned map for this mask")
        return F.prune_features(in_feat, out_from_in)
