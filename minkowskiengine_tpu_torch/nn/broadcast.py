"""Broadcast: combine each batch item's global row with the item's rows.

Counterpart of ``minkowskiengine_tpu/nn/broadcast.py`` (reference:
MinkowskiEngine/MinkowskiBroadcast.py:40-253).  The global tensor sits on
the input's origin map (one row per batch item, as global pooling gives
it); each row reads its origin row.  Autograd gives the backward, which
the reference hand-writes (src/broadcast_kernel.cu).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import functional as F
from ..sparse_tensor import SparseTensor, whole_rows
from ..types import BroadcastMode

_OPS = {BroadcastMode.ELEMENTWISE_ADDITON: "add", BroadcastMode.ELEMENTWISE_MULTIPLICATION: "mul"}


def _origin_rows(input: SparseTensor):
    whole_rows(input, "broadcast")
    return input.coordinate_manager.origin_map(input.coordinate_map_key)


class MinkowskiBroadcastBase(nn.Module):
    """``forward(input, input_glob)``: ``input`` combined row by row with its
    batch item's row of ``input_glob`` by ``operation_type``."""

    def __init__(self, operation_type: BroadcastMode):
        super().__init__()
        self.operation_type = operation_type

    def forward(self, input: SparseTensor, input_glob: SparseTensor) -> SparseTensor:
        if input.F.shape[1] != input_glob.F.shape[1]:
            raise ValueError("channel mismatch between input and global tensor")
        origin_key, origin_rows = _origin_rows(input)
        if (input_glob.coordinate_map_key != origin_key
                and input_glob.size != input.coordinate_manager.size(origin_key)):
            raise ValueError("input_glob must have one row per batch index of input")
        return input._wrap(
            F.broadcast(input.F, input_glob.F, origin_rows, _OPS[self.operation_type])
        )


class MinkowskiBroadcastAddition(MinkowskiBroadcastBase):
    """out[p] = in[p] + glob[batch(p)] (reference: MinkowskiBroadcast.py:129)."""

    def __init__(self):
        super().__init__(BroadcastMode.ELEMENTWISE_ADDITON)


class MinkowskiBroadcastMultiplication(MinkowskiBroadcastBase):
    """out[p] = in[p] * glob[batch(p)] (reference: MinkowskiBroadcast.py:153)."""

    def __init__(self):
        super().__init__(BroadcastMode.ELEMENTWISE_MULTIPLICATION)


class MinkowskiBroadcast(nn.Module):
    """Every row replaced by its batch item's global row (reference:
    MinkowskiBroadcast.py:177-217)."""

    def forward(self, input: SparseTensor, input_glob: SparseTensor) -> SparseTensor:
        return input._wrap(F.take_rows(input_glob.F, _origin_rows(input)[1]))


class MinkowskiBroadcastConcatenation(MinkowskiBroadcast):
    """The batch item's global row concatenated onto every row (reference:
    MinkowskiBroadcast.py:218-253)."""

    def forward(self, input: SparseTensor, input_glob: SparseTensor) -> SparseTensor:
        glob = F.take_rows(input_glob.F, _origin_rows(input)[1])
        return input._wrap(torch.cat([input.F, glob], dim=1))


class MinkowskiBroadcastFunction:
    """Functional shim of the reference's autograd Function
    (MinkowskiBroadcast.py:40-96): the combined features."""

    @staticmethod
    def apply(input_features, input_features_global, operation_type,
              in_coordinate_map_key, glob_coordinate_map_key, coordinate_manager):
        _, origin_rows = coordinate_manager.origin_map(in_coordinate_map_key)
        return F.broadcast(input_features, input_features_global, origin_rows, _OPS[operation_type])
