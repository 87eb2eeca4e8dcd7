"""Union: sum sparse tensors over the union of their coordinates.

Counterpart of ``minkowskiengine_tpu/nn/union.py`` (reference:
MinkowskiEngine/MinkowskiUnion.py:33-156).  Each tensor's rows are unique,
so the reference's scatter-add per tensor is a gather per tensor and a sum;
autograd gives the gradient.
"""

from __future__ import annotations

from torch import nn

from ..ops import functional as F
from ..sparse_tensor import SparseTensor, _invert_union_map, whole_rows
from ..utils import profiling as P


class MinkowskiUnion(nn.Module):
    """``forward(*inputs)``: one tensor on the ``merged`` map of the inputs'
    coordinates, each row the sum of the inputs that have it."""

    def forward(self, *inputs: SparseTensor) -> SparseTensor:
        if len(inputs) == 0:
            raise ValueError("MinkowskiUnion requires at least one input")
        for x in inputs:
            if not isinstance(x, SparseTensor):
                raise TypeError("All inputs must be SparseTensors")
            whole_rows(x, "union")
            if x.coordinate_manager is not inputs[0].coordinate_manager:
                raise ValueError("All inputs must share a coordinate manager")
            if x.tensor_stride != inputs[0].tensor_stride:
                raise ValueError("All inputs must share a tensor stride")
            if x.F.shape[1] != inputs[0].F.shape[1]:
                raise ValueError("All inputs must share the channel size")
        with P.span("nn.union"):
            manager = inputs[0].coordinate_manager
            keys = [x.coordinate_map_key for x in inputs]
            union_key = manager.merge(keys)
            out = MinkowskiUnionFunction.apply(keys, union_key, manager, *(x.F for x in inputs))
            return SparseTensor(out, coordinate_map_key=union_key, coordinate_manager=manager)


class MinkowskiUnionFunction:
    """Functional shim of the reference's autograd Function
    (MinkowskiUnion.py:33-83): the features summed onto the rows of
    ``out_coords_key``."""

    @staticmethod
    def apply(in_coords_keys, out_coords_key, coordinate_manager, *in_feats):
        if len(in_feats) != len(in_coords_keys):
            raise ValueError("The input features and keys must have the same length")
        n = coordinate_manager.size(out_coords_key)
        maps = coordinate_manager.union_map(list(in_coords_keys), out_coords_key)
        return F.union_features(list(in_feats), [_invert_union_map(m, n) for m in maps])
