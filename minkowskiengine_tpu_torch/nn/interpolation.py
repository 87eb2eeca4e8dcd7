"""Interpolation: a sparse tensor's features sampled at float points.

Counterpart of ``minkowskiengine_tpu/nn/interpolation.py`` (reference:
MinkowskiEngine/MinkowskiInterpolation.py:39-131).  The manager gives each
point's 2^D corner rows and multilinear weights; the features are a
weighted sum of row gathers, so autograd gives their gradient.  No
gradient reaches the coordinates.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import functional as F
from ..sparse_tensor import SparseTensor, whole_rows
from ..utils import profiling as P


class MinkowskiInterpolationFunction:
    """Functional shim of the reference's autograd Function
    (MinkowskiInterpolation.py:39-85).  Returns ``(out, in_map, out_map,
    weights)``: the (N * 2^D,) corner rows (-1 where absent, kept as JAX
    keeps them), the point of each, and the weights (0 where absent)."""

    @staticmethod
    def apply(input_features, tfield, in_coordinate_map_key, coordinate_manager):
        rows, weights = coordinate_manager.interpolation_map_weight(in_coordinate_map_key, tfield)
        out = F.interpolate_features(input_features, rows, weights)
        n, c = rows.shape
        out_map = torch.arange(n, dtype=torch.int32, device=rows.device).repeat_interleave(c)
        return out, rows.reshape(-1), out_map, weights.reshape(-1)


class MinkowskiInterpolation(nn.Module):
    """``forward(input, tfield)``: the (N, ch) features of ``input`` at the
    (N, D+1) float points ``tfield``, batch first; with
    ``return_kernel_map`` also ``(in_map, out_map)``, with
    ``return_weights`` also the weights (reference:
    MinkowskiInterpolation.py:88-131)."""

    def __init__(self, return_kernel_map: bool = False, return_weights: bool = False):
        super().__init__()
        self.return_kernel_map = bool(return_kernel_map)
        self.return_weights = bool(return_weights)

    def forward(self, input: SparseTensor, tfield):
        whole_rows(input, "interpolation")
        with P.span("nn.interpolate"):
            out, in_map, out_map, weights = MinkowskiInterpolationFunction.apply(
                input.F, tfield, input.coordinate_map_key, input.coordinate_manager
            )
        returns = [out]
        if self.return_kernel_map:
            returns.append((in_map, out_map))
        if self.return_weights:
            returns.append(weights)
        return returns[0] if len(returns) == 1 else tuple(returns)
