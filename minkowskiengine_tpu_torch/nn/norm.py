"""Normalization over sparse-tensor rows.

Counterpart of ``minkowskiengine_tpu/nn/norm.py``.

``MinkowskiBatchNorm``: rows are exact-size, so no padding mask is needed,
and the module wraps ``torch.nn.BatchNorm1d`` as ``.bn`` the way the
reference does (MinkowskiNormalization.py:51-98): its state-dict names
(``bn.weight``, ``bn.running_mean``, ...) are the reference's.  Train mode
normalizes with the biased batch variance and updates the running variance
with the unbiased one; eval mode uses the running statistics.  It takes a
SparseTensor or a TensorField.

``MinkowskiInstanceNorm``: per batch item (point cloud), the mean and the
biased variance over the item's rows (its origin-map segment), then
``weight`` and ``bias`` of shape (1, C) under the reference's names
(MinkowskiNormalization.py:361-399).

``MinkowskiInstanceNormFunction``: the reference's autograd Function
(MinkowskiNormalization.py:194-310) as an ``.apply`` shim, the same global
pooling and broadcast written in torch ops; autograd gives its backward.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import functional as F
from ..types import resolve_device


class MinkowskiBatchNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        eps: float = 1e-5,
        momentum: float = 0.1,
        affine: bool = True,
        track_running_stats: bool = True,
        device=None,
    ):
        super().__init__()
        self.bn = nn.BatchNorm1d(
            num_features,
            eps=eps,
            momentum=momentum,
            affine=affine,
            track_running_stats=track_running_stats,
            device=resolve_device(device),
        )

    def forward(self, input):
        return input._wrap(self.bn(input.F))


def _instance_normalize(feats, origin_rows, num, eps):
    mean = F.segment_mean(feats, origin_rows, num)
    centered = feats - F.take_rows(mean, origin_rows)
    var = F.segment_mean(centered * centered, origin_rows, num)
    return centered * F.take_rows(torch.rsqrt(var + eps), origin_rows)


class MinkowskiInstanceNormFunction:
    """``apply(in_feat, in_coords_key, glob_coords_key=None,
    coords_manager=None, gpooling_mode=None)``: each batch item's rows
    centred on their mean and scaled by 1/√(biased variance + 1e-8), as
    JAX's shim computes it; an unset ``glob_coords_key`` is set to the
    origin map's key."""

    @staticmethod
    def apply(in_feat, in_coords_key, glob_coords_key=None, coords_manager=None, gpooling_mode=None):
        origin_key, origin_rows = coords_manager.origin_map(in_coords_key)
        if glob_coords_key is not None and not glob_coords_key.is_key_set():
            glob_coords_key.set_key(*origin_key.get_key())
        out = _instance_normalize(in_feat, origin_rows, coords_manager.size(origin_key), 1e-8)
        return torch.where((origin_rows >= 0)[:, None], out, 0.0)


class MinkowskiInstanceNorm(nn.Module):
    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.num_features = int(num_features)
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.ones((1, num_features), device=dev))
        self.bias = nn.Parameter(torch.zeros((1, num_features), device=dev))
        self.eps = 1e-6

    def forward(self, input):
        manager = input.coordinate_manager
        origin_key, origin_rows = manager.origin_map(input.coordinate_map_key)
        out = _instance_normalize(input.F, origin_rows, manager.size(origin_key), self.eps)
        return input._wrap(out * self.weight + self.bias)

    def extra_repr(self):
        return f"nchannels={self.num_features}"


class MinkowskiStableInstanceNorm(MinkowskiInstanceNorm):
    """The reference's numerically stabilized form (MinkowskiNormalization.py:
    313-360); the base class already centers before it squares."""
