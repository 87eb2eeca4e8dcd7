"""Batch normalization over sparse-tensor rows.

Counterpart of ``minkowskiengine_tpu/nn/norm.py::MinkowskiBatchNorm``.  Rows
are exact-size, so no padding mask is needed, and the module wraps
``torch.nn.BatchNorm1d`` as ``.bn`` the way the reference does
(MinkowskiNormalization.py:51-98): its state-dict names
(``bn.weight``, ``bn.running_mean``, ...) are the reference's.  Train mode
normalizes with the biased batch variance and updates the running variance
with the unbiased one; eval mode uses the running statistics.
"""

from __future__ import annotations

from torch import nn


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
            device=device,
        )

    def forward(self, input):
        return input._wrap(self.bn(input.F))
