"""Serialized patch attention and the serialized pooling pair (Point
Transformer V3, Wu et al., CVPR 2024, arXiv:2312.10035; Pointcept's
``point_transformer_v3m1_base.py``).

``MinkowskiSerializedAttention``: the qkv Linear, the rows taken in the
order of one space-filling curve and cut into windows (the manager's
window plan, ``coords/serialize.py``), multi-head attention inside each
window, each row's output taken from the first window that holds it, and
the proj Linear.  The attention is the port's fused kernel
(``kernels/attention.py``): on the card one launch a call, full and short
windows together, the plan's gather in its loads; on the CPU its plain
version.

``MinkowskiSerializedPooling``: Linear, then the max over each 2×2×2 cell
(``MinkowskiMaxPooling(2, 2)`` on the manager's stride map: the curve code
shifted right by 3 on a non-negative grid), batch norm and GELU.
``MinkowskiSerializedUnpooling``: Linear, batch norm and GELU on the
coarse tensor and on the skip, and each fine row gets its coarse row's
added, through the same stride map.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.attention import attention
from ..sparse_tensor import SparseTensor
from ..utils import profiling as P
from .nonlinearity import MinkowskiGELU
from .norm import MinkowskiBatchNorm
from .ops import MinkowskiLinear
from .pooling import MinkowskiMaxPooling


def serialized_attention(qkv: torch.Tensor, plan, heads: int, scale: float) -> torch.Tensor:
    """(N, C) attention outputs of (N, 3C) packed q, k, v rows over a
    ``WindowPlan``, each row's output from the first window that holds it
    (``kernels.attention.attention``).  The span ``me.attn.fwd`` holds the
    forward, ``me.attn.bwd`` its backward."""
    with P.attn_part("fwd"):
        return attention(qkv, plan, heads, scale)


class MinkowskiSerializedAttention(nn.Module):
    """Multi-head attention inside windows of ``patch_size`` rows along a
    space-filling curve.  ``forward(input, curve)`` takes the curve (one of
    ``coords.serialize.CURVES``) of this call.  Parameters: ``qkv``
    (C → 3C, with bias) and ``proj`` (C → C), as ``MinkowskiLinear``."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into {num_heads} heads")
        self.channels, self.num_heads, self.patch_size = channels, num_heads, int(patch_size)
        self.scale = (channels // num_heads) ** -0.5
        self.qkv = MinkowskiLinear(channels, 3 * channels, generator=generator, device=device)
        self.proj = MinkowskiLinear(channels, channels, generator=generator, device=device)

    def forward(self, input: SparseTensor, curve: str) -> SparseTensor:
        plan = input.coordinate_manager.window_plan(input.coordinate_map_key, curve,
                                                    self.patch_size)
        qkv = self.qkv(input).F
        out = serialized_attention(qkv, plan, self.num_heads, self.scale)
        return self.proj(input._wrap(out))

    def extra_repr(self):
        return f"channels={self.channels}, heads={self.num_heads}, patch_size={self.patch_size}"


def _linear_bn_gelu(cin, cout, generator, device):
    return nn.Sequential(
        MinkowskiLinear(cin, cout, generator=generator, device=device),
        MinkowskiBatchNorm(cout, eps=1e-3, momentum=0.01, device=device),
        MinkowskiGELU(approximate=False),
    )


class MinkowskiSerializedPooling(nn.Module):
    """Linear, max over each 2×2×2 cell, batch norm (eps 1e-3, momentum
    0.01) and GELU: ``proj``, ``norm``."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.proj = MinkowskiLinear(in_channels, out_channels, generator=generator, device=device)
        self.pool = MinkowskiMaxPooling(kernel_size=2, stride=2, dimension=3)
        self.norm = MinkowskiBatchNorm(out_channels, eps=1e-3, momentum=0.01, device=device)
        self.act = MinkowskiGELU(approximate=False)

    def forward(self, input: SparseTensor) -> SparseTensor:
        return self.act(self.norm(self.pool(self.proj(input))))


class MinkowskiSerializedUnpooling(nn.Module):
    """Linear, batch norm and GELU on the coarse tensor (``proj``) and on
    the skip (``proj_skip``); each fine row of the skip gets its coarse
    row's features added.  ``forward(coarse, skip)``."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.proj = _linear_bn_gelu(in_channels, out_channels, generator, device)
        self.proj_skip = _linear_bn_gelu(skip_channels, out_channels, generator, device)

    def forward(self, coarse: SparseTensor, skip: SparseTensor) -> SparseTensor:
        up = self.proj(coarse).F
        fine = self.proj_skip(skip)
        parent = skip.coordinate_manager.stride_map(skip.coordinate_map_key,
                                                    coarse.coordinate_map_key)
        return fine._wrap(fine.F + up.index_select(0, parent.long()))
