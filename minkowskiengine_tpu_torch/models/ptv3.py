"""Point Transformer V3, the segmentation backbone and its head.

Wu et al., *Point Transformer V3: Simpler, Faster, Stronger*, CVPR 2024
(arXiv:2312.10035); the configuration of Pointcept's
``configs/scannet/semseg-pt-v3m1-0-base.py`` (``PT-v3m1`` with a Linear
head, ScanNet's 20 classes).  The stem is a 5³ submanifold conv without
bias, batch norm and GELU.  Each block is a conditional positional
encoding (a 3³ submanifold conv with bias, Linear, LayerNorm) as a
residual, then pre-norm serialized patch attention and a pre-norm MLP of
ratio 4 with GELU, each a residual.  Block i of a level attends along
curve ``i % 4`` of that level's order list.  Between levels,
``MinkowskiSerializedPooling`` down and ``MinkowskiSerializedUnpooling`` up;
decoder level s reuses encoder level s's maps and order list.

Published defaults: encoder depths (2, 2, 2, 6, 2), channels (32, 64, 128,
256, 512), heads (2, 4, 8, 16, 32); decoder depths (2, 2, 2, 2), channels
(64, 64, 128, 256), heads (4, 4, 8, 16); windows of 1024 rows; batch norm
eps 1e-3, momentum 0.01; LayerNorm eps 1e-5; exact GELU.  Departure:
drop path is 0 (published 0.3), a per-row mask that changes no work.

``forward(x, orders=None)``: ``orders`` is the step's order lists, one
permutation of ``coords.serialize.CURVES`` per level (5 by default), as
indices or curve names; by default each is drawn with ``torch.randperm``
from torch's generator, as Pointcept shuffles them.  The input's
coordinates are non-negative grid cells (``coords/serialize.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..coords.serialize import CURVES
from ..nn.conv import MinkowskiConvolution
from ..nn.nonlinearity import MinkowskiGELU
from ..nn.norm import MinkowskiBatchNorm, MinkowskiLayerNorm
from ..nn.ops import MinkowskiLinear
from ..nn.serialized import (
    MinkowskiSerializedAttention, MinkowskiSerializedPooling, MinkowskiSerializedUnpooling,
)
from ..types import resolve_device


class PTv3Block(nn.Module):
    """CPE, attention and MLP, each a residual; parameters ``cpe_conv``,
    ``cpe_linear``, ``cpe_norm``, ``norm1``, ``attn`` (``qkv``, ``proj``),
    ``norm2``, ``fc1``, ``fc2``."""

    def __init__(self, channels, num_heads, patch_size, order_index, D, mlp_ratio=4,
                 generator=None, device=None):
        super().__init__()
        g = dict(generator=generator, device=device)
        self.order_index = order_index
        self.cpe_conv = MinkowskiConvolution(channels, channels, kernel_size=3, bias=True,
                                             dimension=D, **g)
        self.cpe_linear = MinkowskiLinear(channels, channels, **g)
        self.cpe_norm = MinkowskiLayerNorm(channels, device=device)
        self.norm1 = MinkowskiLayerNorm(channels, device=device)
        self.attn = MinkowskiSerializedAttention(channels, num_heads, patch_size, **g)
        self.norm2 = MinkowskiLayerNorm(channels, device=device)
        self.fc1 = MinkowskiLinear(channels, channels * mlp_ratio, **g)
        self.act = MinkowskiGELU(approximate=False)
        self.fc2 = MinkowskiLinear(channels * mlp_ratio, channels, **g)

    def forward(self, x, curves):
        x = x + self.cpe_norm(self.cpe_linear(self.cpe_conv(x)))
        x = x + self.attn(self.norm1(x), curves[self.order_index % len(curves)])
        return x + self.fc2(self.act(self.fc1(self.norm2(x))))


class PointTransformerV3(nn.Module):
    """``PointTransformerV3(in_channels=6, out_channels=20, D=3, ...)``:
    logits of every input row, a SparseTensor on the input's map."""

    def __init__(
        self,
        in_channels: int = 6,
        out_channels: int = 20,
        D: int = 3,
        enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
        enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
        enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
        dec_depths: Sequence[int] = (2, 2, 2, 2),
        dec_channels: Sequence[int] = (64, 64, 128, 256),
        dec_num_head: Sequence[int] = (4, 4, 8, 16),
        patch_size: int = 1024,
        mlp_ratio: int = 4,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if D != 3:
            raise ValueError("PointTransformerV3 orders 3-D maps along its curves (D = 3)")
        levels = len(enc_depths)
        if not (len(enc_channels) == len(enc_num_head) == levels
                and len(dec_depths) == len(dec_channels) == len(dec_num_head) == levels - 1):
            raise ValueError("one encoder entry per level and one decoder entry per level but the last")
        device = resolve_device(device)
        g = dict(generator=generator, device=device)
        self.levels = levels

        self.stem = MinkowskiConvolution(in_channels, enc_channels[0], kernel_size=5,
                                         dimension=D, **g)
        self.stem_norm = MinkowskiBatchNorm(enc_channels[0], eps=1e-3, momentum=0.01,
                                            device=device)
        self.act = MinkowskiGELU(approximate=False)

        def blocks(depth, c, heads):
            return nn.ModuleList(PTv3Block(c, heads, patch_size, i, D, mlp_ratio, **g)
                                 for i in range(depth))

        self.down = nn.ModuleList(
            MinkowskiSerializedPooling(enc_channels[s - 1], enc_channels[s], **g)
            for s in range(1, levels))
        self.enc = nn.ModuleList(blocks(enc_depths[s], enc_channels[s], enc_num_head[s])
                                 for s in range(levels))
        up_in = list(dec_channels[1:]) + [enc_channels[-1]]
        self.up = nn.ModuleList(
            MinkowskiSerializedUnpooling(up_in[s], enc_channels[s], dec_channels[s], **g)
            for s in range(levels - 1))
        self.dec = nn.ModuleList(blocks(dec_depths[s], dec_channels[s], dec_num_head[s])
                                 for s in range(levels - 1))
        self.head = MinkowskiLinear(dec_channels[0], out_channels, **g)

    def draw_orders(self):
        """One order list per level, as Pointcept shuffles them."""
        return [torch.randperm(len(CURVES)).tolist() for _ in range(self.levels)]

    def forward(self, x, orders=None):
        orders = self.draw_orders() if orders is None else orders
        if len(orders) != self.levels:
            raise ValueError(f"{len(orders)} order lists for {self.levels} levels")
        curves = [[c if isinstance(c, str) else CURVES[c] for c in o] for o in orders]
        x = self.act(self.stem_norm(self.stem(x)))
        skips = []
        for s in range(self.levels):
            if s:
                skips.append(x)
                x = self.down[s - 1](x)
            for block in self.enc[s]:
                x = block(x, curves[s])
        for s in reversed(range(self.levels - 1)):
            x = self.up[s](x, skips[s])
            for block in self.dec[s]:
                x = block(x, curves[s])
        return self.head(x)
