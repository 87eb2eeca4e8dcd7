"""Generative shape completion.

Counterpart of ``minkowskiengine_tpu/models/completion.py`` (reference:
examples/completion.py:152-470): an encoder of strided convs, then a
decoder whose generative transposed convs grow coordinates level by level;
each level adds the encoder's skip over the union of both maps, a
classifier scores every row, and ``MinkowskiPruning`` drops the rows it
rejects.  State-dict names follow JAX's: ``enc_first.0.kernel``,
``enc_blocks.3.4.bn.weight``, ``dec_blocks.0.0.kernel``,
``cls_heads.2.bias``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..coords.manager import CoordinateMapKey
from ..nn.conv import MinkowskiConvolution, MinkowskiGenerativeConvolutionTranspose
from ..nn.nonlinearity import MinkowskiELU
from ..nn.norm import MinkowskiBatchNorm
from ..nn.pruning import MinkowskiPruning
from ..sparse_tensor import SparseTensor
from ..types import RegionType, resolve_device
from ..utils import profiling as P
from .resnet import _Seq


def target_mask(out: SparseTensor, target_key: CoordinateMapKey) -> torch.Tensor:
    """(N,) bool: the rows of ``out`` whose voxel is in the target map,
    strided to ``out``'s tensor stride; a volume-1 HYPER_CROSS kernel map
    from ``out`` to the target (reference: examples/completion.py:357-372)."""
    cm = out.coordinate_manager
    strided_target_key = cm.stride(target_key, out.tensor_stride)
    kernel_map = cm.kernel_map(
        out.coordinate_map_key, strided_target_key, kernel_size=1, stride=1,
        region_type=RegionType.HYPER_CROSS,
    )
    return (kernel_map.out_idx_t >= 0).any(dim=0)


def generative_levels(model, dec, blocks, skips, target_key):
    """The decoder loop of CompletionNet and the VAE: per level a block, the
    skip (if any) added over the union of coordinates, the classifier, the
    target mask, and pruning to the kept rows (in train mode, the targets
    too).  A level is pruned only when a row is kept: one ``keep.any()``
    host sync per level, as in JAX.  Returns (logits per level, targets per
    level, the last pruned tensor)."""
    out_cls, targets = [], []
    for i, block in enumerate(blocks):
        dec = block(dec)
        if skips is not None:
            dec = dec + skips[i]
        cls = model.cls_heads[i](dec)
        target = target_mask(dec, target_key)
        targets.append(target)
        out_cls.append(cls)
        keep = cls.F[:, 0] > 0
        if model.training:
            keep = keep | target
        with P.host_read("completion.keep", coords=True):
            kept = bool(keep.any())
        if kept:
            dec = model.pruning(dec, keep)
    return out_cls, targets, dec


class CompletionNet(nn.Module):
    """Encoder-decoder completion net; ``forward(partial, target_key)``
    returns (per-level logits, per-level target masks, the completed
    tensor).  Weights are drawn with ``generator`` on the CPU, then placed
    on ``device`` (default: the CUDA card)."""

    def __init__(
        self,
        resolution: int = 128,
        in_nchannel: int = 1,
        enc_channels=(16, 32, 64, 128, 256, 512, 1024),
        dec_channels=(16, 32, 64, 128, 256, 512, 1024),
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        g = dict(dimension=3, generator=generator, device=device)
        self.resolution = resolution
        enc_ch, dec_ch = list(enc_channels), list(dec_channels)
        self.levels = len(enc_ch) - 1

        def norm_act(c):
            return MinkowskiBatchNorm(c, device=device), MinkowskiELU()

        def enc_block(cin, cout):
            return _Seq(
                MinkowskiConvolution(cin, cout, kernel_size=2, stride=2, **g), *norm_act(cout),
                MinkowskiConvolution(cout, cout, kernel_size=3, **g), *norm_act(cout),
            )

        def dec_block(cin, cout, kernel_size):
            return _Seq(
                MinkowskiGenerativeConvolutionTranspose(
                    cin, cout, kernel_size=kernel_size, stride=2, **g
                ),
                *norm_act(cout),
                MinkowskiConvolution(cout, cout, kernel_size=3, **g), *norm_act(cout),
            )

        self.enc_first = _Seq(
            MinkowskiConvolution(in_nchannel, enc_ch[0], kernel_size=3, stride=1, **g),
            *norm_act(enc_ch[0]),
        )
        self.enc_blocks = nn.ModuleList(
            [enc_block(enc_ch[i], enc_ch[i + 1]) for i in range(self.levels)]
        )
        # the decoder runs coarsest to finest; block i maps enc_ch[L-i] (its
        # first) or dec_ch[L-i] to dec_ch[L-i-1]
        L = self.levels
        self.dec_blocks = nn.ModuleList([
            dec_block(enc_ch[L] if i == 0 else dec_ch[L - i], dec_ch[L - i - 1],
                      kernel_size=4 if i == 0 else 2)
            for i in range(L)
        ])
        self.cls_heads = nn.ModuleList([
            MinkowskiConvolution(dec_ch[L - i - 1], 1, kernel_size=1, bias=True, **g)
            for i in range(L)
        ])
        self.pruning = MinkowskiPruning()

    def get_target(self, out: SparseTensor, target_key: CoordinateMapKey) -> torch.Tensor:
        return target_mask(out, target_key)

    def forward(
        self, partial_in: SparseTensor, target_key: CoordinateMapKey
    ) -> Tuple[List[SparseTensor], List[torch.Tensor], SparseTensor]:
        enc = [self.enc_first(partial_in)]
        for blk in self.enc_blocks:
            enc.append(blk(enc[-1]))
        skips = [enc[self.levels - i - 1] for i in range(self.levels)]
        return generative_levels(self, enc[-1], self.dec_blocks, skips, target_key)
