"""Generative VAE over sparse voxel grids.

Counterpart of ``minkowskiengine_tpu/models/vae.py`` (reference:
examples/vae.py:215-600): the encoder pools a shape into a global latent
(mean, log-variance); the decoder grows a voxel grid from one seed voxel
per shape with generative transposed convs and prunes each level with a
classifier.  As in JAX, the encoder strides ``len(channels)`` times and
the decoder has ``len(channels) - 1`` levels, so generation ends at tensor
stride 2 (the reference's decoder ends at stride 1; ROADMAP queue 3).
The noise comes from an explicit ``torch.Generator`` where JAX takes an
``rng_key``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..coords.manager import CoordinateMapKey
from ..nn.conv import MinkowskiConvolution, MinkowskiGenerativeConvolutionTranspose
from ..nn.nonlinearity import MinkowskiELU
from ..nn.norm import MinkowskiBatchNorm
from ..nn.ops import MinkowskiLinear
from ..nn.pooling import MinkowskiGlobalPooling
from ..nn.pruning import MinkowskiPruning
from ..sparse_tensor import SparseTensor
from ..types import resolve_device
from .completion import generative_levels, target_mask
from .resnet import _Seq


def _block(first, cin, cout, g, device):
    """``first`` (cin → cout), then BN, ELU, a k = 3 conv, BN, ELU."""
    return _Seq(
        first,
        MinkowskiBatchNorm(cout, device=device), MinkowskiELU(),
        MinkowskiConvolution(cout, cout, kernel_size=3, **g),
        MinkowskiBatchNorm(cout, device=device), MinkowskiELU(),
    )


class Encoder(nn.Module):
    """Stride-2 conv blocks, global average pooling, then the mean and
    log-variance linears (reference: examples/vae.py:215-318)."""

    def __init__(self, channels=(16, 32, 64, 128, 256, 512, 1024), in_nchannel=1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        g = dict(dimension=3, generator=generator, device=device)
        ch = [in_nchannel] + list(channels)
        self.blocks = nn.ModuleList([
            _block(MinkowskiConvolution(ch[i], ch[i + 1], kernel_size=3, stride=2, **g),
                   ch[i], ch[i + 1], g, device)
            for i in range(len(ch) - 1)
        ])
        self.global_pool = MinkowskiGlobalPooling()
        lin = dict(bias=True, generator=generator, device=device)
        self.linear_mean = MinkowskiLinear(ch[-1], ch[-1], **lin)
        self.linear_log_var = MinkowskiLinear(ch[-1], ch[-1], **lin)

    def forward(self, sinput: SparseTensor):
        out = sinput
        for blk in self.blocks:
            out = blk(out)
        out = self.global_pool(out)
        return self.linear_mean(out), self.linear_log_var(out)


class Decoder(nn.Module):
    """From seed voxels, generative stride-2 levels with a classifier and
    pruning each (reference: examples/vae.py:318-460)."""

    def __init__(self, channels=(1024, 512, 256, 128, 64, 32, 16), resolution=128,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        g = dict(dimension=3, generator=generator, device=device)
        ch = list(channels)
        self.resolution = resolution
        self.levels = len(ch) - 1
        self.blocks = nn.ModuleList([
            _block(MinkowskiGenerativeConvolutionTranspose(
                ch[i], ch[i + 1], kernel_size=2, stride=2, **g), ch[i], ch[i + 1], g, device)
            for i in range(self.levels)
        ])
        self.cls_heads = nn.ModuleList([
            MinkowskiConvolution(ch[i + 1], 1, kernel_size=1, bias=True, **g)
            for i in range(self.levels)
        ])
        self.pruning = MinkowskiPruning()

    def get_target(self, out: SparseTensor, target_key: CoordinateMapKey) -> torch.Tensor:
        return target_mask(out, target_key)

    def forward(self, z_glob: SparseTensor, target_key: CoordinateMapKey):
        """``z_glob``: one latent row per shape on its seed voxel at the
        coarsest tensor stride."""
        return generative_levels(self, z_glob, self.blocks, None, target_key)


class VAE(nn.Module):
    """Encoder and decoder (reference: examples/vae.py:560-600).
    ``forward(sinput, gt_target, generator=None)`` returns (per-level
    logits, per-level targets, the generated tensor, mean, log-variance);
    the noise is drawn in float32 from ``generator`` (on its own device, then
    moved), or from the default generator of the features' device, and cast
    to the mean's dtype (bf16 under the bf16 policy), in which ``z`` is
    computed."""

    def __init__(self, channels=(16, 32, 64, 128, 256, 512, 1024), in_nchannel=1,
                 resolution=128, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.encoder = Encoder(channels, in_nchannel, generator=generator, device=device)
        self.decoder = Decoder(tuple(reversed(channels)), resolution, generator=generator,
                               device=device)

    def forward(self, sinput: SparseTensor, gt_target: CoordinateMapKey,
                generator: Optional[torch.Generator] = None):
        mean, log_var = self.encoder(sinput)
        if generator is None:
            eps = torch.randn(mean.F.shape, device=mean.device)
        else:
            eps = torch.randn(mean.F.shape, generator=generator, device=generator.device)
        # the noise and the sum in the mean's dtype, as JAX draws and adds them
        eps = eps.to(device=mean.device, dtype=mean.F.dtype)
        z = mean.F + eps * torch.exp(0.5 * log_var.F)
        out_cls, targets, sout = self.decoder(self.seed(sinput, mean, z), gt_target)
        return out_cls, targets, sout, mean, log_var

    def seed(self, sinput: SparseTensor, mean: SparseTensor, z: torch.Tensor) -> SparseTensor:
        """The latent rows on the seed voxels: each shape's origin (b, 0, 0,
        0) at tensor stride ``2 ** len(encoder.blocks)`` times the input's."""
        manager = sinput.coordinate_manager
        seed_key, _ = manager.insert_and_map(mean.C, self.decoder_resolution_stride(sinput))
        return SparseTensor(z, coordinate_map_key=seed_key, coordinate_manager=manager)

    def decoder_resolution_stride(self, sinput: SparseTensor):
        return tuple(s * 2 ** len(self.encoder.blocks) for s in sinput.tensor_stride)
