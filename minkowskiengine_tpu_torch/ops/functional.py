"""Feature-phase primitives: row gathers and the sparse convolution.

Counterpart of the convolution part of
``minkowskiengine_tpu/ops/functional.py``.  Rows are exact-size; index -1
means "no pair" and gathers a zero row.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..coords.kernel_map import KernelMap
from ..kernels.conv_dw import conv_dw
from ..kernels.gather_gemm import gather_gemm


def take_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows; any index < 0 or >= N yields a zero row."""
    n = feats.shape[0]
    padded = torch.cat([feats, feats.new_zeros((1,) + tuple(feats.shape[1:]))])
    safe = torch.where((idx >= 0) & (idx < n), idx, n).long()
    return padded.index_select(0, safe)


class _SparseConv(torch.autograd.Function):
    """The conv and its hand-written VJP (JAX: ``_conv_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, feats, kernel, in_idx, out_idx_t):
        ctx.save_for_backward(feats, kernel, in_idx, out_idx_t)
        return gather_gemm(feats, kernel, in_idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        feats, kernel, in_idx, out_idx_t = ctx.saved_tensors
        # torch.cat's backward hands its inputs column slices
        g = grad_out.contiguous()
        d_feats = d_kernel = None
        if ctx.needs_input_grad[0]:
            # d_feats[i] = Σ_k g[out_idx_t[k, i]] @ W[k]ᵀ: the forward kernel
            # on the transposed matching
            d_feats = gather_gemm(g, kernel.transpose(1, 2).contiguous(), out_idx_t)
        if ctx.needs_input_grad[1]:
            d_kernel = conv_dw(feats, g, in_idx)
        return d_feats, d_kernel, None, None


def sparse_conv(
    feats: torch.Tensor,
    kernel: torch.Tensor,
    in_idx: torch.Tensor,
    out_idx_t: Optional[torch.Tensor],
) -> torch.Tensor:
    """Generalized sparse convolution:
    ``out[o] = Σ_k feats[in_idx[k, o]] @ kernel[k]``.

    Args:
      feats: (N_in, ch_in) input features.
      kernel: (K, ch_in, ch_out) weights, offset-major as in the reference
        (MinkowskiConvolution.py:262-285).
      in_idx: (K, N_out) int32 gather map, -1 = no pair.
      out_idx_t: (K, N_in) int32 inverse matching, read by the input
        gradient only; may be None when ``feats`` needs no gradient.

    Differentiable in ``feats`` and ``kernel``.  The forward and the input
    gradient run the gather-GEMM (on ``in_idx``, and on ``out_idx_t`` with
    ``kernel[k]ᵀ``), the weight gradient runs ``conv_dw``: the hand-written
    kernels for CUDA tensors, their plain versions for CPU tensors.
    """
    if out_idx_t is None and feats.requires_grad and torch.is_grad_enabled():
        raise ValueError("sparse_conv needs out_idx_t for the input gradient")
    return _SparseConv.apply(feats, kernel, in_idx, out_idx_t)


def sparse_conv_kmap(feats: torch.Tensor, kernel: torch.Tensor, kmap: KernelMap):
    """Sparse convolution through a cached kernel map."""
    return sparse_conv(feats, kernel, kmap.in_idx, kmap.out_idx_t)
