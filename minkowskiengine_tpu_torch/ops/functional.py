"""Feature-phase primitives: row gathers and the sparse convolution.

Counterpart of the convolution part of
``minkowskiengine_tpu/ops/functional.py``.  Rows are exact-size; index -1
means "no pair" and gathers a zero row.
"""

from __future__ import annotations

import torch

from ..coords.kernel_map import KernelMap
from ..kernels.gather_gemm import gather_gemm


def take_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows; any index < 0 or >= N yields a zero row."""
    n = feats.shape[0]
    padded = torch.cat([feats, feats.new_zeros((1,) + tuple(feats.shape[1:]))])
    safe = torch.where((idx >= 0) & (idx < n), idx, n).long()
    return padded.index_select(0, safe)


def sparse_conv(feats: torch.Tensor, kernel: torch.Tensor, in_idx: torch.Tensor):
    """Generalized sparse convolution, forward:
    ``out[o] = Σ_k feats[in_idx[k, o]] @ kernel[k]``.

    Args:
      feats: (N_in, ch_in) input features.
      kernel: (K, ch_in, ch_out) weights, offset-major as in the reference
        (MinkowskiConvolution.py:262-285).
      in_idx: (K, N_out) int32 gather map, -1 = no pair.

    On a CUDA device this runs the hand-written gather-GEMM kernel, which
    has no backward yet: a call that would need a gradient raises.
    """
    if (
        feats.is_cuda
        and torch.is_grad_enabled()
        and (feats.requires_grad or kernel.requires_grad)
    ):
        raise NotImplementedError(
            "sparse_conv on CUDA is forward-only for now; run inference under "
            "torch.no_grad() (the backward kernels are not ported yet)"
        )
    return gather_gemm(feats, kernel, in_idx)


def sparse_conv_kmap(feats: torch.Tensor, kernel: torch.Tensor, kmap: KernelMap):
    """Sparse convolution through a cached kernel map."""
    return sparse_conv(feats, kernel, kmap.in_idx)
