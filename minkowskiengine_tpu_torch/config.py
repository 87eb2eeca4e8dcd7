"""Global framework configuration.

Counterpart of ``minkowskiengine_tpu/config.py``.  ``compute_dtype``: the
mixed-precision policy of the feature path.  Set to ``torch.bfloat16``, every
convolution module casts its input features and its weight view to bf16 and
runs the bf16 instances of the gather-GEMM and the weight-gradient kernels;
parameters stay float32 (the master weights), the weight gradient comes
back in float32, and batch norm computes its statistics in float32.
``None``, the default, follows the input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

_compute_dtype: Optional[torch.dtype] = None


def set_compute_dtype(dtype: Optional[torch.dtype]) -> None:
    """Set the activation compute dtype (``None``: follow the input)."""
    global _compute_dtype
    if dtype is not None and not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise TypeError(f"compute dtype must be a floating torch.dtype or None, got {dtype!r}")
    _compute_dtype = dtype


def compute_dtype() -> Optional[torch.dtype]:
    return _compute_dtype
