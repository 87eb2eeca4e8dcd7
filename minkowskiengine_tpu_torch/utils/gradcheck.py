"""Gradient check (reference: MinkowskiEngine/utils/gradcheck.py, a vendored
float64 ``torch.autograd.gradcheck``).  Counterpart of
``minkowskiengine_tpu/utils/gradcheck.py``."""

from __future__ import annotations

import torch


def gradcheck(func, inputs, atol: float = 1e-5, rtol: float = 1e-3, eps: float = 1e-6) -> bool:
    """Check ``func``'s backward against finite differences in float64:
    floating-point tensors among ``inputs`` are cast to float64 and
    differentiated; others pass through.  Returns True or raises
    ``torch.autograd.gradcheck.GradcheckError``."""
    if not isinstance(inputs, (tuple, list)):
        inputs = (inputs,)
    inputs = tuple(
        x.detach().double().requires_grad_() if isinstance(x, torch.Tensor) and x.is_floating_point() else x
        for x in inputs
    )
    return torch.autograd.gradcheck(func, inputs, eps=eps, atol=atol, rtol=rtol, raise_exception=True)
