"""Elementwise nonlinearities on sparse-tensor and tensor-field features.

Counterpart of ``minkowskiengine_tpu/nn/nonlinearity.py``: ReLU, LeakyReLU,
ELU, GELU and Dropout, the ones the MinkUNet, ResNet, classification and
generative models use.  Each applies to ``input.F`` and keeps the coordinates.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MinkowskiNonlinearityBase(nn.Module):
    """Apply the subclass's ``_fn`` to the features, keep the coordinates."""

    def forward(self, input):
        return input._wrap(self._fn(input.F))


class MinkowskiReLU(MinkowskiNonlinearityBase):
    def _fn(self, x):
        return torch.relu(x)


class MinkowskiLeakyReLU(MinkowskiNonlinearityBase):
    def __init__(self, negative_slope: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negative_slope = float(negative_slope)

    def _fn(self, x):
        return torch.nn.functional.leaky_relu(x, self.negative_slope)


class MinkowskiELU(MinkowskiNonlinearityBase):
    """ELU with alpha = 1, as ``jax.nn.elu``: x above 0, expm1(x) below."""

    def _fn(self, x):
        return torch.nn.functional.elu(x)


class MinkowskiGELU(MinkowskiNonlinearityBase):
    """GELU in its tanh form, as the JAX package's ``jax.nn.gelu`` (default
    ``approximate=True``) computes it.  The reference wraps
    ``torch.nn.GELU()``, the exact erf form; the two differ by up to ~5e-4
    (ROADMAP queue 3)."""

    def _fn(self, x):
        return torch.nn.functional.gelu(x, approximate="tanh")


class MinkowskiDropout(MinkowskiNonlinearityBase):
    """Dropout: in train mode each entry is kept with probability 1 - p and
    scaled by 1 / (1 - p); in eval mode the identity.  The keep mask is drawn
    from ``generator`` (on its own device, then moved), or from the default
    generator of the input's device."""

    def __init__(
        self, p: float = 0.5, inplace: bool = False, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def _fn(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            u = torch.rand(x.shape, device=x.device)
        else:
            u = torch.rand(x.shape, generator=self.generator, device=self.generator.device)
        keep = u.to(x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)

    def extra_repr(self):
        return f"p={self.p}"
