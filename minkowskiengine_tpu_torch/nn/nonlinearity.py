"""Elementwise nonlinearities on sparse-tensor and tensor-field features.

Counterpart of ``minkowskiengine_tpu/nn/nonlinearity.py``: the one-line
family that wraps a torch function (``_make``), LeakyReLU, GELU and
Dropout.  Each applies to ``input.F`` and keeps the coordinates.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as TF


class MinkowskiNonlinearityBase(nn.Module):
    """Apply the subclass's ``_fn`` to the features, keep the coordinates.
    Keyword arguments go to the wrapped function (``MinkowskiCELU(alpha=2.0)``)."""

    def __init__(self, **kwargs):
        super().__init__()
        self._kwargs = kwargs

    def forward(self, input):
        return input._wrap(self._fn(input.F))


def _make(name: str, fn: Callable, doc: str):
    """A nonlinearity class that applies ``fn(features, **kwargs)``."""

    def _fn(self, x):
        return fn(x, **self._kwargs)

    return type(name, (MinkowskiNonlinearityBase,), {"_fn": _fn, "__doc__": doc, "__module__": __name__})


MinkowskiReLU = _make("MinkowskiReLU", TF.relu, "max(x, 0).")
MinkowskiReLU6 = _make("MinkowskiReLU6", TF.relu6, "min(max(x, 0), 6).")
MinkowskiELU = _make("MinkowskiELU", TF.elu, "ELU, alpha 1 by default as ``jax.nn.elu``.")
MinkowskiSELU = _make("MinkowskiSELU", TF.selu, "Scaled ELU.")
MinkowskiCELU = _make("MinkowskiCELU", TF.celu, "Continuously differentiable ELU.")
MinkowskiSiLU = _make("MinkowskiSiLU", TF.silu, "x * sigmoid(x).")
MinkowskiTanh = _make("MinkowskiTanh", torch.tanh, "tanh(x).")
MinkowskiSigmoid = _make("MinkowskiSigmoid", torch.sigmoid, "1 / (1 + exp(-x)).")
MinkowskiLogSigmoid = _make("MinkowskiLogSigmoid", TF.logsigmoid, "log(sigmoid(x)).")
MinkowskiSoftplus = _make("MinkowskiSoftplus", TF.softplus, "log(1 + exp(x)).")
MinkowskiSoftsign = _make("MinkowskiSoftsign", TF.softsign, "x / (1 + |x|).")
MinkowskiHardsigmoid = _make("MinkowskiHardsigmoid", TF.hardsigmoid, "relu6(x + 3) / 6.")
MinkowskiHardswish = _make("MinkowskiHardswish", TF.hardswish, "x * relu6(x + 3) / 6.")


class MinkowskiLeakyReLU(MinkowskiNonlinearityBase):
    def __init__(self, negative_slope: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negative_slope = float(negative_slope)

    def _fn(self, x):
        return TF.leaky_relu(x, self.negative_slope)


class MinkowskiGELU(MinkowskiNonlinearityBase):
    """GELU in its tanh form, as the JAX package's ``jax.nn.gelu`` (default
    ``approximate=True``) computes it.  The reference wraps
    ``torch.nn.GELU()``, the exact erf form; the two differ by up to ~5e-4
    (ROADMAP queue 3)."""

    def _fn(self, x):
        return TF.gelu(x, approximate="tanh")


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
