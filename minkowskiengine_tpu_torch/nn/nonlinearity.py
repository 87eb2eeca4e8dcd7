"""Nonlinearities on sparse-tensor and tensor-field features.

Counterpart of ``minkowskiengine_tpu/nn/nonlinearity.py``: the one-line
family that wraps a torch function (``_make``), LeakyReLU, GELU, the
shrinks and thresholds, PReLU, RReLU, the softmaxes, Dropout and
AlphaDropout, Sinusoidal, and the adaptive log-softmax head.  Each applies
to ``input.F`` and keeps the coordinates.  The formulas are JAX's, so the
two packages agree where torch's own modules would differ (RReLU, GELU;
ROADMAP queue 3).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as TF

from ..sparse_tensor import whole_rows
from ..types import resolve_device


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
    """GELU, by default in its tanh form, as the JAX package's
    ``jax.nn.gelu`` (default ``approximate=True``) computes it.  The
    reference wraps ``torch.nn.GELU()``, the exact erf form, which
    ``approximate=False`` gives, as JAX's keyword does (Point Transformer V3
    takes it); the two differ by up to ~5e-4 (ROADMAP queue 3)."""

    def __init__(self, approximate: bool = True):
        super().__init__()
        self.approximate = "tanh" if approximate else "none"

    def _fn(self, x):
        return TF.gelu(x, approximate=self.approximate)


# The formulas on feature tensors; the modules below and
# ``nn/functional.py`` (``MinkowskiFunctional``) both apply these.


def hardtanh_features(x, min_val: float = -1.0, max_val: float = 1.0):
    return torch.clamp(x, min_val, max_val)


def threshold_features(x, threshold: float, value: float):
    """x where x > threshold, else ``value``."""
    return torch.where(x > threshold, x, value)


def hardshrink_features(x, lambd: float = 0.5):
    """x where |x| > lambd, else 0."""
    return torch.where(x.abs() > lambd, x, 0.0)


def softshrink_features(x, lambd: float = 0.5):
    """sign(x) · max(|x| - lambd, 0)."""
    return torch.sign(x) * torch.clamp_min(x.abs() - lambd, 0.0)


def tanhshrink_features(x):
    """x - tanh(x)."""
    return x - torch.tanh(x)


def prelu_features(x, weight):
    """x where x >= 0, else ``weight`` · x, one slope per channel or one for all."""
    return torch.where(x >= 0, x, x * weight)


def softmax_features(x, dim: int = -1):
    return torch.softmax(x, dim=dim)


def softmin_features(x, dim: int = -1):
    return torch.softmax(-x, dim=dim)


def log_softmax_features(x, dim: int = -1):
    return torch.log_softmax(x, dim=dim)


def keep_mask(x: torch.Tensor, p: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Each entry kept with probability 1 - p: uniform draws from
    ``generator`` (on its own device, then moved), or from the default
    generator of ``x``'s device."""
    if generator is None:
        u = torch.rand(x.shape, device=x.device)
    else:
        u = torch.rand(x.shape, generator=generator, device=generator.device)
    return u.to(x.device) >= p


# -scale * alpha of SELU: where alpha dropout sends a dropped entry
ALPHA_PRIME = -1.7580993408473766


def dropout_features(x: torch.Tensor, p: float, keep: torch.Tensor) -> torch.Tensor:
    """Kept entries scaled by 1 / (1 - p), the rest 0."""
    return torch.where(keep, x / (1.0 - p), 0.0)


def alpha_dropout_features(x: torch.Tensor, p: float, keep: torch.Tensor) -> torch.Tensor:
    """``a * where(keep, x, α') + b``, with a and b chosen so that a SELU
    network's zero mean and unit variance survive (torch.nn.AlphaDropout's
    rule, as JAX computes it)."""
    a = ((1.0 - p) * (1.0 + p * ALPHA_PRIME * ALPHA_PRIME)) ** -0.5
    b = -a * ALPHA_PRIME * p
    return a * torch.where(keep, x, ALPHA_PRIME) + b


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

    def _keep_mask(self, x):
        return keep_mask(x, self.p, self.generator)

    def _fn(self, x):
        if not self.training or self.p == 0.0:
            return x
        return dropout_features(x, self.p, self._keep_mask(x))

    def extra_repr(self):
        return f"p={self.p}"


class MinkowskiAlphaDropout(MinkowskiDropout):
    """Alpha dropout for self-normalizing (SELU) networks: in train mode a
    dropped entry becomes SELU's negative saturation α', then every entry
    is mapped affinely so that zero mean and unit variance survive
    (torch.nn.AlphaDropout's rule); in eval mode the identity."""

    def _fn(self, x):
        if not self.training or self.p == 0.0:
            return x
        return alpha_dropout_features(x, self.p, self._keep_mask(x))


class MinkowskiHardtanh(MinkowskiNonlinearityBase):
    def __init__(self, min_val: float = -1.0, max_val: float = 1.0, inplace: bool = False):
        super().__init__()
        self.min_val, self.max_val = float(min_val), float(max_val)

    def _fn(self, x):
        return hardtanh_features(x, self.min_val, self.max_val)


class MinkowskiThreshold(MinkowskiNonlinearityBase):
    """x where x > threshold, else ``value``."""

    def __init__(self, threshold: float, value: float, inplace: bool = False):
        super().__init__()
        self.threshold, self.value = float(threshold), float(value)

    def _fn(self, x):
        return threshold_features(x, self.threshold, self.value)


class MinkowskiHardshrink(MinkowskiNonlinearityBase):
    """x where |x| > lambd, else 0."""

    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = float(lambd)

    def _fn(self, x):
        return hardshrink_features(x, self.lambd)


class MinkowskiSoftshrink(MinkowskiNonlinearityBase):
    """sign(x) · max(|x| - lambd, 0)."""

    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = float(lambd)

    def _fn(self, x):
        return softshrink_features(x, self.lambd)


class MinkowskiTanhshrink(MinkowskiNonlinearityBase):
    """x - tanh(x)."""

    def _fn(self, x):
        return tanhshrink_features(x)


class MinkowskiPReLU(MinkowskiNonlinearityBase):
    """x where x >= 0, else ``weight`` · x; ``weight`` (num_parameters,),
    one slope for all channels or one per channel, initialised to ``init``."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.full((num_parameters,), float(init), device=resolve_device(device))
        )

    def forward(self, input):
        whole_rows(input, "PReLU's shared slope")
        return super().forward(input)

    def _fn(self, x):
        return prelu_features(x, self.weight)


class MinkowskiRReLU(MinkowskiNonlinearityBase):
    """Leaky ReLU with the slope (lower + upper) / 2, in train mode too, as
    JAX computes it; torch's RReLU samples a slope per entry in train mode
    (ROADMAP queue 3)."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3, inplace: bool = False):
        super().__init__()
        self.lower, self.upper = float(lower), float(upper)
        self.slope = (self.lower + self.upper) / 2.0

    def _fn(self, x):
        return torch.where(x >= 0, x, x * self.slope)


class MinkowskiSoftmax(MinkowskiNonlinearityBase):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def _fn(self, x):
        return softmax_features(x, self.dim)


class MinkowskiSoftmin(MinkowskiSoftmax):
    def _fn(self, x):
        return softmin_features(x, self.dim)


class MinkowskiLogSoftmax(MinkowskiSoftmax):
    def _fn(self, x):
        return log_softmax_features(x, self.dim)


class MinkowskiSinusoidal(nn.Module):
    """cos(F @ kernel), ``kernel`` (in_channel, out_channel) drawn from N(0, 1)
    with ``generator`` on the CPU, then moved to ``device`` (reference:
    MinkowskiNonlinearity.py:175-200)."""

    def __init__(self, in_channel: int, out_channel: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.in_channel, self.out_channel = int(in_channel), int(out_channel)
        kernel = torch.randn((in_channel, out_channel), generator=generator)
        self.kernel = nn.Parameter(kernel.to(resolve_device(device)))

    def forward(self, input):
        whole_rows(input, "Sinusoidal's shared kernel")
        return input._wrap(torch.cos(input.F @ self.kernel))


def _uniform_linear(in_features, out_features, bias, generator, device) -> nn.Linear:
    """``torch.nn.Linear`` with every parameter drawn from U(±1/√in) with
    ``generator`` on the CPU."""
    lin = nn.Linear(in_features, out_features, bias=bias, device=device)
    stdv = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.empty(p.shape).uniform_(-stdv, stdv, generator=generator))
    return lin


class MinkowskiAdaptiveLogSoftmaxWithLoss(nn.Module):
    """Adaptive (hierarchical) softmax for large label spaces (reference:
    MinkowskiNonlinearity.py:162 wraps ``torch.nn.AdaptiveLogSoftmaxWithLoss``).

    Classes below ``cutoffs[0]`` live in the head; each later band of
    classes is a tail cluster whose projection shrinks by ``div_value`` per
    cluster.  The parameters are named as torch's: ``head.weight`` (and
    ``head.bias``), ``tail.{i}.0.weight``, ``tail.{i}.1.weight``.
    ``forward(input, target)`` returns (the target's log-probability per
    row, the mean negative of them), as torch's ``ASMoutput``.
    """

    def __init__(
        self,
        in_features: int,
        n_classes: int,
        cutoffs,
        div_value: float = 4.0,
        head_bias: bool = False,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        cutoffs = list(cutoffs)
        if (
            sorted(cutoffs) != cutoffs
            or min(cutoffs) <= 0
            or max(cutoffs) > n_classes - 1
            or len(set(cutoffs)) != len(cutoffs)
        ):
            raise ValueError("cutoffs must be a sorted list of unique positive ints < n_classes - 1")
        dev = resolve_device(device)
        self.in_features = int(in_features)
        self.n_classes = int(n_classes)
        self.cutoffs = cutoffs + [int(n_classes)]
        self.div_value = float(div_value)
        self.shortlist_size = cutoffs[0]
        self.n_clusters = len(cutoffs)
        self.head_size = self.shortlist_size + self.n_clusters
        self.head = _uniform_linear(in_features, self.head_size, head_bias, generator, dev)
        self.tail = nn.ModuleList()
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features // (self.div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            self.tail.append(nn.Sequential(
                _uniform_linear(in_features, hsz, False, generator, dev),
                _uniform_linear(hsz, osz, False, generator, dev),
            ))

    def forward(self, input, target):
        feats = input.F
        target = torch.as_tensor(target, device=feats.device).long()
        head_logprob = torch.log_softmax(self.head(feats), dim=-1)
        out = head_logprob.gather(1, target.clamp(0, self.head_size - 1)[:, None])[:, 0]
        for i, tail in enumerate(self.tail):
            lo, hi = self.cutoffs[i], self.cutoffs[i + 1]
            tail_logprob = torch.log_softmax(tail(feats), dim=-1)
            rel = (target - lo).clamp(0, hi - lo - 1)
            cluster = head_logprob[:, self.shortlist_size + i] + tail_logprob.gather(1, rel[:, None])[:, 0]
            out = torch.where((target >= lo) & (target < hi), cluster, out)
        return out, -out.sum() / max(out.shape[0], 1)

    def log_prob(self, input) -> torch.Tensor:
        """(N, n_classes) log-probabilities."""
        head_logprob = torch.log_softmax(self.head(input.F), dim=-1)
        parts = [head_logprob[:, : self.shortlist_size]]
        for i, tail in enumerate(self.tail):
            c = self.shortlist_size + i
            parts.append(head_logprob[:, c : c + 1] + torch.log_softmax(tail(input.F), dim=-1))
        return torch.cat(parts, dim=-1)

    def predict(self, input) -> torch.Tensor:
        return self.log_prob(input).argmax(dim=-1)
