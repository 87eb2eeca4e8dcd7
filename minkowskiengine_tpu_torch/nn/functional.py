"""Functional API: torch functions applied to sparse-tensor features,
exported as ``MinkowskiFunctional``.

Counterpart of ``minkowskiengine_tpu/nn/functional.py`` (reference:
MinkowskiEngine/MinkowskiFunctional.py:30-232).  Each unary wrapper applies
its function to ``input.F`` and keeps the coordinates; the formulas are
JAX's (``gelu`` is the tanh form, as ``jax.nn.gelu``), and those the
modules share live in ``nn/nonlinearity.py``.  ``dropout`` and
``alpha_dropout`` in training need an explicit ``generator``, as JAX's need
a key.  The losses take sparse tensors or plain tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as TF

from .nonlinearity import (
    alpha_dropout_features,
    dropout_features,
    hardshrink_features,
    hardtanh_features,
    keep_mask,
    log_softmax_features,
    prelu_features,
    softmax_features,
    softmin_features,
    softshrink_features,
    tanhshrink_features,
    threshold_features,
)


def _make_unary(fn):
    def wrapped(input, *args, **kwargs):
        return input._wrap(fn(input.F, *args, **kwargs))

    wrapped.__name__ = getattr(fn, "__name__", "unary").removesuffix("_features")
    return wrapped


relu = _make_unary(TF.relu)
relu6 = _make_unary(TF.relu6)
elu = _make_unary(TF.elu)
selu = _make_unary(TF.selu)
celu = _make_unary(TF.celu)
gelu = _make_unary(lambda x: TF.gelu(x, approximate="tanh"))
silu = _make_unary(TF.silu)
leaky_relu = _make_unary(TF.leaky_relu)
tanh = _make_unary(torch.tanh)
sigmoid = _make_unary(torch.sigmoid)
logsigmoid = _make_unary(TF.logsigmoid)
softplus = _make_unary(TF.softplus)
softsign = _make_unary(TF.softsign)
hardsigmoid = _make_unary(TF.hardsigmoid)
hardswish = _make_unary(TF.hardswish)
hardtanh = _make_unary(hardtanh_features)
softmax = _make_unary(softmax_features)
softmin = _make_unary(softmin_features)
log_softmax = _make_unary(log_softmax_features)
glu = _make_unary(lambda x, dim=-1: TF.glu(x, dim=dim))
tanhshrink = _make_unary(tanhshrink_features)
hardshrink = _make_unary(hardshrink_features)
softshrink = _make_unary(softshrink_features)
threshold = _make_unary(threshold_features)
prelu = _make_unary(prelu_features)


def normalize(input, p: float = 2.0, dim: int = 1, eps: float = 1e-12):
    return input._wrap(TF.normalize(input.F, p=p, dim=dim, eps=eps))


def linear(input, weight, bias=None):
    """``F @ weight.T + bias``; ``weight`` is (out, in) as in torch."""
    return input._wrap(TF.linear(input.F, weight, bias))


def _check_generator(generator):
    if generator is None:
        raise ValueError(
            "functional dropout with training=True needs an explicit generator= "
            "(a torch.Generator); a fixed default would draw the same mask on every call"
        )


def dropout(input, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None):
    """Each entry kept with probability 1 - p and scaled by 1 / (1 - p)."""
    if not training or p == 0.0:
        return input
    _check_generator(generator)
    x = input.F
    return input._wrap(dropout_features(x, p, keep_mask(x, p, generator)))


def alpha_dropout(input, p: float = 0.5, training: bool = True,
                  generator: Optional[torch.Generator] = None):
    """What ``MinkowskiAlphaDropout`` computes.  JAX's ``alpha_dropout`` is
    plain dropout (ROADMAP queue 3)."""
    if not training or p == 0.0:
        return input
    _check_generator(generator)
    x = input.F
    return input._wrap(alpha_dropout_features(x, p, keep_mask(x, p, generator)))


# losses over sparse-tensor features (reference: MinkowskiFunctional.py:179-232)


def _feats(x):
    return x.F if hasattr(x, "F") else x


def _reduce(loss, reduction):
    return loss.mean() if reduction == "mean" else loss.sum()


def mse_loss(input, target, reduction: str = "mean"):
    d = _feats(input) - _feats(target)
    return _reduce(d * d, reduction)


def l1_loss(input, target, reduction: str = "mean"):
    return _reduce((_feats(input) - _feats(target)).abs(), reduction)


def binary_cross_entropy_with_logits(input, target, reduction: str = "mean"):
    x, t = _feats(input), _feats(target)
    return _reduce(torch.clamp_min(x, 0) - x * t + torch.log1p(torch.exp(-x.abs())), reduction)


def binary_cross_entropy(input, target, reduction: str = "mean"):
    """On probabilities clipped to [1e-7, 1 - 1e-7], as JAX computes it."""
    x, t = _feats(input), _feats(target)
    x = torch.clamp(x, 1e-7, 1 - 1e-7)
    return _reduce(-(t * torch.log(x) + (1 - t) * torch.log(1 - x)), reduction)


def cross_entropy(input, target, reduction: str = "mean"):
    """``target``: one integer class per row."""
    logp = torch.log_softmax(_feats(input), dim=-1)
    t = _feats(target).long()
    return _reduce(-logp.gather(1, t[:, None])[:, 0], reduction)
