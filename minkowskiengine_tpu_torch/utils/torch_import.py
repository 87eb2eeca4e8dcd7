"""Load weights in reference MinkowskiEngine state-dict format.

The port's modules are named like the reference's, so ``model.state_dict()``
keys are the reference names (``conv0p1s1.kernel``, ``bn0.bn.weight``,
``block1.0.conv1.kernel``, ``mlp1.0.linear.weight``, ``conv1.1.weight``
of an instance norm, ``dec_blocks.0.0.kernel`` of CompletionNet,
``encoder.linear_mean.linear.weight`` of the VAE, ...), the names under which the JAX package's
``minkowskiengine_tpu.utils.torch_import.export_reference_state_dict``
exports its weights.  ``MinkowskiLinear`` wraps ``torch.nn.Linear``, so
``linear.weight`` is (out, in) on both sides; an instance norm's
``weight`` and ``bias`` are (1, C) on both.  The one layout that differs is
a convolution bias (CompletionNet's and the VAE's classifier heads): the
reference stores (C,), the port (1, C); this module converts it.  The
layers added later name theirs as the JAX package does: a channelwise
convolution's ``kernel`` (K, C) and ``bias`` (1, C), PReLU's ``weight``,
Sinusoidal's ``kernel`` (in, out), and the adaptive log-softmax's
``head.weight`` and ``tail.{i}.{0,1}.weight`` as ``torch.nn``'s.

``reference_named_params``, ``export_reference_state_dict`` and
``load_reference_state_dict`` carry the JAX package's names;
``load_state_dict_from_reference`` is the strict load alone.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = [
    "export_reference_state_dict",
    "load_reference_state_dict",
    "load_state_dict_from_reference",
    "reference_named_params",
]


def _conv_biases(model: nn.Module):
    # imported here: nn imports the coordinate engine, which imports utils
    from ..nn.conv import MinkowskiConvolutionBase

    return {
        f"{name}.bias" if name else "bias"
        for name, m in model.named_modules()
        if isinstance(m, MinkowskiConvolutionBase) and m.bias is not None
    }


def _whole(model: nn.Module, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``named`` with each parameter that tensor parallelism cut
    (``parallel.apply_tensor_parallelism``) gathered whole from the ranks of
    its model group."""
    for name, m in model.named_modules():
        cp = getattr(m, "column_parallel", None)
        for path, dim in (cp.sharded if cp is not None else ()):
            key = f"{name}.{path}" if name else path
            named[key] = cp.whole(named[key], dim)
    return named


def reference_named_params(module: nn.Module, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``module`` under its reference name, in
    the reference's layout: the state dict, with each convolution bias
    viewed as (C,); each name after ``prefix.`` when ``prefix`` is given, as
    JAX's takes it.  A tensor-parallel model's cut parameters come whole
    (a collective over the model group: every rank calls it)."""
    biases = _conv_biases(module)
    named = _whole(module, module.state_dict(keep_vars=True))
    p = prefix + "." if prefix else ""
    return {p + k: v.reshape(-1) if k in biases else v for k, v in named.items()}


def export_reference_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and buffers as a reference-format state dict
    of numpy arrays."""
    return {k: v.detach().cpu().numpy().copy() for k, v in reference_named_params(model).items()}


def load_reference_state_dict(model: nn.Module, state_dict: Mapping, *, strict: bool = True):
    """Copy a reference-format state dict (numpy arrays or tensors) into
    ``model`` in place; returns ``{"loaded", "skipped", "missing"}`` lists
    of keys.  ``strict``: a KeyError on an unknown or a missing key; a
    shape that does not match is always a ValueError."""
    own = model.state_dict()
    unknown = sorted(k for k in state_dict if k not in own)
    if strict and unknown:
        raise KeyError(f"{len(unknown)} keys match no parameter in the model: {unknown[:5]}")
    missing = sorted(k for k in own if k not in state_dict)
    if strict and missing:
        raise KeyError(f"checkpoint missing {len(missing)} keys: {missing[:5]}")
    biases = _conv_biases(model)
    converted = {}
    for key, value in state_dict.items():
        if key not in own:
            continue
        target = own[key]
        t = value.detach().cpu() if isinstance(value, torch.Tensor) else torch.tensor(np.asarray(value))
        if key in biases and tuple(t.shape) == tuple(target.shape[1:]):
            t = t.reshape(target.shape)  # reference (C,) → port (1, C)
        if tuple(t.shape) != tuple(target.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != model {tuple(target.shape)}")
        converted[key] = t.to(dtype=target.dtype)
    model.load_state_dict(converted, strict=strict)
    return {"loaded": list(converted), "skipped": unknown, "missing": missing}


def load_state_dict_from_reference(model: nn.Module, state_dict: Mapping) -> None:
    """Strict ``load_reference_state_dict``: raises KeyError on unknown or
    missing keys and ValueError on a shape that does not match."""
    load_reference_state_dict(model, state_dict, strict=True)
