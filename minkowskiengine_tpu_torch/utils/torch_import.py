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
reference stores (C,), the port (1, C); this module converts it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..nn.conv import MinkowskiConvolutionBase

__all__ = ["load_state_dict_from_reference"]


def load_state_dict_from_reference(model: nn.Module, state_dict: Mapping) -> None:
    """Copy a reference-format state dict (numpy arrays or tensors) into
    ``model`` in place.

    Strict: raises KeyError on unknown or missing keys and ValueError on a
    shape that does not match.
    """
    own = model.state_dict()
    unknown = sorted(k for k in state_dict if k not in own)
    if unknown:
        raise KeyError(f"{len(unknown)} keys match no parameter in the model: {unknown[:5]}")
    missing = sorted(k for k in own if k not in state_dict)
    if missing:
        raise KeyError(f"checkpoint missing {len(missing)} keys: {missing[:5]}")
    conv_biases = {
        f"{name}.bias"
        for name, m in model.named_modules()
        if isinstance(m, MinkowskiConvolutionBase) and m.bias is not None
    }
    converted = {}
    for key, value in state_dict.items():
        target = own[key]
        t = torch.tensor(np.asarray(value))
        if key in conv_biases and tuple(t.shape) == tuple(target.shape[1:]):
            t = t.reshape(target.shape)  # reference (C,) → port (1, C)
        if tuple(t.shape) != tuple(target.shape):
            raise ValueError(
                f"{key}: shape {tuple(t.shape)} != model {tuple(target.shape)}"
            )
        converted[key] = t.to(dtype=target.dtype)
    model.load_state_dict(converted, strict=True)
