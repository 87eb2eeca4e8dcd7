"""Checkpoints: ``torch.save`` of a model's state dict, as the reference's
examples save theirs (examples/completion.py:573,667-668).

Counterpart of ``minkowskiengine_tpu/utils/checkpoint.py`` (orbax there).
Coordinate managers are not saved: they are rebuilt from the data on
resume.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn


def save_checkpoint(path: str, model: nn.Module, extra: Optional[dict] = None) -> str:
    """Write the model's state dict, and ``extra`` (tensors and plain Python
    values), to ``path``; returns the absolute path."""
    path = os.path.abspath(path)
    payload = {"model": model.state_dict()}
    if extra is not None:
        payload["extra"] = extra
    torch.save(payload, path)
    return path


def load_checkpoint(path: str, model: nn.Module):
    """Restore ``model`` in place from ``path``; returns the ``extra``
    payload, or None."""
    payload = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    return payload.get("extra")
