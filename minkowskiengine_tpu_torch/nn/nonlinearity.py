"""Elementwise nonlinearities on sparse-tensor features.

Counterpart of ``minkowskiengine_tpu/nn/nonlinearity.py``; only the ReLU that
the MinkUNet path uses is ported so far.
"""

from __future__ import annotations

import torch
from torch import nn


class MinkowskiReLU(nn.Module):
    def forward(self, input):
        return input._wrap(torch.relu(input.F))
