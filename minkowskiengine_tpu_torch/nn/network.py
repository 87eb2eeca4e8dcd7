"""MinkowskiNetwork, the abstract base of networks over sparse tensors.

Counterpart of ``minkowskiengine_tpu/nn/network.py`` (reference:
MinkowskiEngine/MinkowskiNetwork.py:1-57).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from .module import MinkowskiModuleBase


class MinkowskiNetwork(MinkowskiModuleBase, ABC):
    """A network in ``D`` spatial dimensions; subclasses define ``forward``."""

    def __init__(self, D: int):
        super().__init__()
        self.D = int(D)

    @abstractmethod
    def forward(self, x):
        ...
