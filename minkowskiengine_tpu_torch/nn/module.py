"""The base class of Minkowski modules.

Counterpart of ``minkowskiengine_tpu/nn/module.py`` (reference:
MinkowskiEngine/MinkowskiCommon.py ``MinkowskiModuleBase``).  The port's
modules are ``torch.nn.Module``s; this base is for user code that
subclasses the reference's.
"""

from __future__ import annotations

from torch import nn


class MinkowskiModuleBase(nn.Module):
    pass


def get_postfix(tensor) -> str:
    """The backend suffix of the reference's function names: none, as in the
    JAX package, since the port's functions take a tensor on either device."""
    return ""
