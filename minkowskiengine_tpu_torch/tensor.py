"""Tensor base: operation modes and the global coordinate manager.

Counterpart of ``minkowskiengine_tpu/tensor.py`` (reference:
MinkowskiEngine/MinkowskiTensor.py:33-136).
"""

from __future__ import annotations

from typing import Optional

from .coords.manager import CoordinateManager
from .types import SparseTensorOperationMode, SparseTensorQuantizationMode

_sparse_tensor_operation_mode = SparseTensorOperationMode.SEPARATE_COORDINATE_MANAGER
_global_coordinate_manager: Optional[CoordinateManager] = None


def set_sparse_tensor_operation_mode(operation_mode: SparseTensorOperationMode):
    """Set the global coordinate-manager sharing policy."""
    global _sparse_tensor_operation_mode
    if not isinstance(operation_mode, SparseTensorOperationMode):
        raise ValueError(
            "Input must be an instance of SparseTensorOperationMode, got "
            f"{operation_mode!r}"
        )
    _sparse_tensor_operation_mode = operation_mode


def sparse_tensor_operation_mode() -> SparseTensorOperationMode:
    return _sparse_tensor_operation_mode


def global_coordinate_manager() -> Optional[CoordinateManager]:
    return _global_coordinate_manager


def set_global_coordinate_manager(manager: Optional[CoordinateManager]):
    global _global_coordinate_manager
    _global_coordinate_manager = manager


def clear_global_coordinate_manager():
    """Drop the shared manager and every map it caches."""
    set_global_coordinate_manager(None)
