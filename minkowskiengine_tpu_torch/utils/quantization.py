"""Host-side quantization: raw float points to unique voxels, the data
loader's step before anything reaches the card.

Counterpart of ``minkowskiengine_tpu/utils/quantization.py`` (reference:
MinkowskiEngine/utils/quantization.py:32-363).  ``quantize`` and
``quantize_label`` run on the native host engine (``utils/hostengine.py``,
``csrc/hostengine.cpp``); ``quantize_reference`` and
``quantize_label_reference`` are their numpy versions, taken when the
engine cannot be built and by the tests.  Unique rows come in
first-occurrence order: ``coords[unique_map][inverse_map] == coords``.

``sparse_quantize`` takes numpy arrays or torch tensors and returns numpy
for numpy coordinates and torch tensors for torch coordinates, as the
reference does; the JAX package always returns numpy.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Sequence

import numpy as np
import torch

from . import hostengine


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def fnv_hash_vec(arr) -> np.ndarray:
    """FNV64-1A hash of each coordinate row (reference:
    utils/quantization.py:32-46)."""
    arr = _numpy(arr)
    assert arr.ndim == 2
    arr = arr.astype(np.uint64)
    hashed = np.full(arr.shape[0], np.uint64(14695981039346656037), dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed *= np.uint64(1099511628211)
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


def ravel_hash_vec(arr) -> np.ndarray:
    """Row-major ravel of each row within the rows' bounding box: a hash
    without collisions (reference: utils/quantization.py:49-65)."""
    arr = _numpy(arr)
    assert arr.ndim == 2
    arr = arr - arr.min(0)
    arr = arr.astype(np.uint64, copy=False)
    arr_max = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


def quantize_reference(coords: np.ndarray):
    """numpy (unique_map, inverse_map), int64, unique rows in
    first-occurrence order."""
    coords = np.ascontiguousarray(coords)
    _, unique_map, inverse_map = np.unique(coords, axis=0, return_index=True, return_inverse=True)
    # np.unique sorts; put the unique rows back in first-occurrence order
    order = np.argsort(unique_map)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return unique_map[order].astype(np.int64), rank[inverse_map.reshape(-1)].astype(np.int64)


def quantize_label_reference(coords: np.ndarray, labels: np.ndarray, ignore_label: int):
    """numpy (unique_map, inverse_map, labels of the unique rows); a voxel
    whose rows carry different labels gets ``ignore_label``."""
    unique_map, inverse_map = quantize_reference(coords)
    labels = np.asarray(labels)
    out_labels = labels[unique_map].copy()
    conflict = np.zeros(len(unique_map), dtype=bool)
    np.logical_or.at(conflict, inverse_map, labels != out_labels[inverse_map])
    out_labels[conflict] = ignore_label
    return unique_map, inverse_map, out_labels


def _native_int32(coords: np.ndarray):
    """The host engine, if it is loaded and the rows fit int32."""
    if coords.ndim != 2 or not (coords.dtype == np.int32 or np.can_cast(coords.dtype, np.int32)):
        return None
    return hostengine.load()


def quantize(coords):
    """(unique_map, inverse_map) over integer coordinate rows, int64 numpy
    (reference: src/quantization.cpp:57-139)."""
    coords = np.ascontiguousarray(_numpy(coords))
    lib = _native_int32(coords)
    if lib is not None:
        return hostengine.quantize_i32(lib, coords)
    return quantize_reference(coords)


def quantize_label(coords, labels, ignore_label: int):
    """(unique_map, inverse_map, labels of the unique rows); conflicting
    labels within a voxel give ``ignore_label`` (reference:
    src/quantization.cpp:141-260)."""
    coords = np.ascontiguousarray(_numpy(coords))
    labels = _numpy(labels)
    lib = _native_int32(coords)
    if lib is not None:
        return hostengine.quantize_label_i32(lib, coords, labels, ignore_label)
    return quantize_label_reference(coords, labels, ignore_label)


QuantizationReturnType = namedtuple("QuantizationReturnType", ["coordinates", "features", "labels"])


def sparse_quantize(
    coordinates,
    features=None,
    labels=None,
    ignore_label: int = -100,
    return_index: bool = False,
    return_inverse: bool = False,
    return_maps_only: bool = False,
    quantization_size=None,
    device: str = "cpu",
):
    """Voxelize a point cloud on the host (reference:
    utils/quantization.py:136-340): ``floor(coordinates /
    quantization_size)`` as int32, one row per voxel in first-occurrence
    order, with the features of each voxel's first point and the voxel's
    label (``ignore_label`` where its points disagree).

    Returns the coordinates, then the features, labels, unique map and
    inverse map where asked for, as a tuple (a single value when only the
    coordinates are asked for); with ``return_maps_only`` the unique map, or
    (unique map, inverse map).  ``device`` is the reference's argument;
    the work runs on the host whatever it says.
    """
    if return_inverse and not return_index:
        raise ValueError("return_index must be True when return_inverse is True")
    as_torch = isinstance(coordinates, torch.Tensor)
    coordinates = _numpy(coordinates)
    if coordinates.ndim != 2:
        raise ValueError("coordinates must be (N, D)")
    if quantization_size is not None:
        if isinstance(quantization_size, (Sequence, np.ndarray, torch.Tensor)):
            quantization_size = np.asarray(_numpy(quantization_size), np.float64)
        else:
            quantization_size = np.full(coordinates.shape[1], float(quantization_size))
        if np.any(quantization_size <= 0):
            raise ValueError("quantization_size must be positive")
        discrete = np.floor(coordinates / quantization_size)
    else:
        discrete = np.floor(coordinates)
    discrete = discrete.astype(np.int32)

    if labels is not None:
        unique_map, inverse_map, labels = quantize_label(discrete, labels, ignore_label)
    else:
        unique_map, inverse_map = quantize(discrete)

    def out(a):
        return torch.from_numpy(np.ascontiguousarray(a)) if as_torch else a

    if return_maps_only:
        return (out(unique_map), out(inverse_map)) if return_inverse else out(unique_map)
    result = [discrete[unique_map]]
    if features is not None:
        result.append(_numpy(features)[unique_map])
    if labels is not None:
        result.append(labels)
    if return_index:
        result.append(unique_map)
    if return_inverse:
        result.append(inverse_map)
    result = [out(a) for a in result]
    return result[0] if len(result) == 1 else tuple(result)
