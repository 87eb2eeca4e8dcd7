"""Shared helpers of the PyTorch examples: the synthetic data generators and
the device choice.

Counterpart of ``examples/common.py``.  Every generator draws from a seeded
``np.random.RandomState`` and returns the same arrays as the JAX package's
for the same seed, bit for bit: ``data_loader``, ``random_scene``,
``random_point_cloud``, and the synthetic ModelNet shapes (``synthetic_shape``,
``CoordinateTransformation``, ``modelnet_batch``), which the package keeps in
``minkowskiengine_tpu_torch/utils/datasets.py``.  ``data_loader`` collates
with the package's ``sparse_collate``, so its coordinates and features come
back as tensors.

The scripts run this file by its path (``runpy.run_path``), so another
module called ``common`` cannot stand in for it; it puts the repository
root, which holds the package, on ``sys.path`` for them.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.utils.datasets import (  # noqa: F401,E402  (re-exported)
    SHAPE_CLASSES,
    CoordinateTransformation,
    make_room_scan,
    modelnet_batch,
    synthetic_shape,
)


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--cpu`` flag."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    return p


def device_of(args) -> torch.device:
    """The card unless ``--cpu`` was given; without a card and without
    ``--cpu`` this raises, as the package's entry points do: nothing runs
    on the CPU unasked."""
    return torch.device("cpu") if args.cpu else MT.types.resolve_device(None)


def data_loader(nchannel=3, max_label=5, is_classification=True, seed=0,
                batch_size=4, dimension=2):
    """Tiny deterministic batch, reference-style
    (tests/python/common.py:57-70): (coordinates (N, D+1) int32 tensor,
    features (N, nchannel) float32 tensor, labels int32 array: one per
    cloud, or one per row)."""
    rng = np.random.RandomState(seed)
    coords_list, feats_list, labels = [], [], []
    for _ in range(batch_size):
        n = rng.randint(20, 40)
        coords = rng.randint(-10, 10, (n, dimension))
        feats = rng.randn(n, nchannel).astype(np.float32)
        coords_list.append(coords)
        feats_list.append(feats)
        labels.append(rng.randint(0, max_label))
    coords, feats = MT.utils.sparse_collate(coords_list, feats_list)
    if is_classification:
        label = np.array(labels, np.int32)
    else:
        label = rng.randint(0, max_label, len(coords)).astype(np.int32)
    return coords, feats, label


def random_scene(n_points=10000, room=(100, 100, 50), batch_size=1, seed=0):
    """ScanNet-like voxelized room(s): unique int voxels + rgb-ish features."""
    rng = np.random.RandomState(seed)
    coords = np.unique(
        np.concatenate(
            [
                rng.randint(0, batch_size, (n_points * 2, 1)),
                rng.randint(0, room[0], (n_points * 2, 1)),
                rng.randint(0, room[1], (n_points * 2, 1)),
                rng.randint(0, room[2], (n_points * 2, 1)),
            ],
            axis=1,
        ).astype(np.int32),
        axis=0,
    )[:n_points]
    feats = rng.rand(len(coords), 3).astype(np.float32)
    labels = rng.randint(0, 20, len(coords)).astype(np.int32)
    return coords, feats, labels


def random_point_cloud(n_points=2048, batch_size=4, scale=20.0, seed=0):
    """Continuous-coordinate point clouds for TensorField pipelines."""
    rng = np.random.RandomState(seed)
    coords = np.concatenate(
        [
            rng.randint(0, batch_size, (n_points, 1)).astype(np.float32),
            (rng.rand(n_points, 3) * scale).astype(np.float32),
        ],
        axis=1,
    )
    feats = rng.randn(n_points, 3).astype(np.float32)
    labels = rng.randint(0, 40, batch_size).astype(np.int32)
    return coords, feats, labels
