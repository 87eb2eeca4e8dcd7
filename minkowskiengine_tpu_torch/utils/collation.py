"""Batch collation (reference: MinkowskiEngine/utils/collation.py).

Counterpart of ``minkowskiengine_tpu/utils/collation.py``.  Inputs may be
numpy arrays or tensors; outputs are torch tensors, as the reference
returns.  The batch index goes in column 0 of the coordinates.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def _with_batch(coord, batch_id: int, dtype) -> torch.Tensor:
    c = _as_tensor(coord)
    if c.is_floating_point():
        c = torch.floor(c)
    c = c.to(dtype)
    return torch.cat([torch.full((c.shape[0], 1), batch_id, dtype=dtype, device=c.device), c], 1)


def batched_coordinates(coords: Sequence, dtype=torch.int32, device=None) -> torch.Tensor:
    """Concatenate per-sample (N_i, D) coordinates into one (N, D+1) matrix,
    batch index first (reference: utils/collation.py:30-95)."""
    if not isinstance(coords, (list, tuple)):
        raise TypeError("The coordinates must be a list or tuple of arrays")
    dims = {tuple(_as_tensor(cs).shape[1:]) for cs in coords}
    if len(dims) != 1:
        raise ValueError(f"Dimension of the array mismatch. All dimensions: {dims}")
    out = torch.cat([_with_batch(cs, b, dtype).cpu() for b, cs in enumerate(coords)])
    return out.to(device) if device is not None else out


def sparse_collate(coords, feats, labels=None, dtype=torch.int32, device=None):
    """Collate per-sample (coords, feats[, labels]) lists into batch tensors
    (reference: utils/collation.py:96-190)."""
    use_label = labels is not None
    samples = zip(coords, feats, labels) if use_label else zip(coords, feats)
    coords_batch, feats_batch, labels_batch = [], [], []
    for batch_id, sample in enumerate(samples):
        coord, feat = _as_tensor(sample[0]), _as_tensor(sample[1])
        if coord.shape[0] != feat.shape[0]:
            raise ValueError("Coordinate and feature row mismatch")
        coords_batch.append(_with_batch(coord, batch_id, dtype).cpu())
        feats_batch.append(feat.cpu())
        if use_label:
            labels_batch.append(_as_tensor(sample[2]).cpu())
    out = [torch.cat(coords_batch), torch.cat(feats_batch)]
    if use_label:
        out.append(torch.cat(labels_batch))
    if device is not None:
        out = [t.to(device) for t in out]
    return tuple(out)


def batch_sparse_collate(data, dtype=torch.int32, device=None):
    """DataLoader ``collate_fn`` form: a list of (coords, feats[, labels])
    tuples (reference: utils/collation.py:191-228)."""
    return sparse_collate(*list(zip(*data)), dtype=dtype, device=device)


class SparseCollation:
    """Collation functor with a point-count limit
    (reference: utils/collation.py:229-263)."""

    def __init__(self, limit_numpoints: int = -1, dtype=torch.int32, device=None):
        self.limit_numpoints = limit_numpoints
        self.dtype = dtype
        self.device = device

    def __call__(self, list_data):
        coords, feats, labels = list(zip(*list_data))
        keep = len(coords)
        batch_num_points = 0
        for batch_id, coord in enumerate(coords):
            batch_num_points += len(coord)
            if 0 < self.limit_numpoints < batch_num_points:
                print(
                    f"\tCannot fit {sum(len(c) for c in coords)} points into "
                    f"{self.limit_numpoints} points limit. Truncating batch "
                    f"size at {batch_id} out of {len(coords)} with "
                    f"{batch_num_points - len(coord)}."
                )
                keep = batch_id
                break
        return sparse_collate(
            coords[:keep], feats[:keep], labels[:keep], dtype=self.dtype, device=self.device
        )
