"""Deterministic synthetic room scans (numpy only).

A copy of ``minkowskiengine_tpu/utils/datasets.py``, kept in the port so the
port does not import the JAX package.  A scan's points lie on the surfaces
of a synthetic room (floor, ceiling, walls and box furniture, with sensor
noise): the voxel-occupancy statistics of a real indoor RGB-D scan, made
from a seed.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _rects_for_room(
    rng: np.random.RandomState,
    extent: Sequence[float],
    n_objects: int,
):
    """Axis-aligned rectangles (origin, edge u, edge v) tiling a room shell
    plus the visible faces of ``n_objects`` furniture boxes."""
    ex, ey, ez = extent
    rects = []

    def rect(origin, u, v):
        rects.append(
            (
                np.asarray(origin, np.float64),
                np.asarray(u, np.float64),
                np.asarray(v, np.float64),
            )
        )

    # room shell: floor, ceiling, 4 walls
    rect((0, 0, 0), (ex, 0, 0), (0, ey, 0))
    rect((0, 0, ez), (ex, 0, 0), (0, ey, 0))
    rect((0, 0, 0), (ex, 0, 0), (0, 0, ez))
    rect((0, ey, 0), (ex, 0, 0), (0, 0, ez))
    rect((0, 0, 0), (0, ey, 0), (0, 0, ez))
    rect((ex, 0, 0), (0, ey, 0), (0, 0, ez))

    # furniture: boxes on the floor; 5 visible faces each (no bottom)
    for _ in range(n_objects):
        sx = rng.uniform(0.3, 1.5)
        sy = rng.uniform(0.3, 1.5)
        sz = rng.uniform(0.3, 1.2)
        ox = rng.uniform(0.1, max(ex - sx - 0.1, 0.2))
        oy = rng.uniform(0.1, max(ey - sy - 0.1, 0.2))
        rect((ox, oy, sz), (sx, 0, 0), (0, sy, 0))  # top
        rect((ox, oy, 0), (sx, 0, 0), (0, 0, sz))  # -y face
        rect((ox, oy + sy, 0), (sx, 0, 0), (0, 0, sz))  # +y face
        rect((ox, oy, 0), (0, sy, 0), (0, 0, sz))  # -x face
        rect((ox + sx, oy, 0), (0, sy, 0), (0, 0, sz))  # +x face
    return rects


def make_room_scan(
    n_points: int = 400_000,
    extent: Sequence[float] = (4.0, 5.0, 2.5),
    n_objects: int = 6,
    noise: float = 0.003,
    seed: int = 0,
) -> np.ndarray:
    """(n_points, 3) float32 points on the surfaces of a synthetic room.

    Deterministic for a given seed.  Points are area-weighted across the
    room shell + furniture faces, with Gaussian sensor noise of std
    ``noise`` meters — statistics shaped like a real RGB-D room scan.
    """
    rng = np.random.RandomState(seed)
    rects = _rects_for_room(rng, extent, n_objects)
    areas = np.array(
        [np.linalg.norm(np.cross(u, v)) for _, u, v in rects]
    )
    probs = areas / areas.sum()
    choice = rng.choice(len(rects), size=n_points, p=probs)
    a = rng.uniform(0, 1, (n_points, 1))
    b = rng.uniform(0, 1, (n_points, 1))
    origins = np.stack([rects[i][0] for i in choice])
    us = np.stack([rects[i][1] for i in choice])
    vs = np.stack([rects[i][2] for i in choice])
    pts = origins + a * us + b * vs
    pts = pts + rng.normal(0.0, noise, pts.shape)
    return pts.astype(np.float32)


def voxelize_scan(
    points: np.ndarray, voxel_size: float, batch_index: int = 0
) -> np.ndarray:
    """Quantize float points to unique batched int32 voxel coordinates
    (floor division — the reference's quantization rule,
    src/quantization.cpp:57-139)."""
    disc = np.floor(points / voxel_size).astype(np.int32)
    disc = np.unique(disc, axis=0)
    batch = np.full((len(disc), 1), batch_index, np.int32)
    return np.concatenate([batch, disc], axis=1)


def room_scan_voxels(
    voxel_size: float = 0.05,
    n_points: int = 400_000,
    seed: int = 0,
    **kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """(coords, feats): unique voxels of a room scan + unit-normal colors."""
    pts = make_room_scan(n_points=n_points, seed=seed, **kw)
    coords = voxelize_scan(pts, voxel_size)
    rng = np.random.RandomState(seed + 1)
    feats = rng.randn(len(coords), 3).astype(np.float32)
    return coords, feats
