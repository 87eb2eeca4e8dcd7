"""Deterministic synthetic data (numpy only): room scans and shapes.

Room scans are a copy of ``minkowskiengine_tpu/utils/datasets.py``; the
shapes (``SHAPE_CLASSES``, ``synthetic_shape``, ``CoordinateTransformation``,
``modelnet_batch``) a copy of ``examples/common.py``, kept in the port so
that it imports neither.  The same seed gives the same points in both
packages (the same ``numpy.random.RandomState`` draws, in the same order).

A scan's points lie on the surfaces of a synthetic room (floor, ceiling,
walls and box furniture, with sensor noise): the voxel-occupancy statistics
of a real indoor RGB-D scan.  A shape batch stands in for ModelNet40, whose
files are not in the repository: eight parametric surface classes of about
unit diameter, with the reference example's train-time augmentation.
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


# ---------------------------------------------------------------------------
# Synthetic ModelNet: parametric shape classes + the reference's
# augmentation pipeline (reference: examples/pointnet.py:158-181
# CoordinateTransformation, examples/classification_modelnet40.py ModelNet40H5)
# ---------------------------------------------------------------------------

COMPLETION_POINTS = 1_600_000  # points per shape of ``completion_batch``

SHAPE_CLASSES = (
    "sphere", "cube", "cylinder", "cone", "torus",
    "pyramid", "table", "cross",
)


def _unit(v):
    return v / np.linalg.norm(v)


def synthetic_shape(cls_id, n_points, rng):
    """(n_points, 3) float32 points on the surface of shape class
    ``cls_id`` (see SHAPE_CLASSES), roughly unit scale, centered."""
    name = SHAPE_CLASSES[cls_id % len(SHAPE_CLASSES)]
    u = rng.rand(n_points)
    v = rng.rand(n_points)
    if name == "sphere":
        phi = 2 * np.pi * u
        z = 2 * v - 1
        r = np.sqrt(np.maximum(0, 1 - z * z))
        pts = np.stack([r * np.cos(phi), r * np.sin(phi), z], 1) * 0.5
    elif name == "cube":
        face = rng.randint(0, 6, n_points)
        a, b = u - 0.5, v - 0.5
        fixed = np.where(face % 2 == 0, -0.5, 0.5)
        pts = np.empty((n_points, 3))
        ax = face // 2
        for d in range(3):
            o = (d + 1) % 3, (d + 2) % 3
            m = ax == d
            pts[m, d] = fixed[m]
            pts[m, o[0]] = a[m]
            pts[m, o[1]] = b[m]
    elif name == "cylinder":
        phi = 2 * np.pi * u
        pts = np.stack(
            [0.35 * np.cos(phi), 0.35 * np.sin(phi), v - 0.5], 1
        )
    elif name == "cone":
        phi = 2 * np.pi * u
        h = np.sqrt(v)  # area-weighted toward the base
        r = 0.5 * (1 - h)
        pts = np.stack([r * np.cos(phi), r * np.sin(phi), h - 0.5], 1)
    elif name == "torus":
        phi, theta = 2 * np.pi * u, 2 * np.pi * v
        R, r = 0.35, 0.15
        pts = np.stack(
            [
                (R + r * np.cos(theta)) * np.cos(phi),
                (R + r * np.cos(theta)) * np.sin(phi),
                r * np.sin(theta),
            ],
            1,
        )
    elif name == "pyramid":
        # square base + 4 triangular faces
        face = rng.randint(0, 5, n_points)
        pts = np.empty((n_points, 3))
        base = face == 0
        pts[base] = np.stack(
            [u[base] - 0.5, v[base] - 0.5, np.full(base.sum(), -0.5)], 1
        )
        apex = np.array([0.0, 0.0, 0.5])
        corners = np.array(
            [[-0.5, -0.5, -0.5], [0.5, -0.5, -0.5],
             [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5]]
        )
        for i in range(4):
            m = face == i + 1
            a, b = corners[i], corners[(i + 1) % 4]
            s, t = u[m], v[m] * (1 - u[m])  # uniform on triangle-ish
            pts[m] = apex + np.outer(s, a - apex) + np.outer(t, b - a)
    elif name == "table":
        # flat top + 4 thin legs
        leg = rng.rand(n_points) < 0.4
        pts = np.empty((n_points, 3))
        top = ~leg
        pts[top] = np.stack(
            [u[top] - 0.5, v[top] - 0.5, np.full(top.sum(), 0.3)], 1
        )
        corner = rng.randint(0, 4, leg.sum())
        cx = np.where(corner % 2 == 0, -0.4, 0.4)
        cy = np.where(corner // 2 == 0, -0.4, 0.4)
        pts[leg] = np.stack(
            [cx + 0.03 * (u[leg] - 0.5), cy + 0.03 * (v[leg] - 0.5),
             0.8 * v[leg] - 0.5], 1
        )
    else:  # cross: two perpendicular planes
        which = rng.rand(n_points) < 0.5
        pts = np.empty((n_points, 3))
        pts[which] = np.stack(
            [u[which] - 0.5, np.zeros(which.sum()), v[which] - 0.5], 1
        )
        pts[~which] = np.stack(
            [np.zeros((~which).sum()), u[~which] - 0.5, v[~which] - 0.5], 1
        )
    return pts.astype(np.float32)


class CoordinateTransformation:
    """Train-time augmentation: random z-rotation, anisotropic scale,
    translation, clipped jitter (reference: examples/pointnet.py:158-181)."""

    def __init__(self, scale_range=(0.9, 1.1), trans=0.25, jitter=0.025,
                 clip=0.05, rotate=True):
        self.scale_range = scale_range
        self.trans = trans
        self.jitter = jitter
        self.clip = clip
        self.rotate = rotate

    def __call__(self, coords, rng):
        if self.rotate:
            a = rng.uniform(0, 2 * np.pi)
            rot = np.array(
                [[np.cos(a), -np.sin(a), 0],
                 [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]], np.float32
            )
            coords = coords @ rot.T
        scale = rng.uniform(*self.scale_range, (1, 3)).astype(np.float32)
        trans = rng.uniform(-self.trans, self.trans, (1, 3)).astype(np.float32)
        noise = np.clip(
            rng.normal(0, self.jitter, coords.shape), -self.clip, self.clip
        ).astype(np.float32)
        return coords * scale + trans + noise

    def __repr__(self):
        return (f"Transformation(scale={self.scale_range}, "
                f"trans={self.trans}, jitter={self.jitter})")


def modelnet_batch(batch_size, n_points=512, seed=0, transform=None,
                   voxel_size=0.05):
    """One collated TensorField-ready batch of synthetic shapes.

    Returns (coordinates (B*n, 4) float32 batched+scaled for ``voxel_size``,
    features (B*n, 3) float32 = centered xyz, labels (B,) int32)."""
    rng = np.random.RandomState(seed)
    coords_list, feats = [], []
    labels = rng.randint(0, len(SHAPE_CLASSES), batch_size).astype(np.int32)
    for b, lab in enumerate(labels):
        xyz = synthetic_shape(int(lab), n_points, rng)
        if transform is not None:
            xyz = transform(xyz, rng)
        coords_list.append(
            np.concatenate(
                [np.full((n_points, 1), b, np.float32), xyz / voxel_size], 1
            )
        )
        feats.append(xyz)
    return (
        np.concatenate(coords_list).astype(np.float32),
        np.concatenate(feats).astype(np.float32),
        labels,
    )


def completion_batch(batch_size, resolution=128, seed=0, n_points=COMPLETION_POINTS):
    """One batch for shape completion and the VAE: the stand-in for the
    reference completion example's ModelNet40 meshes.

    Shape classes are drawn as ``modelnet_batch`` draws them (the same
    ``RandomState`` draws, in the same order); each unit-diameter surface is
    shifted into [0, 1), scaled by ``resolution`` and quantized at one voxel.
    ``n_points`` per shape (default COMPLETION_POINTS, 1,600,000) is enough
    that doubling it adds under 2% more voxels to a batch at a 128³
    resolution (``tests/test_torch_generative.py`` checks a batch of four).

    Returns (partial (N_p, 4) int32, features (N_p, 1) float32 ones,
    full (N_f, 4) int32): ``full`` is every voxel of each shape, ``partial``
    its voxels whose x lies below the centre, the crop of the reference
    example's ``make_shape``; column 0 is the batch index.
    """
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, len(SHAPE_CLASSES), batch_size).astype(np.int32)
    full = []
    for b, lab in enumerate(labels):
        xyz = synthetic_shape(int(lab), n_points, rng)
        vox = np.clip(np.floor((xyz + 0.5) * resolution), 0, resolution - 1).astype(np.int64)
        key = np.unique((vox[:, 0] * resolution + vox[:, 1]) * resolution + vox[:, 2])
        vox = np.stack([key // resolution**2, key // resolution % resolution,
                        key % resolution], 1).astype(np.int32)
        full.append(np.concatenate([np.full((len(vox), 1), b, np.int32), vox], 1))
    full = np.concatenate(full)
    partial = full[full[:, 1] < resolution / 2]
    return partial, np.ones((len(partial), 1), np.float32), full
