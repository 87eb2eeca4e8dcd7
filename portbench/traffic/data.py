"""Frozen copies of the port's synthetic data, so that a later change to
the port cannot move the yardstick.

``make_room_scan`` and ``voxelize_scan`` are copies of
``minkowskiengine_tpu_torch/utils/datasets.py``, as are ``synthetic_shape``
and ``completion_batch``; ``room_colors`` and ``normalize_color`` copy
``examples_torch/indoor.py``'s ``synthetic_room`` colours and
``normalize_color``; ``height_band`` is ``chip_smoke.py``'s label rule.
A room scan's points lie on the surfaces of a synthetic room (floor,
ceiling, walls and box furniture, with sensor noise); a shape is one of
eight parametric surfaces of about unit diameter.
"""

from __future__ import annotations

from typing import Sequence

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
    # gathered from per-rectangle tables: the values of the port's per-point lists
    origins, us, vs = (np.stack([r[j] for r in rects])[choice] for j in range(3))
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


def room_colors(pts):
    """Colours that loosely encode the surface: height and horizontal
    position, in [0, 1]."""
    return np.stack(
        [pts[:, 2] / 2.5, 0.5 + 0.5 * np.sin(pts[:, 0] * 2.1), 0.5 + 0.5 * np.cos(pts[:, 1] * 1.7)],
        axis=1,
    ).astype(np.float64)


def normalize_color(color):
    """[0, 1] colours -> [-0.5, 0.5]."""
    return (color - 0.5).astype(np.float32)


def height_band(z_metres, classes=20, band=0.125):
    """The label of a height: ``floor(z / band) mod classes``."""
    return (np.floor(z_metres / band).astype(np.int64) % classes)
