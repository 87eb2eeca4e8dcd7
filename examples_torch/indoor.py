"""Indoor semantic segmentation on a room scan (reference: examples/indoor.py,
MinkUNet34C on ScanNet rooms; JAX: ``examples/indoor.py``).

The whole inference chain: load a point cloud (a ``.ply`` via
``--file_name``, or a deterministic synthetic room scan, since the
reference's ``1.ply`` and ``weights.pth`` are downloads), normalize the
colors, build a ``TensorField`` at 2 cm voxels with UNWEIGHTED_AVERAGE
quantization, voxelize it (``sparse()``), run ``MinkUNet34C`` in eval mode,
slice the voxel logits back onto the raw points, and write a color-coded
prediction cloud.  ``segment`` is that chain as one function.

The reference loads trained ScanNet weights (a download); here the network
has random weights from a seeded ``torch.Generator``, and its batch norms
take the statistics of one train-mode pass over the scan first
(``calibrate``), as a trained network carries them.

Run: python examples_torch/indoor.py [--cpu] [--file_name scan.ply]
         [--voxel_size 0.02] [--out indoor_prediction.ply]
"""

import runpy
import time
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.models import MinkUNet34C  # noqa: E402

CLASS_LABELS = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)

# one distinct color per class (ScanNet-style palette, rgb 0-255)
CLASS_COLORS = np.array(
    [
        (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
        (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
        (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
        (247, 182, 210), (219, 219, 141), (255, 127, 14), (158, 218, 229),
        (44, 160, 44), (112, 128, 144), (227, 119, 194), (82, 84, 163),
    ],
    dtype=np.float64,
)

_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}


def read_ply(path):
    """Minimal PLY reader (ascii / binary_little_endian, x y z [+colors]).

    Returns (points (N, 3) float64, colors (N, 3) float64 in [0, 1])."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt, n_vertex, props, line = None, None, [], b""
        in_vertex = False
        while line.strip() != b"end_header":
            line = f.readline()
            t = line.strip().split()
            if not t:
                continue
            if t[0] == b"format":
                fmt = t[1].decode()
            elif t[0] == b"element":
                in_vertex = t[1] == b"vertex"
                if in_vertex:
                    n_vertex = int(t[2])
            elif t[0] == b"property" and in_vertex:
                props.append((t[2].decode(), t[1].decode()))
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_vertex, ndmin=2)
            arr = {name: data[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + _PLY_TYPES[t]) for n, t in props])
            raw = np.frombuffer(f.read(n_vertex * dtype.itemsize), dtype)
            arr = {name: raw[name].astype(np.float64) for name, _ in props}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1)
    if "red" in arr:
        colors = np.stack([arr["red"], arr["green"], arr["blue"]], axis=1)
        if colors.max() > 1.0:
            colors = colors / 255.0
    else:
        colors = np.full_like(pts, 0.5)
    return pts, colors


def write_ply(path, points, colors_0_255):
    """ASCII PLY writer (points + uint8 colors)."""
    c = np.clip(colors_0_255, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, col in zip(points, c):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {col[0]} {col[1]} {col[2]}\n")


def synthetic_room(seed=0, n_points=200_000):
    """Room scan (4 x 5 x 2.5 m) with colors that loosely encode the surface:
    height and horizontal position."""
    pts = common.make_room_scan(n_points=n_points, extent=(4.0, 5.0, 2.5), seed=seed)
    colors = np.stack(
        [
            pts[:, 2] / 2.5,
            0.5 + 0.5 * np.sin(pts[:, 0] * 2.1),
            0.5 + 0.5 * np.cos(pts[:, 1] * 1.7),
        ],
        axis=1,
    ).astype(np.float64)
    return pts, colors


def normalize_color(color):
    """[0, 1] colors -> [-0.5, 0.5] (the reference's normalization,
    examples/indoor.py:normalize_color)."""
    return (color - 0.5).astype(np.float32)


def segment(points, colors, model, voxel_size, device):
    """Field -> sparse -> model -> slice: (per-point logits (N, classes) on
    ``device``, voxel count).  Each call builds a new coordinate manager."""
    in_field = MT.TensorField(
        features=torch.from_numpy(normalize_color(colors)).to(device),
        coordinates=MT.utils.batched_coordinates(
            [points / voxel_size], dtype=torch.float32
        ).to(device),
        quantization_mode=MT.SparseTensorQuantizationMode.UNWEIGHTED_AVERAGE,
    )
    sinput = in_field.sparse()
    soutput = model(sinput)
    return soutput.slice(in_field).features, sinput.size


def calibrate(model, points, colors, voxel_size, device):
    """Every batch norm takes the statistics of one train-mode pass over the
    scan (momentum 1), then the model goes to eval mode."""
    bns = [m.bn for m in model.modules() if isinstance(m, MT.MinkowskiBatchNorm)]
    momenta = [bn.momentum for bn in bns]
    model.train()
    for bn in bns:
        bn.momentum = 1.0
    with torch.no_grad():
        segment(points, colors, model, voxel_size, device)
    for bn, m in zip(bns, momenta):
        bn.momentum = m
    return model.eval()


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--file_name", type=str, default=None, help=".ply scan; synthetic room when omitted")
    p.add_argument("--n_points", type=int, default=200_000, help="points of the synthetic room")
    p.add_argument("--voxel_size", type=float, default=0.02)
    p.add_argument("--out", type=str, default="indoor_prediction.ply")
    args = p.parse_args(argv)
    device = common.device_of(args)

    if args.file_name:
        points, colors = read_ply(args.file_name)
        print(f"loaded {args.file_name}: {len(points)} points")
    else:
        points, colors = synthetic_room(n_points=args.n_points)
        print(f"synthetic room scan: {len(points)} points")

    model = MinkUNet34C(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=device)
    calibrate(model, points, colors, args.voxel_size, device)

    t0 = time.perf_counter()
    with torch.no_grad():
        logits, voxels = segment(points, colors, model, args.voxel_size, device)
        logits = logits.cpu().numpy()
    print(f"voxelized @ {args.voxel_size * 100:g} cm: {voxels} voxels; MinkUNet34C forward "
          f"+ slice: {time.perf_counter() - t0:.2f} s")

    pred = logits.argmax(1)
    counts = np.bincount(pred, minlength=20)
    print("predicted class histogram (top 5):")
    for cls in np.argsort(counts)[::-1][:5]:
        print(f"  {CLASS_LABELS[cls]:>16s}: {counts[cls]:7d} points "
              f"({100.0 * counts[cls] / len(pred):.1f}%)")

    write_ply(args.out, points, CLASS_COLORS[pred])
    print(f"wrote color-coded prediction cloud -> {args.out}")
    return {"points": len(points), "voxels": voxels, "logits": logits, "counts": counts,
            "out": args.out}


if __name__ == "__main__":
    main()
