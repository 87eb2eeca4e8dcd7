"""Sparse ResNet classification on a point cloud (reference:
examples/resnet.py, which downloads a PLY; JAX: ``examples/resnet.py``).

The procedural room scan stands in for the download: continuous points are
voxelized by ``sparse_quantize``, and ``ResNet14``, ``ResNet18`` and
``ResNet34`` classify the voxels with global pooling.

Run: python examples_torch/resnet.py [--cpu] [--n_points 60000]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.models import ResNet14, ResNet18, ResNet34  # noqa: E402


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--n_points", type=int, default=60_000)
    p.add_argument("--voxel_size", type=float, default=0.05)
    args = p.parse_args(argv)
    device = common.device_of(args)

    # continuous points -> voxel coordinates, as the reference quantizes its PLY
    points = common.make_room_scan(n_points=args.n_points, seed=0)
    coords, index = MT.utils.sparse_quantize(
        np.floor(points / args.voxel_size).astype(np.int32), return_index=True
    )
    feats = points[index].astype(np.float32)  # xyz as features
    bcoords = np.concatenate([np.zeros((len(coords), 1), np.int32), coords], axis=1)
    print(f"{len(points)} points -> {len(coords)} voxels @ {args.voxel_size} m")

    x = MT.SparseTensor(torch.from_numpy(feats).to(device), torch.from_numpy(bcoords).to(device))
    out = {}
    for cls in (ResNet14, ResNet18, ResNet34):
        net = cls(3, 10, D=3, generator=torch.Generator().manual_seed(0), device=device).eval()
        with torch.no_grad():
            logits = net(x).F.cpu()
        out[cls.__name__] = logits
        print(f"{cls.__name__}: logits {tuple(logits.shape)}, argmax {int(logits.argmax())}")
    return {"voxels": len(coords), "logits": out}


if __name__ == "__main__":
    main()
