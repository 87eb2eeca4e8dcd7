"""MinkUNet semantic segmentation on a synthetic scene (reference:
examples/minkunet.py, examples/indoor.py; JAX: ``examples/minkunet.py``):
``MinkUNet34C`` trained with Adam on two random voxelized rooms.

Run: python examples_torch/minkunet.py [--cpu] [--n_points 8000] [--steps 5]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.models import MinkUNet34C  # noqa: E402


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--n_points", type=int, default=8000)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)
    device = common.device_of(args)

    coords, feats, labels = common.random_scene(n_points=args.n_points, batch_size=2)
    net = MinkUNet34C(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=device)
    optimizer = torch.optim.Adam(net.parameters(), lr=1e-3)
    x = MT.SparseTensor(torch.from_numpy(feats).to(device), torch.from_numpy(coords).to(device))
    y = torch.from_numpy(labels[: x.size]).long().to(device)

    losses = []
    for step in range(args.steps):
        optimizer.zero_grad()
        loss = torch.nn.functional.cross_entropy(net(x).F, y)
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        print(f"step {step}: loss {losses[-1]:.4f}")

    with torch.no_grad():
        pred = net(x).F.argmax(1)
    acc = (pred == y).float().mean().item()
    print(f"final voxel accuracy vs random labels: {acc:.3f}")
    return {"voxels": x.size, "losses": losses, "accuracy": acc}


if __name__ == "__main__":
    main()
