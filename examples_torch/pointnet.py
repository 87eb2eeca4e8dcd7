"""PointNet through Minkowski ops (reference: examples/pointnet.py, PointNet
as a special case of a sparse FCNN: 1x1 "convolutions" on a TensorField and
a global max pool; JAX: ``examples/pointnet.py``).

The reference trains on ModelNet40 HDF5 files (a download); the synthetic
8-class shapes of ``common.py`` stand in, with the reference's augmentation.

Run: python examples_torch/pointnet.py [--cpu] [--steps 20]
"""

import runpy
import time
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.models import MinkowskiPointNet  # noqa: E402


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--n_points", type=int, default=256)
    p.add_argument("--eval_batches", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    args = p.parse_args(argv)
    device = common.device_of(args)

    n_classes = len(common.SHAPE_CLASSES)
    net = MinkowskiPointNet(3, n_classes, embedding_channel=256, dimension=3,
                            generator=torch.Generator().manual_seed(0), device=device)
    print("MinkowskiPointNet: 1x1 sparse convs on a TensorField + global max pool "
          "(reference examples/pointnet.py:108-156)")
    transform = common.CoordinateTransformation(trans=0.1)
    optimizer = torch.optim.Adam(net.parameters(), lr=args.lr)

    def batch(seed, train):
        coords, feats, labels = common.modelnet_batch(
            args.batch_size, n_points=args.n_points, seed=seed,
            transform=transform if train else None, voxel_size=0.02,
        )
        field = MT.TensorField(torch.from_numpy(feats).to(device),
                               torch.from_numpy(coords).to(device))
        return field, torch.from_numpy(labels).long().to(device)

    t0 = time.perf_counter()
    losses = []
    net.train()
    for step in range(args.steps):
        field, y = batch(step, train=True)
        logits = net(field)
        loss = torch.nn.functional.cross_entropy(logits, y)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        acc = (logits.argmax(1) == y).float().mean().item()
        if (step + 1) % 5 == 0:
            print(f"step {step + 1:3d}: loss {losses[-1]:.4f} acc {acc:.2%}")

    correct = total = 0
    net.eval()
    with torch.no_grad():
        for i in range(args.eval_batches):
            field, y = batch(20_000 + i, train=False)
            correct += int((net(field).argmax(1) == y).sum())
            total += int(y.shape[0])
    print(f"{args.steps} steps in {time.perf_counter() - t0:.1f}s | held-out accuracy "
          f"{correct / total:.2%} (chance {1.0 / n_classes:.2%})")
    return {"losses": losses, "accuracy": correct / total}


if __name__ == "__main__":
    main()
