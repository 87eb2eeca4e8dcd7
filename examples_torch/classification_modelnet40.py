"""Point-cloud classification, ModelNet40-style: a training loop with data
loading, augmentation and held-out evaluation (reference:
examples/classification_modelnet40.py:241-441; JAX:
``examples/classification_modelnet40.py``).

The ModelNet40 HDF5 files are a download; the synthetic 8-class shapes of
``common.py`` (sphere, cube, cylinder, cone, torus, pyramid, table, cross)
stand in, through the same pipeline: float coordinates -> TensorField ->
quantized SparseTensor inside the network -> global pooling -> logits.

Run: python examples_torch/classification_modelnet40.py [--cpu]
         [--network minkfcnn|minksplatfcnn|minkpointnet] [--steps 30]
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
from minkowskiengine_tpu_torch.models import (  # noqa: E402
    MinkowskiFCNN,
    MinkowskiPointNet,
    MinkowskiSplatFCNN,
)

NETWORKS = {"minkfcnn": MinkowskiFCNN, "minksplatfcnn": MinkowskiSplatFCNN,
            "minkpointnet": MinkowskiPointNet}


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--network", choices=sorted(NETWORKS), default="minkfcnn")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--n_points", type=int, default=512)
    p.add_argument("--voxel_size", type=float, default=0.05)
    p.add_argument("--eval_batches", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    args = p.parse_args(argv)
    device = common.device_of(args)

    n_classes = len(common.SHAPE_CLASSES)
    kwargs = {"dimension": 3} if args.network == "minkpointnet" else {"D": 3}
    net = NETWORKS[args.network](3, n_classes, generator=torch.Generator().manual_seed(0),
                                 device=device, **kwargs)
    print(f"network: {args.network} | classes: {common.SHAPE_CLASSES}")
    # the reference's training transform (make_data_loader: CoordinateTransformation)
    train_transform = common.CoordinateTransformation()
    optimizer = torch.optim.Adam(net.parameters(), lr=args.lr)

    def forward_batch(seed, transform):
        coords, feats, labels = common.modelnet_batch(
            args.batch_size, n_points=args.n_points, seed=seed, transform=transform,
            voxel_size=args.voxel_size,
        )
        field = MT.TensorField(torch.from_numpy(feats).to(device),
                               torch.from_numpy(coords).to(device))
        return field, torch.from_numpy(labels).long().to(device)

    def train_step(seed):
        net.train()
        field, y = forward_batch(seed, train_transform)
        logits = net(field)
        loss = torch.nn.functional.cross_entropy(logits, y)
        optimizer.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(net.parameters(), 1.0)
        optimizer.step()
        return loss.item(), (logits.argmax(1) == y).float().mean().item()

    def evaluate(seed0=10_000):
        """Held-out shapes, seeds apart from training; each batch is new
        geometry, so each builds its own coordinate maps."""
        net.eval()
        correct = total = 0
        with torch.no_grad():
            for i in range(args.eval_batches):
                field, y = forward_batch(seed0 + i, transform=None)
                correct += int((net(field).argmax(1) == y).sum())
                total += int(y.shape[0])
        return correct / total

    print(f"initial held-out accuracy: {evaluate():.2%} (chance = {1.0 / n_classes:.2%})")
    t0 = time.perf_counter()
    losses, running = [], []
    for step in range(args.steps):
        loss, acc = train_step(seed=step)
        losses.append(loss)
        running.append(acc)
        if (step + 1) % 5 == 0:
            print(f"step {step + 1:3d}: loss {loss:.4f} | train acc (last 5) "
                  f"{np.mean(running[-5:]):.2%}")
    dt = time.perf_counter() - t0
    final = evaluate()
    print(f"trained {args.steps} steps in {dt:.1f}s ({dt / max(args.steps, 1):.2f}s/step) | "
          f"final held-out accuracy: {final:.2%}")
    return {"losses": losses, "accuracy": final}


if __name__ == "__main__":
    main()
