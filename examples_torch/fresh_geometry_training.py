"""Fresh-geometry training: every batch is a new point cloud (JAX:
``examples/fresh_geometry_training.py``; no reference counterpart).

Each step must rebuild every coordinate map and kernel map.  The port's
recipe for that:

1. Run the model once on a representative cloud; its coordinate manager
   records the coordinate-op recipe (the oplog).
2. Replay a few warm-up clouds through ``GeometryReplayer``: this ratchets
   the capacity floors (a power-of-two bucket per map) that let the replay
   run with no host sync.
3. ``CompiledReplayer.run`` replays the whole coordinate phase of each new
   cloud, and reduces its features, as one CUDA graph per capacity bucket
   on the card (on the CPU, the same sync-free replay without a graph),
   with one host sync per batch.  It returns ``ok`` false when a floor did
   not hold; ``recover`` then replays that cloud in sync mode, ratchets the
   floors and drops the stale graphs.  The forward, loss and backward run
   eagerly on a frozen manager over the batch's ``Geometry``.

Run: python examples_torch/fresh_geometry_training.py [--cpu] [--steps 8]
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
from minkowskiengine_tpu_torch.models import MinkUNet14A  # noqa: E402


def make_cloud(seed, n_target=4000, extent=24):
    """A random cloud of up to ``n_target`` unique voxels, batch index 0."""
    rng = np.random.RandomState(seed)
    coords = np.unique(
        np.concatenate(
            [np.zeros((n_target * 2, 1), np.int32), rng.randint(0, extent, (n_target * 2, 3))],
            axis=1,
        ).astype(np.int32),
        axis=0,
    )[:n_target]
    feats = rng.randn(len(coords), 3).astype(np.float32)
    return coords, feats


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--n_points", type=int, default=4000)
    args = p.parse_args(argv)
    device = common.device_of(args)
    n_classes = 10

    def cloud(seed):
        c, f = make_cloud(seed, n_target=args.n_points)
        return torch.from_numpy(c).to(device), torch.from_numpy(f).to(device)

    # 1. record the recipe on a representative cloud
    coords0, feats0 = cloud(0)
    x0 = MT.SparseTensor(feats0, coords0)
    net = MinkUNet14A(3, n_classes, D=3, generator=torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        net(x0)
    manager = x0.coordinate_manager

    # 2. settle the floors on a few warm-up clouds
    replayer = MT.GeometryReplayer(manager)
    for s in (1, 2):
        replayer(cloud(s)[0])

    # 3. the coordinate phase of every new cloud through the compiled replay
    compiled = MT.CompiledReplayer(manager).adopt(replayer)
    optimizer = torch.optim.SGD(net.parameters(), lr=1e-2)
    rng = np.random.RandomState(0)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        c, f = cloud(100 + step)
        geo, fp, ok = compiled.run(c, f)
        if not ok:  # a floor did not hold for this cloud: replay it in sync mode once
            geo, fp = compiled.recover(c, f)
        view = MT.CoordinateManager.from_geometry(geo)
        xt = MT.SparseTensor(fp, coordinate_map_key=geo.entry_key, coordinate_manager=view)
        labels = torch.from_numpy(rng.randint(0, n_classes, xt.size)).long().to(device)
        loss = torch.nn.functional.cross_entropy(net(xt).F, labels)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        print(f"step {step}: loss {losses[-1]:.4f} ({xt.size} voxels, "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms elapsed)")
    print(f"done: every batch rebuilt its geometry through the compiled replay; graphs "
          f"captured {compiled.captures}, recoveries {compiled.recoveries}")
    return {"losses": losses, "captures": compiled.captures, "recoveries": compiled.recoveries}


if __name__ == "__main__":
    main()
