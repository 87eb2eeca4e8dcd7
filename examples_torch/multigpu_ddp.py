"""Data-parallel training in which every rank trains on its own point cloud,
one process per rank (reference: examples/multigpu_ddp.py, one process per
GPU, a DistributedSampler, gradients all-reduced over NCCL; JAX:
``examples/multigpu_ddp.py``).

``MinkUNet14A(3, 4)`` runs once on a representative cloud, so its
coordinate manager records the coordinate-op recipe; its batch norms become
``MinkowskiSyncBatchNorm``; a ``GeometryReplayer`` settles its capacity
floors on one warm-up cloud per rank.  Each step every rank replays the
step's fresh clouds (``common.random_cloud(1 + step · world + r, 2000,
48)`` for rank r, 2000 random points in 48³ over two batch indices), exports each one's
``Geometry`` and reduces its features onto it, stacks them
(``stack_geometries``, features and labels padded to the step's largest
cloud) and keeps its own (``shard_batch``), as the host of a JAX mesh
builds every device's geometry;
``make_per_device_geometry_step`` rebuilds the input through
``CoordinateManager.from_geometry``, and averages the gradients over the
ranks with one all-reduce.

Run: python examples_torch/multigpu_ddp.py [--cpu] [--world N] [--backend nccl|gloo]
         [--steps 4]
     torchrun --nproc_per_node N examples_torch/multigpu_ddp.py
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
from minkowskiengine_tpu_torch import parallel  # noqa: E402
from minkowskiengine_tpu_torch.models import MinkUNet14A  # noqa: E402
from minkowskiengine_tpu_torch.parallel import comm  # noqa: E402

N_CLASSES = 4
POINTS, HI = 2000, 48  # common.random_cloud's n and hi: JAX's make_cloud


def run_rank(rank, world, args):
    """One rank's training; returns its per-step records."""
    device = common.rank_device(args)

    def cloud(seed):
        c, f, _ = common.random_cloud(seed, POINTS, HI)
        return torch.from_numpy(c).to(device), f

    # the model and the coordinate-op recipe (one warm pass)
    c0, f0 = cloud(0)
    x0 = MT.SparseTensor(torch.from_numpy(f0).to(device), c0)
    net = MinkUNet14A(3, N_CLASSES, D=3, generator=torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        net(x0)
    net = MT.MinkowskiSyncBatchNorm.convert_sync_batchnorm(net)
    replayer = MT.GeometryReplayer(x0.coordinate_manager)
    mesh = parallel.make_mesh(device=device.type)
    optimizer = torch.optim.SGD(net.parameters(), lr=1e-2)

    def loss_fn(model, geo, feats, labels):
        view = MT.CoordinateManager.from_geometry(geo)
        n = view.size(geo.entry_key)
        xt = MT.SparseTensor(feats[0][:n], coordinate_map_key=geo.entry_key,
                             coordinate_manager=view)
        return torch.nn.functional.cross_entropy(model(xt).F, labels[0][:n])

    step = parallel.make_per_device_geometry_step(net, optimizer, loss_fn, mesh)

    for r in range(world):  # settle the capacity floors
        replayer(cloud(1000 + r)[0])

    # every rank a different fresh cloud per step
    rng = np.random.RandomState(1)
    out = dict(device=str(device), rows=[], losses=[], ms=[], launches=[], collectives=[],
               bn_all_reduces=[], digests=[])
    for it in range(args.steps):
        launches, collectives = common.kernel_launches(), dict(comm.counts)
        bn = MT.MinkowskiSyncBatchNorm.all_reduces
        t0 = time.perf_counter()
        geos, feats = [], []
        for r in range(world):  # the DistributedSampler analogue
            c, f = cloud(1 + it * world + r)
            mgr = replayer(c)
            geo = mgr.export_geometry()
            geos.append(geo)
            feats.append(mgr.reduce_features(geo.entry_key, torch.from_numpy(f).to(device)))
        cap = max(len(f) for f in feats)
        labels = rng.randint(0, N_CLASSES, (world, cap)).astype(np.int64)
        geo = parallel.shard_batch(MT.stack_geometries(geos), mesh)
        feats_sh = parallel.shard_batch(
            torch.stack([torch.cat([f, f.new_zeros(cap - len(f), 3)]) for f in feats]), mesh)
        loss = step(net, optimizer, geo, feats_sh, parallel.shard_batch(labels, mesh)).item()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["rows"].append(len(feats[rank]))
        out["losses"].append(loss)
        out["launches"].append(common.since(launches, common.kernel_launches()))
        out["collectives"].append(common.since(collectives, comm.counts))
        out["bn_all_reduces"].append(MT.MinkowskiSyncBatchNorm.all_reduces - bn)
        out["digests"].append(common.digest(net))
        if rank == 0:
            print(f"iter {it}: {world} ranks x fresh geometry ({out['rows'][-1]} voxels here), "
                  f"loss {loss:.4f} ({out['ms'][-1]:.1f} ms)")
    return out


def arguments(argv=None):
    """The script's arguments (``argv`` None: the command line's)."""
    p = common.world_parser(__doc__)
    p.add_argument("--steps", type=int, default=4)
    return p.parse_args(argv)


def main(argv=None):
    args = arguments(argv)
    ranks = common.run_world(__file__, "run_rank", args)
    same = all(r["digests"] == ranks[0]["digests"] for r in ranks)
    print(f"{len(ranks)} rank(s): final loss {ranks[0]['losses'][-1]:.4f}; "
          f"parameters bit-equal on every rank after every step: {same}")
    return dict(ranks[0], world=len(ranks), ranks=ranks, same_parameters=same)


if __name__ == "__main__":
    main()
