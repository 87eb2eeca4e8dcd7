"""Data-parallel training on one shared cloud, one process per rank
(reference: examples/multigpu.py; JAX: ``examples/multigpu.py``).

Every rank builds the same ``MinkUNet14A(3, 10)`` from one seed, warms the
coordinate and kernel maps of the shared cloud (600 random voxels in 32³
over two batch indices, ``RandomState(0)``), swaps its batch norms for
``MinkowskiSyncBatchNorm`` (statistics all-reduced over the ranks) and
trains for five iterations.  Each iteration every rank draws the same
(world, N, 3) features and (world, N) labels and keeps its own slice
(``shard_batch``); ``make_data_parallel_step`` averages the gradients over
the ranks with one all-reduce, so the ranks' parameters stay equal, bit
for bit.  The loss is the cross-entropy over the cloud's N rows: the port
keeps exact row counts where JAX pads to a capacity and masks.

``--weights`` starts from a state dict with the reference's names (an
``.npz``, as ``export_reference_state_dict`` gives) instead of the seeded
weights, and ``--save`` writes rank 0's trained weights in that form.

Run: python examples_torch/multigpu.py [--cpu] [--world N] [--backend nccl|gloo]
         [--steps 5] [--weights in.npz] [--save out.npz]
     torchrun --nproc_per_node N examples_torch/multigpu.py
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
from minkowskiengine_tpu_torch.utils import (  # noqa: E402
    export_reference_state_dict,
    load_state_dict_from_reference,
)

N_CLASSES = 10
CLOUD = dict(seed=0, n=600, hi=32)  # common.random_cloud's arguments: JAX's shared cloud


def run_rank(rank, world, args):
    """One rank's training; returns its per-step records."""
    device = common.rank_device(args)
    mesh = parallel.make_mesh(device=device.type)
    coords, feats, rng = common.random_cloud(**CLOUD)
    x = MT.SparseTensor(torch.from_numpy(feats).to(device), torch.from_numpy(coords).to(device))
    net = MinkUNet14A(3, N_CLASSES, D=3, generator=torch.Generator().manual_seed(0), device=device)
    if args.weights:
        load_state_dict_from_reference(net, dict(np.load(args.weights)))
    with torch.no_grad():
        net(x)  # warm the coordinate/kernel-map caches
    net = MT.MinkowskiSyncBatchNorm.convert_sync_batchnorm(net)
    optimizer = torch.optim.SGD(net.parameters(), lr=1e-2)
    manager, key, n = x.coordinate_manager, x.coordinate_map_key, x.size

    def loss_fn(model, feats_shard, labels_shard):
        xt = MT.SparseTensor(feats_shard[0], coordinate_map_key=key, coordinate_manager=manager)
        return torch.nn.functional.cross_entropy(model(xt).F, labels_shard[0])

    step = parallel.make_data_parallel_step(net, optimizer, loss_fn, mesh)
    out = dict(rows=n, device=str(device), losses=[], ms=[], launches=[], collectives=[],
               bn_all_reduces=[], digests=[])
    for it in range(args.steps):
        f = parallel.shard_batch(rng.randn(world, n, 3).astype(np.float32), mesh)
        labels = parallel.shard_batch(rng.randint(0, N_CLASSES, (world, n)).astype(np.int64), mesh)
        launches, collectives = common.kernel_launches(), dict(comm.counts)
        bn = MT.MinkowskiSyncBatchNorm.all_reduces
        t0 = time.perf_counter()
        loss = step(net, optimizer, f, labels).item()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss)
        out["launches"].append(common.since(launches, common.kernel_launches()))
        out["collectives"].append(common.since(collectives, comm.counts))
        out["bn_all_reduces"].append(MT.MinkowskiSyncBatchNorm.all_reduces - bn)
        out["digests"].append(common.digest(net))
        if rank == 0:
            print(f"iter {it}: loss {loss:.4f} (mean over {world} ranks), "
                  f"{out['ms'][-1]:.1f} ms, {out['launches'][-1]}")
    if rank == 0 and args.save:
        np.savez(args.save, **export_reference_state_dict(net))
    return out


def arguments(argv=None):
    """The script's arguments (``argv`` None: the command line's)."""
    p = common.world_parser(__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--weights", default=None, help="start from this reference-named state dict (.npz)")
    p.add_argument("--save", default=None, help="write rank 0's trained weights here (.npz)")
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
