"""Spatially sharded convolution: one cloud split over the ranks, one process
per rank (JAX: ``examples/spatial_sharding.py``; the reference has no
counterpart, its multi-GPU utilities replicate whole samples).

Data parallelism replicates the model and splits the batch; this splits the
rows of a single large cloud, so a cloud beyond one card's memory can be
trained.  Every rank builds the same maps from one room scan (150,000
points at 5 cm, seed 0) and holds one contiguous block of its rows
(``shard_rows``, ``torch.tensor_split``'s rule).  Canonical key order makes
each block a spatial slab; ``required_halo`` measures how far past its
block's edge a block's pairs reach in the k = 3 kernel map, and
``spatial_conv_apply`` gathers that many rows of each neighbour (one
``all_gather`` of the ranks' edge bands) before running the conv on its
window.  Then the backward of sum(out²) gives each rank the input gradient
of its own block and the whole weight gradient (summed over the ranks),
and ``spatial_global_avg`` pools every rank's rows without gathering them.

The weight (27, 3, 32) comes from a seeded ``torch.Generator``.

Run: python examples_torch/spatial_sharding.py [--cpu] [--world N] [--backend nccl|gloo]
         [--n_points 150000] [--voxel_size 0.05]
     torchrun --nproc_per_node N examples_torch/spatial_sharding.py
"""

import runpy
import time
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch import parallel  # noqa: E402
from minkowskiengine_tpu_torch.parallel import comm  # noqa: E402
from minkowskiengine_tpu_torch.parallel.spatial import RowBlock, gather_rows  # noqa: E402
from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels  # noqa: E402


def weight(device):
    """The conv's (27, 3, 32) weight, from ``torch.Generator`` seed 0."""
    return torch.randn((27, 3, 32), generator=torch.Generator().manual_seed(0)).to(device)


def run_rank(rank, world, args):
    """One rank's block: forward, backward and pooling; returns its records
    and, on rank 0, the whole input gradient."""
    device = common.rank_device(args)
    mesh = parallel.make_spatial_mesh(device=device.type)
    coords, feats = room_scan_voxels(voxel_size=args.voxel_size, n_points=args.n_points, seed=0)
    x = MT.SparseTensor(torch.from_numpy(feats).to(device), torch.from_numpy(coords).to(device))
    mgr, key = x.coordinate_manager, x.coordinate_map_key
    km = mgr.kernel_map(key, mgr.stride(key, 1), kernel_size=3, stride=1)
    halo = parallel.required_halo(km, world)
    lo, hi = RowBlock(mesh, "space").bounds(x.size)
    if rank == 0:
        print(f"mesh: {world} ranks along 'space'; cloud: {x.size} voxels")
        print(f"measured halo: fwd {halo[0]} rows, bwd {halo[1]} rows (block {hi - lo})")

    # features live sharded: each rank holds its block of the rows
    f = parallel.shard_rows(x.F, mesh).requires_grad_()
    w = weight(device).requires_grad_()
    launches, collectives = common.kernel_launches(), dict(comm.counts)
    t0 = time.perf_counter()
    out, dropped = parallel.spatial_conv_apply(f, w, km, mesh=mesh)
    share = (out * out).sum()  # this rank's share of sum(out²)
    share.backward()
    loss = comm.all_reduce(share.detach().clone(), mesh.get_group("space")).item()
    ms = (time.perf_counter() - t0) * 1e3
    if int(dropped):
        raise RuntimeError(f"{int(dropped)} pairs fell outside their windows")

    # sharded global pooling: per-batch means without gathering rows
    pooled = parallel.spatial_global_avg(f.detach(), parallel.shard_rows(x.C[:, 0], mesh), 1,
                                         mesh=mesh)
    d_feats = gather_rows(f.grad, x.size, mesh)
    if rank == 0:
        print(f"loss {loss:.3f}, dropped pairs {int(dropped)} "
              "(0 = the halo covered every kernel offset)")
        print(f"d_feats: rows {lo}..{hi} of {x.size} here; dW {tuple(w.grad.shape)}, summed over "
              f"the ranks; {ms:.1f} ms")
        print("global avg:", pooled[0][:3].tolist())
    return dict(rows=x.size, block=(lo, hi), halo=halo, dropped=int(dropped), loss=loss,
                d_weight=w.grad.cpu(), d_feats=d_feats.cpu() if rank == 0 else None,
                pooled=pooled.cpu(), ms=ms,
                launches=common.since(launches, common.kernel_launches()),
                collectives=common.since(collectives, comm.counts))


def arguments(argv=None):
    """The script's arguments (``argv`` None: the command line's)."""
    p = common.world_parser(__doc__)
    p.add_argument("--n_points", type=int, default=150_000)
    p.add_argument("--voxel_size", type=float, default=0.05)
    return p.parse_args(argv)


def main(argv=None):
    args = arguments(argv)
    ranks = common.run_world(__file__, "run_rank", args)
    print(f"{len(ranks)} rank(s): halo {ranks[0]['halo']}, dropped {ranks[0]['dropped']}, "
          f"loss {ranks[0]['loss']:.3f}")
    return dict(ranks[0], world=len(ranks), ranks=ranks)


if __name__ == "__main__":
    main()
