"""Tensor-parallel MinkUNet inference, one process per rank (JAX:
``examples/tensor_parallel.py``; the reference's multi-GPU story is data
parallelism only).

Every rank builds the same ``MinkUNet14A(3, 8)`` from one seed, in eval
mode, and runs it on a 2000-point cloud in 32³ (``RandomState(0)``) whole,
as the single-device reference.  ``apply_tensor_parallelism`` then cuts
every conv's output channels over the ``"model"`` axis of ``make_tp_mesh``
(Megatron's column parallelism): each rank's K1 computes its slice of the
columns and an ``all_gather`` rebuilds them for the next layer.  The two
outputs must agree within 1e-4 of the reference's largest value: float32
sums over the same products, the columns computed in slices.

Run: python examples_torch/tensor_parallel.py [--cpu] [--world N] [--backend nccl|gloo]
         [--tp 0]
     torchrun --nproc_per_node N examples_torch/tensor_parallel.py
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
from minkowskiengine_tpu_torch.models import MinkUNet14A  # noqa: E402
from minkowskiengine_tpu_torch.parallel import comm  # noqa: E402

RTOL = 1e-4
CLOUD = dict(seed=0, n=2000, hi=32)  # common.random_cloud's arguments: JAX's cloud


def run_rank(rank, world, args):
    """One rank's forward, whole and column-parallel; returns its records."""
    device = common.rank_device(args)
    coords, feats, _ = common.random_cloud(**CLOUD)
    x = MT.SparseTensor(torch.from_numpy(feats).to(device), torch.from_numpy(coords).to(device))
    net = MinkUNet14A(3, 8, D=3, generator=torch.Generator().manual_seed(0), device=device).eval()
    with torch.no_grad():
        ref = net(x).F  # single-device reference

    tp = args.tp or world
    mesh = parallel.make_tp_mesh(tp=tp, device=device.type)
    parallel.apply_tensor_parallelism(net, mesh)  # cut the conv GEMMs column-parallel
    mgr, key = x.coordinate_manager, x.coordinate_map_key
    launches, collectives = common.kernel_launches(), dict(comm.counts)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = net(MT.SparseTensor(x.F, coordinate_map_key=key, coordinate_manager=mgr)).F
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    ms = (time.perf_counter() - t0) * 1e3
    cut = sum(hasattr(m, "column_parallel") for m in net.modules())
    if rank == 0:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {world} ranks; "
              f"{cut} layers cut by output channels")
        print(f"tensor-parallel forward: {tuple(out.shape)} in {ms:.1f} ms")
        print(f"max |tp - single| = {err:.2e} ({err / scale:.2e} of max |single|)")
    if not err <= RTOL * scale:
        raise AssertionError(f"tensor-parallel forward diverged: {err:.3e} of {scale:.3e}")
    if rank == 0:
        print("OK")
    return dict(rows=x.size, err=err, scale=scale, cut=cut, ms=ms,
                launches=common.since(launches, common.kernel_launches()),
                collectives=common.since(collectives, comm.counts))


def arguments(argv=None):
    """The script's arguments (``argv`` None: the command line's)."""
    p = common.world_parser(__doc__)
    p.add_argument("--tp", type=int, default=0, help="model-axis size (0 = every rank)")
    return p.parse_args(argv)


def main(argv=None):
    args = arguments(argv)
    ranks = common.run_world(__file__, "run_rank", args)
    print(f"{len(ranks)} rank(s): max |tp - single| {max(r['err'] for r in ranks):.2e}")
    return dict(ranks[0], world=len(ranks), ranks=ranks)


if __name__ == "__main__":
    main()
