"""Generative shape completion (reference: examples/completion.py; JAX:
``examples/completion.py``).

Trains ``CompletionNet`` to grow a full synthetic shape (a sphere shell) from
a partial crop: generative transposed convolutions, a pruning classifier per
level, and supervision by the target's coordinate map.

Run: python examples_torch/completion.py [--cpu] [--steps 5] [--res 32] [--levels 7]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.models import CompletionNet  # noqa: E402


def make_shape(res=32):
    """Two copies of a sphere shell (batch items 0 and 1) and a partial crop
    of each: the half below the centre in x, and in y.  JAX's example
    completes one crop; its deepest level then holds one voxel, where a
    training batch norm here raises, as torch's and the reference's do
    (JAX's returns its bias), so this one completes two."""
    g = np.stack(np.meshgrid(*[np.arange(res)] * 3, indexing="ij"), -1)
    center = res / 2
    r = np.linalg.norm(g - center, axis=-1)
    shell = np.argwhere((r > res * 0.3) & (r < res * 0.38))
    full = np.concatenate([np.concatenate([np.full((len(shell), 1), b), shell], axis=1)
                           for b in (0, 1)]).astype(np.int32)
    partial = full[np.where(full[:, 0] == 0, full[:, 1], full[:, 2]) < center]
    return full, partial


def level_bce(out_cls, targets):
    """The mean over levels of each level's sigmoid cross-entropy."""
    loss = sum(torch.nn.functional.binary_cross_entropy_with_logits(cls.F[:, 0], tgt.float())
               for cls, tgt in zip(out_cls, targets))
    return loss / len(out_cls)


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--res", type=int, default=32)
    p.add_argument("--levels", type=int, default=7, help="encoder and decoder levels, at most 7")
    args = p.parse_args(argv)
    device = common.device_of(args)

    full, partial = make_shape(args.res)
    print(f"full shape: {len(full)} voxels, partial input: {len(partial)}")
    mgr = MT.CoordinateManager(D=3, device=device)
    sin = MT.SparseTensor(torch.ones((len(partial), 1), device=device),
                          torch.from_numpy(partial).to(device), coordinate_manager=mgr)
    target_key, _ = mgr.insert_and_map(torch.from_numpy(full).to(device), 1)

    channels = (8, 16, 16, 32, 32, 64, 64)[: args.levels]
    net = CompletionNet(resolution=args.res, enc_channels=channels, dec_channels=channels,
                        generator=torch.Generator().manual_seed(0), device=device)
    optimizer = torch.optim.Adam(net.parameters(), lr=1e-3)
    losses = []
    for step in range(args.steps):
        out_cls, targets, _ = net(sin, target_key)
        loss = level_bce(out_cls, targets)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        print(f"step {step}: bce {losses[-1]:.4f}")

    net.eval()
    with torch.no_grad():
        _, _, completed = net(sin, target_key)
    print(f"completed shape: {completed.size} voxels at stride {completed.tensor_stride}")
    return {"losses": losses, "completed": completed.size}


if __name__ == "__main__":
    main()
