"""Sparse generative VAE (reference: examples/vae.py; JAX: ``examples/vae.py``):
an encoder to a global latent, noise from a seeded ``torch.Generator``, and
a generative decoder pruned level by level, trained on BCE + 0.1 KL.

Run: python examples_torch/vae.py [--cpu] [--steps 5] [--res 64] [--levels 6]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.models import VAE  # noqa: E402


def make_shapes(res=64):
    """Two random halves of a sphere shell (batch items 0 and 1, seeds 0 and
    1).  JAX's example encodes one; its deepest level then holds one voxel,
    where a training batch norm here raises, as torch's and the reference's
    do (JAX's returns its bias), so this one encodes two."""
    g = np.stack(np.meshgrid(*[np.arange(res)] * 3, indexing="ij"), -1)
    center = res / 2
    r = np.linalg.norm(g - center, axis=-1)
    shell = np.argwhere((r > res * 0.28) & (r < res * 0.36))
    items = []
    for b in (0, 1):
        keep = np.random.RandomState(b).rand(len(shell)) < 0.5
        items.append(np.concatenate([np.full((keep.sum(), 1), b), shell[keep]], axis=1))
    return np.concatenate(items).astype(np.int32)


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--levels", type=int, default=6, help="encoder and decoder levels, at most 6")
    args = p.parse_args(argv)
    device = common.device_of(args)

    coords = make_shapes(args.res)
    print(f"input shapes: {len(coords)} voxels")
    mgr = MT.CoordinateManager(D=3, device=device)
    c = torch.from_numpy(coords).to(device)
    sin = MT.SparseTensor(torch.ones((len(coords), 1), device=device), c, coordinate_manager=mgr)
    target_key, _ = mgr.insert_and_map(c, 1)

    net = VAE(channels=(8, 16, 16, 32, 32, 64)[: args.levels], in_nchannel=1,
              resolution=args.res, generator=torch.Generator().manual_seed(0), device=device)
    optimizer = torch.optim.Adam(net.parameters(), lr=1e-3)
    noise = torch.Generator(device=device).manual_seed(0)
    losses = []
    for step in range(args.steps):
        out_cls, targets, _, mean, log_var = net(sin, target_key, noise)
        bce = sum(torch.nn.functional.binary_cross_entropy_with_logits(cls.F[:, 0], tgt.float())
                  for cls, tgt in zip(out_cls, targets)) / len(out_cls)
        kl = -0.5 * torch.mean(1 + log_var.F - mean.F ** 2 - torch.exp(log_var.F))
        loss = bce + 0.1 * kl
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        print(f"step {step}: loss {losses[-1]:.4f}")
    return {"losses": losses}


if __name__ == "__main__":
    main()
