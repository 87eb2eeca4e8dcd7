"""Generative shape reconstruction from a latent code (reference:
examples/reconstruction.py; JAX: ``examples/reconstruction.py``).

A decoder-only generative net: a latent code on one seed voxel at the
coarsest stride, grown level by level with per-level pruning, trained
against the target occupancy of a sphere shell.

Run: python examples_torch/reconstruction.py [--cpu] [--steps 5] [--res 64] [--levels 6]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.models.vae import Decoder  # noqa: E402


def make_shape(res=64, kind=0):
    """A sphere shell (kind 0) or a box shell (kind 1), batch index 0."""
    g = np.stack(np.meshgrid(*[np.arange(res)] * 3, indexing="ij"), -1)
    center = res / 2
    if kind == 0:
        r = np.linalg.norm(g - center, axis=-1)
        sel = (r > res * 0.28) & (r < res * 0.36)
    else:
        d = np.abs(g - center).max(-1)
        sel = (d > res * 0.25) & (d < res * 0.32)
    coords = np.argwhere(sel)
    return np.concatenate([np.zeros((len(coords), 1), np.int64), coords], axis=1).astype(np.int32)


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--levels", type=int, default=6, help="decoder levels + 1, at most 6")
    args = p.parse_args(argv)
    device = common.device_of(args)

    target = make_shape(args.res, kind=0)
    print(f"target shape: {len(target)} voxels")
    mgr = MT.CoordinateManager(D=3, device=device)
    target_key, _ = mgr.insert_and_map(torch.from_numpy(target).to(device), 1)

    channels = (64, 32, 32, 16, 16, 8)[: args.levels]
    decoder = Decoder(channels, resolution=args.res, generator=torch.Generator().manual_seed(0),
                      device=device)
    optimizer = torch.optim.Adam(decoder.parameters(), lr=1e-3)

    # the seed voxel at the coarsest stride carries the latent code
    stride0 = 2 ** (len(channels) - 1)
    seed_key, _ = mgr.insert_and_map(torch.zeros((1, 4), dtype=torch.int32, device=device),
                                     stride0)
    latent = torch.from_numpy(
        np.random.RandomState(0).randn(1, channels[0]).astype(np.float32)).to(device)

    def code():
        return MT.SparseTensor(latent, coordinate_map_key=seed_key, coordinate_manager=mgr)

    losses = []
    for step in range(args.steps):
        out_cls, targets, _ = decoder(code(), target_key)
        loss = sum(torch.nn.functional.binary_cross_entropy_with_logits(cls.F[:, 0], tgt.float())
                   for cls, tgt in zip(out_cls, targets)) / len(out_cls)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        print(f"step {step}: bce {losses[-1]:.4f}")

    decoder.eval()
    with torch.no_grad():
        _, _, recon = decoder(code(), target_key)
    print(f"reconstructed: {recon.size} voxels at stride {recon.tensor_stride}")
    return {"losses": losses, "reconstructed": recon.size}


if __name__ == "__main__":
    main()
