"""A training loop over one geometry, streaming feature batches, with
checkpoints (reference: examples/training.py; JAX: ``examples/training.py``,
which jits the step and checkpoints with orbax).

The coordinate phase runs once: the manager keeps every coordinate and
kernel map of the first forward, so each later step on the same map key
reuses them and runs only the feature phase.  The model is saved with the
package's ``utils/checkpoint.py`` (``torch.save`` of the state dict) and
restored into a second model, whose logits must equal the first's.

Run: python examples_torch/training.py [--cpu] [--steps 8] [--ckpt training_checkpoint.pt]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402


class SegNet(MT.MinkowskiNetwork):
    def __init__(self, generator=None, device=None):
        super().__init__(3)
        g = dict(dimension=3, generator=generator, device=device)
        self.conv1 = MT.MinkowskiConvolution(3, 32, kernel_size=3, **g)
        self.bn1 = MT.MinkowskiBatchNorm(32, device=device)
        self.conv2 = MT.MinkowskiConvolution(32, 64, kernel_size=3, stride=2, **g)
        self.bn2 = MT.MinkowskiBatchNorm(64, device=device)
        self.up = MT.MinkowskiConvolutionTranspose(64, 32, kernel_size=2, stride=2, **g)
        self.head = MT.MinkowskiConvolution(32, 20, kernel_size=1, bias=True, **g)
        self.relu = MT.MinkowskiReLU()

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.up(y)
        return self.head(y)


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--n_points", type=int, default=4000)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--ckpt", type=str, default="training_checkpoint.pt")
    args = p.parse_args(argv)
    device = common.device_of(args)

    coords, feats, labels = common.random_scene(n_points=args.n_points, batch_size=2)
    x = MT.SparseTensor(torch.from_numpy(feats).to(device), torch.from_numpy(coords).to(device))
    net = SegNet(generator=torch.Generator().manual_seed(0), device=device)
    mgr, key = x.coordinate_manager, x.coordinate_map_key
    y = torch.from_numpy(labels[: x.size]).long().to(device)
    optimizer = torch.optim.Adam(net.parameters(), lr=1e-3)

    rng = np.random.RandomState(0)
    losses = []
    for step in range(args.steps):
        # stream new features over the same geometry (an augmentation)
        xt = MT.SparseTensor(x.F * (1.0 + 0.05 * rng.randn()), coordinate_map_key=key,
                             coordinate_manager=mgr)
        loss = torch.nn.functional.cross_entropy(net(xt).F, y)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        print(f"step {step}: loss {losses[-1]:.4f}")

    path = save_checkpoint(args.ckpt, net)
    print(f"checkpointed to {path}")
    net2 = SegNet(generator=torch.Generator().manual_seed(99), device=device)
    load_checkpoint(path, net2)
    net.eval()
    net2.eval()
    with torch.no_grad():
        equal = torch.equal(net2(x).F, net(x).F)
    print("restored, logits equal:", equal)
    return {"losses": losses, "checkpoint": path, "restored_equal": equal}


if __name__ == "__main__":
    main()
