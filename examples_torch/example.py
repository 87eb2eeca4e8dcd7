"""Basic training example (reference: examples/example.py; JAX:
``examples/example.py``).

A two-layer sparse ConvNet trained on random 2D data, the minimum end-to-end
slice: SparseTensor construction, convolution, batch norm, ReLU, global
pooling, a linear head, cross-entropy and ``torch.optim.SGD``.

Run: python examples_torch/example.py [--cpu] [--steps 10]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402


class ExampleNetwork(MT.MinkowskiNetwork):
    def __init__(self, in_feat, out_feat, D, generator=None, device=None):
        super().__init__(D)
        g = dict(generator=generator, device=device)
        self.conv1 = MT.MinkowskiConvolution(
            in_feat, 64, kernel_size=3, stride=2, dilation=1, bias=False, dimension=D, **g
        )
        self.bn1 = MT.MinkowskiBatchNorm(64, device=device)
        self.relu1 = MT.MinkowskiReLU()
        self.conv2 = MT.MinkowskiConvolution(64, 128, kernel_size=3, stride=2, dimension=D, **g)
        self.bn2 = MT.MinkowskiBatchNorm(128, device=device)
        self.relu2 = MT.MinkowskiReLU()
        self.pooling = MT.MinkowskiGlobalPooling()
        self.linear = MT.MinkowskiLinear(128, out_feat, **g)

    def forward(self, x):
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.relu2(self.bn2(self.conv2(out)))
        out = self.pooling(out)
        return self.linear(out)


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)
    device = common.device_of(args)

    coords, feats, label = common.data_loader(nchannel=3, max_label=5, batch_size=4)
    net = ExampleNetwork(3, 5, D=2, generator=torch.Generator().manual_seed(0), device=device)
    optimizer = torch.optim.SGD(net.parameters(), lr=1e-1)
    x = MT.SparseTensor(feats.to(device), coords.to(device))
    y = torch.as_tensor(label, dtype=torch.long, device=device)

    losses = []
    for step in range(args.steps):
        optimizer.zero_grad()
        loss = torch.nn.functional.cross_entropy(net(x).F, y)
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        print(f"step {step}: loss {losses[-1]:.4f}")
    return {"losses": losses}


if __name__ == "__main__":
    main()
