"""A hand-rolled 2-level UNet with skip connections via ``MT.cat``
(reference: examples/unet.py; JAX: ``examples/unet.py``), trained briefly on
a synthetic 2-D segmentation task.

Run: python examples_torch/unet.py [--cpu] [--steps 5]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch import MinkowskiFunctional as MF  # noqa: E402


class UNet(MT.MinkowskiNetwork):
    """Reference examples/unet.py:33-106: conv and batch-norm blocks, two
    stride-2 levels down and up, ``MT.cat`` at the skips."""

    def __init__(self, in_nchannel, out_nchannel, D, generator=None, device=None):
        super().__init__(D)
        g = dict(dimension=D, generator=generator, device=device)
        C, CT = MT.MinkowskiConvolution, MT.MinkowskiConvolutionTranspose

        def BN(ch):
            return MT.MinkowskiBatchNorm(ch, device=device)

        self.conv1 = C(in_nchannel, 8, kernel_size=3, **g)
        self.bn1 = BN(8)
        self.conv2 = C(8, 16, kernel_size=3, stride=2, **g)
        self.bn2 = BN(16)
        self.conv3 = C(16, 32, kernel_size=3, stride=2, **g)
        self.bn3 = BN(32)
        self.conv3_tr = CT(32, 16, kernel_size=3, stride=2, **g)
        self.bn3_tr = BN(16)
        self.conv2_tr = CT(32, 16, kernel_size=3, stride=2, **g)
        self.bn2_tr = BN(16)
        self.conv1_tr = C(24, out_nchannel, kernel_size=1, **g)

    def forward(self, x):
        out_s1 = self.bn1(self.conv1(x))
        out = MF.relu(out_s1)
        out_s2 = self.bn2(self.conv2(out))
        out = MF.relu(out_s2)
        out_s4 = self.bn3(self.conv3(out))
        out = MF.relu(out_s4)
        out = MF.relu(self.bn3_tr(self.conv3_tr(out)))
        out = MT.cat(out, out_s2)
        out = MF.relu(self.bn2_tr(self.conv2_tr(out)))
        out = MT.cat(out, out_s1)
        return self.conv1_tr(out)


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)
    device = common.device_of(args)

    net = UNet(3, 5, D=2, generator=torch.Generator().manual_seed(0), device=device)
    print(net)
    coords, feats, _ = common.data_loader(nchannel=3, is_classification=False, batch_size=4,
                                          dimension=2)
    x = MT.SparseTensor(feats.to(device), coords.to(device))
    out = net(x)
    print(f"input: {x.size} sites -> output: {out.size} sites x {out.F.shape[1]} classes")

    # learnable synthetic target: the quadrant of the coordinate
    C = out.C
    y = ((C[:, 1] > 0).long() + 2 * (C[:, 2] > 0).long()).to(device)
    optimizer = torch.optim.Adam(net.parameters(), lr=1e-2)
    losses = []
    for i in range(args.steps):
        optimizer.zero_grad()
        loss = torch.nn.functional.cross_entropy(net(x).F, y)
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        print(f"step {i}: loss {losses[-1]:.4f}")
    return {"sites": x.size, "out": tuple(out.F.shape), "losses": losses}


if __name__ == "__main__":
    main()
