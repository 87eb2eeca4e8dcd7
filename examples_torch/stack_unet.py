"""Parallel-branch (stacked) UNet (reference: examples/stack_unet.py; JAX:
``examples/stack_unet.py``): ``MinkowskiStackCat`` runs its branches on the
same input and concatenates their features.

Run: python examples_torch/stack_unet.py [--cpu]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402


class Branch(MT.MinkowskiNetwork):
    """Conv down, then transposed conv up: lands back on the input's coordinates."""

    def __init__(self, ch, D, generator=None, device=None):
        super().__init__(D)
        g = dict(dimension=D, generator=generator, device=device)
        self.down = MT.MinkowskiConvolution(ch[1], ch[2], kernel_size=2, stride=2, **g)
        self.up = MT.MinkowskiConvolutionTranspose(ch[2], ch[1], kernel_size=2, stride=2, **g)

    def forward(self, x):
        return self.up(self.down(x))


class Identity(MT.MinkowskiNetwork):
    def forward(self, x):
        return x


class StackUNet(MT.MinkowskiNetwork):
    def __init__(self, in_nchannel, out_nchannel, D, generator=None, device=None):
        super().__init__(D)
        ch = [in_nchannel, 16, 32]
        g = dict(dimension=D, generator=generator, device=device)
        self.inc = MT.MinkowskiConvolution(ch[0], ch[1], kernel_size=3, **g)
        self.stack = MT.MinkowskiStackCat(Identity(D), Branch(ch, D, generator, device))
        self.out = MT.MinkowskiConvolution(2 * ch[1], out_nchannel, kernel_size=1, bias=True, **g)

    def forward(self, x):
        return self.out(self.stack(self.inc(x)))


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    device = common.device_of(args)
    coords, feats, _ = common.data_loader(nchannel=3, batch_size=2)
    x = MT.SparseTensor(feats.to(device), coords.to(device))
    net = StackUNet(3, 5, D=2, generator=torch.Generator().manual_seed(0), device=device)
    y = net(x)
    print(f"stacked UNet: {x.shape} -> {y.shape} at stride {y.tensor_stride}")
    assert y.shape[1] == 5
    return {"in": x.shape, "out": y.shape, "tensor_stride": y.tensor_stride}


if __name__ == "__main__":
    main()
