"""Convolution fundamentals: strided conv, transposed conv (generative), and
convolution on user-specified output coordinates (reference:
examples/convolution.py; JAX: ``examples/convolution.py``).

Run: python examples_torch/convolution.py [--cpu]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402


def get_random_coords(dimension=2, tensor_stride=2, seed=0):
    """Random coordinates with the given tensor stride
    (reference: examples/convolution.py:get_random_coords)."""
    rng = np.random.RandomState(seed)
    coords = np.floor(
        np.concatenate([rng.rand(10, 1) * 2, rng.rand(10, dimension) * 5], axis=1)
    ).astype(np.int32)
    coords = MT.utils.sparse_quantize(coords).copy()
    coords[:, 1:] *= tensor_stride
    return torch.from_numpy(coords), tensor_stride


def print_sparse_tensor(tensor):
    for c, f in zip(tensor.C.tolist(), tensor.F.detach().cpu().numpy()):
        print(f"  Coordinate {c} : Feature {np.round(f, 3)}")


def features(n, channels, seed, device):
    return torch.from_numpy(np.random.RandomState(seed).rand(n, channels).astype(np.float32)).to(device)


def conv(device):
    in_channels, out_channels, D = 2, 3, 2
    coords, feats, _ = common.data_loader(in_channels, batch_size=1)

    # strided convolution: output coordinates are the stride-2 grid
    x = MT.SparseTensor(features=feats.to(device), coordinates=coords.to(device))
    conv = MT.MinkowskiConvolution(
        in_channels, out_channels, kernel_size=3, stride=2, bias=False, dimension=D,
        generator=torch.Generator().manual_seed(0), device=device,
    )
    y = conv(x)
    print("Input:")
    print_sparse_tensor(x)
    print("Output (stride-2 conv):")
    print_sparse_tensor(y)

    # transposed convolution GENERATES upsampled coordinates
    strided_coords, tensor_stride = get_random_coords()
    x2 = MT.SparseTensor(
        features=features(len(strided_coords), in_channels, 1, device),
        coordinates=strided_coords.to(device), tensor_stride=tensor_stride,
    )
    conv_tr = MT.MinkowskiConvolutionTranspose(
        in_channels, out_channels, kernel_size=3, stride=2, bias=False, dimension=D,
        generator=torch.Generator().manual_seed(0), device=device,
    )
    y2 = conv_tr(x2)
    print("\nInput (tensor stride 2):")
    print_sparse_tensor(x2)
    print("Convolution transpose output (tensor stride 1, generated coords):")
    print(f"  {y2.size} output sites from {x2.size} inputs")
    print_sparse_tensor(y2)
    return y, y2


def conv_on_coords(device):
    """Convolution evaluated AT caller-chosen output coordinates: the
    reference's conv(input, coords) overload."""
    in_channels, out_channels, D = 2, 3, 2
    coords4, ts4 = get_random_coords(tensor_stride=4, seed=2)
    coords2, _ = get_random_coords(tensor_stride=2, seed=3)
    x = MT.SparseTensor(features=features(len(coords4), in_channels, 2, device),
                        coordinates=coords4.to(device), tensor_stride=ts4)
    cm = x.coordinate_manager
    conv_tr = MT.MinkowskiConvolutionTranspose(
        in_channels, out_channels, kernel_size=3, stride=2, bias=False, dimension=D,
        generator=torch.Generator().manual_seed(0), device=device,
    )

    # 1) default: generate the stride-2 coordinates
    out1 = conv_tr(x)
    print(f"\nconv_tr(x): generated {out1.size} coords at stride {out1.tensor_stride}")

    # 2) evaluate at explicit raw coordinates
    out2 = conv_tr(x, coords2.to(device))
    print(f"conv_tr(x, coords): {out2.size} outputs at caller coords")

    # 3) evaluate at a pre-inserted coordinate map key
    key, _ = cm.insert_and_map(coords2.to(device), tensor_stride=2)
    out3 = conv_tr(x, key)
    print(f"conv_tr(x, key): {out3.size} outputs at key {key}")
    torch.testing.assert_close(out2.F, out3.F, rtol=1e-5, atol=1e-6)
    print("coords overload == key overload")
    return out1, out2, out3


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    device = common.device_of(args)
    y, y2 = conv(device)
    out1, out2, out3 = conv_on_coords(device)
    return {"strided": y.shape, "transposed": y2.shape, "generated": out1.shape,
            "at_coords": out2.shape, "at_key": out3.shape}


if __name__ == "__main__":
    main()
