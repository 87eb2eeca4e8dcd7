"""Multi-word keys on the card: the D = 7 and D = 16 maps built on the card
equal the CPU's bit for bit, and K1 and K2 on those maps equal their plain
versions.

These tests need an NVIDIA GPU and nvcc (K1 and K2 run); elsewhere they
skip.  Run them on the card with
``python -m pytest --noconftest tests/test_torch_high_dim_cuda.py``.
Maps are compared exactly; K1 within 1e-5 and K2 within 1e-4 of
max|plain| (float32 sums over up to 128 offsets, or over every paired row
of an offset, in another order), the limits ``chip_smoke.py`` holds them
to.
"""

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw, conv_dw_reference
from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm, gather_gemm_reference

pytestmark = pytest.mark.cuda

K1_RTOL, K2_RTOL = 1e-5, 1e-4
CROSS = MT.RegionType.HYPER_CROSS
# (D, kernel size, stride, region): the maps of chip_smoke.py phase 39
CASES = [(7, 2, 1, MT.RegionType.HYPER_CUBE), (7, 2, 2, MT.RegionType.HYPER_CUBE),
         (7, 3, 1, CROSS), (16, 3, 1, CROSS)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def cloud(D, n=20_000, seed=0):
    """Rows near one another in the first three dimensions and spread over
    a few values in the others, as a lifted scan is, with duplicates."""
    rng = np.random.RandomState(seed)
    c = np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(0, 24, (n, 3)),
                        rng.randint(0, 4, (n, D - 3))], 1).astype(np.int32)
    return torch.from_numpy(np.concatenate([c, c[: n // 10]]))


def maps(D, k, s, region, device):
    mgr = MT.CoordinateManager(D=D, device=device)
    key, (unique_map, inverse_map) = mgr.insert_and_map(cloud(D).to(device))
    out = mgr.stride(key, s)
    km = mgr.kernel_map(key, out, kernel_size=k, stride=s, region_type=region)
    stride_map = mgr.stride_map(key, out) if s > 1 else None
    return mgr, key, out, (unique_map, inverse_map), km, stride_map


def rel(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale > 0 else (got - want).abs().max().item()


@pytest.mark.parametrize("D,k,s,region", CASES)
def test_maps_on_the_card_equal_the_cpus(dev, D, k, s, region):
    gpu, cpu = maps(D, k, s, region, dev), maps(D, k, s, region, "cpu")
    for key in (1, 2):
        assert torch.equal(gpu[0].get_coordinates(gpu[key]).cpu(), cpu[0].get_coordinates(cpu[key]))
        assert torch.equal(gpu[0].get_coordinate_map(gpu[key]).keys.cpu(),
                           cpu[0].get_coordinate_map(cpu[key]).keys)
    for a, b in zip(gpu[3], cpu[3]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(gpu[4].in_idx.cpu(), cpu[4].in_idx)
    assert torch.equal(gpu[4].out_idx_t.cpu(), cpu[4].out_idx_t)
    assert (cpu[4].in_idx >= 0).any()
    if s > 1:
        assert torch.equal(gpu[5].cpu(), cpu[5])


@pytest.mark.parametrize("D,k,s,region", CASES)
def test_kernels_on_the_maps_equal_plain(dev, D, k, s, region):
    _, _, _, _, km, _ = maps(D, k, s, region, dev)
    gen = torch.Generator(device=dev).manual_seed(D + k + s)
    cin, cout = 32, 64
    x = torch.randn(km.n_in, cin, device=dev, generator=gen)
    w = torch.randn(km.kernel_volume, cin, cout, device=dev, generator=gen)
    g = torch.randn(km.n_out, cout, device=dev, generator=gen)
    assert rel(gather_gemm(x, w, km.in_idx), gather_gemm_reference(x, w, km.in_idx)) <= K1_RTOL
    wt = w.transpose(1, 2).contiguous()
    assert rel(gather_gemm(g, wt, km.out_idx_t), gather_gemm_reference(g, wt, km.out_idx_t)) <= K1_RTOL
    assert rel(conv_dw(x, g, km.in_idx), conv_dw_reference(x, g, km.in_idx)) <= K2_RTOL
