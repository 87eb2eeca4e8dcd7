"""The dense bbox grid on the card: maps built through the row grids equal
the CPU's, and the dense-grid conv route (cuDNN) agrees with the plain
sparse conv.

These tests need an NVIDIA GPU; elsewhere they skip.  Run them on the card
with ``python -m pytest --noconftest tests/test_torch_grid_cuda.py``.
Maps are compared index for index (interpolation weights within 1e-6).
The route is held to K1's tolerance
(1e-5 of max|ref|) forward and on the input gradient and to K2's (1e-4) on
the weight gradient, with the caller's TF32 flags on: the route runs its
float32 convs without TF32 whatever they say.  bf16 within two bf16 ulps of
the float32 route.
"""

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw_reference
from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm_reference
from minkowskiengine_tpu_torch.nn import conv as tconv
from minkowskiengine_tpu_torch.ops import dense_conv as D

pytestmark = pytest.mark.cuda

KERNEL_RTOL, DW_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def cloud(seed, n=6000, hi=48):
    rng = np.random.RandomState(seed)
    c = np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(-hi, hi, (n, 3))], 1)
    return torch.from_numpy(np.unique(c.astype(np.int32), axis=0))


def rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def maps(c, device):
    mgr = MT.CoordinateManager(D=3, device=device)
    k1, _ = mgr.insert_and_map(c)
    k2 = mgr.stride(k1, 2)
    out = [mgr.kernel_map(k1, k1, kernel_size=5), mgr.kernel_map(k1, k2, stride=2, kernel_size=2),
           mgr.kernel_map(k2, k2, kernel_size=3),
           mgr.kernel_map(k2, k1, stride=2, kernel_size=2, is_transpose=True)]
    idx = [t for km in out for t in (km.in_idx, km.out_idx_t)]
    idx.append(mgr.stride_map(k1, k2))
    samples = c.float()[:500] + 0.37
    idx += list(mgr.interpolation_map_weight(k2, samples))
    return mgr, idx


def test_probe_maps_on_the_card_equal_the_cpu(dev):
    c = cloud(0)
    mgr, got = maps(c.to(dev), dev)
    assert mgr._row_grids
    _, want = maps(c, "cpu")
    for g, w in zip(got[:-1], want[:-1]):
        assert torch.equal(g.cpu(), w)
    # the interpolation weights: products of float32 fractions, which the
    # card may contract into FMAs; within 1e-6, chip_smoke.py's SPLAT_RTOL
    torch.testing.assert_close(got[-1].cpu(), want[-1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("ks,cin,cout", [(5, 3, 32), (3, 32, 32), (3, 64, 96)])
def test_the_route_on_the_card_matches_the_plain_sparse_conv(dev, ks, cin, cout):
    torch.backends.cudnn.allow_tf32 = True  # the caller's flag: the route ignores it
    c = cloud(1).to(dev)
    mgr = MT.CoordinateManager(D=3, device=dev)
    key, _ = mgr.insert_and_map(c)
    km = mgr.kernel_map(key, key, kernel_size=ks)
    g = torch.Generator().manual_seed(ks + cin)
    n, K = mgr.size(key), ks**3
    x = torch.randn(n, cin, generator=g).to(dev).requires_grad_()
    w = (torch.randn(K, cin, cout, generator=g) * 0.1).to(dev).requires_grad_()
    go = torch.randn(n, cout, generator=g).to(dev)
    outs = []
    for _ in range(2):
        out = D.dense_conv(x, w, mgr.dense_plan(key), (ks,) * 3, (1,) * 3)
        outs.append((out.detach(), *torch.autograd.grad(out, (x, w), go)))
    for a, b in zip(*outs):  # deterministic algorithms: bit-equal runs
        assert torch.equal(a, b)
    out, dx, dw = outs[0]
    xd, wd = x.detach(), w.detach()
    assert rel(out, gather_gemm_reference(xd, wd, km.in_idx)) <= KERNEL_RTOL
    assert rel(dx, gather_gemm_reference(go, wd.transpose(1, 2).contiguous(), km.out_idx_t)) <= KERNEL_RTOL
    assert rel(dw, conv_dw_reference(xd, go, km.in_idx)) <= DW_RTOL
    w16 = wd.to(torch.bfloat16)
    out16 = D.dense_conv(xd.to(torch.bfloat16), w16, mgr.dense_plan(key), (ks,) * 3, (1,) * 3)
    assert out16.dtype == torch.bfloat16 and rel(out16, out) <= 2 * 2.0**-7


def test_a_module_takes_the_route_when_the_gate_says_so(dev, monkeypatch):
    c = cloud(2).to(dev)
    x = MT.SparseTensor(torch.randn(len(c), 3, device=dev), c)
    conv = MT.MinkowskiConvolution(3, 32, kernel_size=5, dimension=3, device=dev,
                                   generator=torch.Generator().manual_seed(0))
    calls = []
    route = D.dense_conv
    monkeypatch.setattr(tconv, "dense_conv", lambda *a: calls.append(1) or route(*a))
    monkeypatch.setattr(tconv, "dense_conv_beneficial", lambda *a, **k: True)
    dense = conv(x).F
    monkeypatch.setattr(tconv, "dense_conv_beneficial", lambda *a, **k: False)
    sparse = conv(x).F
    assert calls == [1]
    assert rel(dense, sparse) <= KERNEL_RTOL
