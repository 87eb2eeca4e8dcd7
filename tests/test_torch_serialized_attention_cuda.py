"""The serialized attention kernel against its plain version in float64, on the card.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.  Run
them on the card with
``python -m pytest --noconftest tests/test_torch_serialized_attention_cuda.py``.

Shapes: Point Transformer V3's (head width 16, windows of 1024 rows with a
scene's shifted last window, short windows of 1, 7 and 400 rows, 2 and 32
heads), and the other head widths the kernel takes.  Each tensor (the
output and the gradients of q, k and v) is judged by max |Δ| / max |ref|
against the plain version in float64.  Tolerance ``RTOL``, from
measurement on an H100 (80GB HBM3, 700 W): at PTv3's shapes the kernel lies
at most 3.3e-7 from float64 in the output and 7.7e-7 in the gradients, at
head widths 32 and 64 at most 3.8e-7 and 1.8e-6, while the plain version
with TF32 products lies 1.5e-4 to 1.1e-3 from it (never below 1.5e-4).
RTOL = 5e-6 sits 30x below the TF32 run; the PTv3 cases also hold every
tensor 10x below their own TF32 run.
"""

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.kernels import attention as A

pytestmark = pytest.mark.cuda
RTOL = 5e-6
PTV3 = (2500, 1024, 1, 7, 400, 3000)  # scene sizes: shifted last windows; short ones of K, 1, 7, 400


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def scenes_plan(sizes, K, dev, curve="hilbert", seed=0):
    """The window plan of scenes of ``sizes`` distinct random cells."""
    rng = np.random.default_rng(seed)
    coords = []
    for b, n in enumerate(sizes):
        side = max(4, int(np.ceil((4 * n) ** (1 / 3))))
        cells = rng.permutation(side ** 3)[:n]
        g = np.stack(np.unravel_index(cells, (side,) * 3), 1)
        coords.append(np.concatenate([np.full((n, 1), b), g], 1))
    coords = torch.from_numpy(np.concatenate(coords).astype(np.int32)).to(dev)
    mgr = MT.CoordinateManager(D=3, device=dev)
    key, _ = mgr.insert_and_map(coords, 1)
    return mgr.window_plan(key, curve, K), len(coords)


def errors(plan, n, heads, d, dev, seed=0):
    """max |Δ| / max |ref| of the kernel's output and q, k, v gradients, and
    of the plain version with TF32 products, against plain in float64."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(n, 3 * heads * d, device=dev, generator=g)
    dout = torch.randn(n, heads * d, device=dev, generator=g)
    scale = d ** -0.5
    before = (A.attention.fwd_launches, A.attention.bwd_launches)
    x = qkv.clone().requires_grad_(True)
    out = A.attention(x, plan, heads, scale)
    out.backward(dout)
    assert (A.attention.fwd_launches - before[0], A.attention.bwd_launches - before[1]) == (1, 1)
    got = (out.detach(), *x.grad.split(heads * d, 1))

    def plain(t, go):
        o, lse = A.attention_forward_reference(t, plan, heads, scale)
        dq = A.attention_backward_reference(t, o, lse, go, plan, heads, scale)
        return (o, *dq.split(heads * d, 1))

    ref = plain(qkv.double(), dout.double())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain(qkv, dout)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    return [rel(a, b) for a, b in zip(got, ref)], [rel(a, b) for a, b in zip(tf32, ref)]


@pytest.mark.parametrize("heads", [2, 32])
def test_ptv3_windows_match_float64(dev, heads):
    plan, n = scenes_plan(PTV3, 1024, dev)
    assert plan.n_full == 3 + 3 and plan.short == (1024, 1, 7, 400)
    assert int((plan.kernel_rows < 0).sum()) == 2 * 1024 * 3 - 2500 - 3000
    got, tf32 = errors(plan, n, heads, 16, dev)
    print(f"\nheads {heads}: kernel {['%.2e' % e for e in got]}, tf32 {['%.2e' % e for e in tf32]}")
    assert all(e <= RTOL for e in got), got
    assert all(10 * e <= t for e, t in zip(got, tf32)), (got, tf32)


@pytest.mark.parametrize("d,heads,K", [(32, 4, 256), (64, 2, 128), (16, 1, 64)])
def test_other_head_widths_and_windows_match_float64(dev, d, heads, K):
    plan, n = scenes_plan((3 * K + 5, K - 1, 1, K, 2 * K + 1), K, dev, curve="z")
    got, tf32 = errors(plan, n, heads, d, dev, seed=1)
    print(f"\nd {d}, heads {heads}, K {K}: kernel {['%.2e' % e for e in got]}, "
          f"tf32 {['%.2e' % e for e in tf32]}")
    assert all(e <= RTOL for e in got), got


def test_the_kernel_refuses_what_it_does_not_take(dev):
    plan, n = scenes_plan((300,), 128, dev)
    with pytest.raises(ValueError, match="head widths"):
        A.attention(torch.randn(n, 3 * 2 * 24, device=dev), plan, 2, 0.2)
    with pytest.raises(TypeError):
        A.attention(torch.randn(n, 96, device=dev, dtype=torch.float64), plan, 2, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        A.attention(torch.randn(96, n, device=dev).T, plan, 2, 0.25)
