"""The CUDA weight-gradient kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.  Run
them on the card with
``python -m pytest --noconftest tests/test_torch_conv_dw_cuda.py``.
Tolerance: max |Δ| / max |ref| <= 1e-4 for dW, the bound chip_smoke.py
derives from the summation length (up to ~52k rows per entry); 1e-5 for
the input gradient, K1's bound.  Autograd through ``sparse_conv`` on the
card is held against the CPU plain path at 1e-4.
"""

import pytest
import torch

from minkowskiengine_tpu_torch.coords.kernel_map import _invert_matching
from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw, conv_dw_reference, plan
from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm
from minkowskiengine_tpu_torch.ops.functional import sparse_conv
from test_torch_kernel_plans import STEP_CONVS

pytestmark = pytest.mark.cuda
STEP_IDS = [f"k{k}-{ci}to{co}-{a}to{b}" for k, ci, co, a, b in STEP_CONVS]

DW_RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _inputs(dev, K, n_in, n_out, cin, cout, density=0.7, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n_in, cin, device=dev, generator=g)
    go = torch.randn(n_out, cout, device=dev, generator=g)
    idx = torch.randint(0, max(n_in, 1), (K, n_out), device=dev, generator=g, dtype=torch.int32)
    idx[torch.rand(K, n_out, device=dev, generator=g) > density] = -1
    return x, go, idx


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize(
    "K,n_in,n_out,cin,cout",
    [
        (125, 3000, 3000, 3, 32),      # stem: the narrow Cin instance
        (27, 700, 650, 256, 256),      # widest block conv
        (27, 20000, 20000, 96, 96),    # many rows: split over blocks, ragged Cout tile
        (8, 300, 1200, 128, 96),       # transposed conv: more outputs than inputs
        (27, 63, 63, 384, 256),
        (1, 5, 3, 5, 70),
        (4, 10, 0, 8, 8),              # no output rows: dW = 0
    ],
)
def test_kernel_matches_plain(dev, K, n_in, n_out, cin, cout):
    x, go, idx = _inputs(dev, K, n_in, n_out, cin, cout)
    before = conv_dw.launches
    got = conv_dw(x, go, idx)
    want = conv_dw_reference(x, go, idx)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (K, cin, cout)
    assert conv_dw.launches == before + 1
    if n_out:
        assert _rel(got, want) <= DW_RTOL
    else:
        assert torch.all(got == 0)


# MinkowskiFCNN's seven convs and ResNet18's k = 1, stride-2 downsamples on
# a batch of 32 shapes x 2048 points at 2.5 cm, as in
# test_torch_gather_gemm_cuda.py: (K, Cin, Cout, rows in, rows out).
# Cout 48 takes a 64-wide tile; Cout 1024 eight 128-wide tiles.
CLASSIFICATION_CONVS = [
    (27, 32, 48, 47834, 47834), (27, 48, 64, 27633, 9538), (27, 64, 96, 3012, 1142),
    (27, 96, 128, 262, 246), (27, 336, 256, 47834, 27633), (27, 256, 512, 27633, 9538),
    (27, 512, 1024, 9538, 3012),
    (1, 64, 64, 9538, 3012), (1, 64, 128, 3012, 1142), (1, 128, 256, 1142, 262),
    (1, 256, 512, 262, 246),
]
CLASSIFICATION_IDS = [f"k{k}-{ci}to{co}-{a}to{b}" for k, ci, co, a, b in CLASSIFICATION_CONVS]


@pytest.mark.parametrize(
    "K,cin,cout,n_in,n_out", CLASSIFICATION_CONVS,
    ids=[f"k{k}-{ci}to{co}-{a}to{b}" for k, ci, co, a, b in CLASSIFICATION_CONVS],
)
def test_classification_shapes(dev, K, cin, cout, n_in, n_out):
    in_idx, _ = _matching(dev, K, n_in, n_out)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n_in, cin, device=dev, generator=g)
    go = torch.randn(n_out, cout, device=dev, generator=g)
    _check(x, go, in_idx)
    assert conv_dw.last_plan.body == "mma" and conv_dw.last_plan.vec == 4


def test_pairless_and_out_of_range_rows_add_nothing(dev):
    x, go, idx = _inputs(dev, 8, 100, 200, 16, 16)
    idx[:, :64] = -1           # a whole chunk with no pair: skipped
    idx[:, 64] = 100           # outside [0, n_in): gathers zero
    got = conv_dw(x, go, idx)
    want = conv_dw_reference(x, go[65:].contiguous(), idx[:, 65:].contiguous())
    assert _rel(got, want) <= DW_RTOL
    empty = torch.full((3, 130), -1, dtype=torch.int32, device=dev)
    assert torch.all(conv_dw(x, go[:130].contiguous(), empty) == 0)


def _check(x, go, idx):
    got = conv_dw(x, go, idx)
    want = conv_dw_reference(x, go, idx)
    torch.cuda.synchronize()
    if want.abs().max() == 0:
        assert torch.all(got == 0)
    else:
        assert _rel(got, want) <= DW_RTOL
    return got


@pytest.mark.parametrize("cin", [3, 5, 96, 384])
@pytest.mark.parametrize("cout", [8, 70, 96, 130])
def test_channel_widths(dev, cin, cout):
    x, go, idx = _inputs(dev, 8, 1500, 1700, cin, cout)
    _check(x, go, idx)
    assert conv_dw.last_plan.body == ("simt" if cin <= 4 else "mma")


@pytest.mark.parametrize("case", ["all_pairless", "none_pairless", "last_tile_only", "straddle"])
def test_row_compaction_edges(dev, case):
    K, n, cin, cout = 4, 3000, 64, 96
    x, go, idx = _inputs(dev, K, n, n, cin, cout, density=1.0)
    if case == "all_pairless":
        idx[:] = -1
    elif case == "last_tile_only":
        idx[:, :-5] = -1  # five paired rows, all in the split's last, partial tile
    elif case == "straddle":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = plan(K, cin, cout, n, sms).splits
        assert splits > 1
        per = -(-n // 256 // splits) * 256  # rows per split (csrc/conv_dw.cu)
        idx[:] = -1
        idx[:, per - 37: per + 41] = torch.arange(78, device=dev, dtype=torch.int32)
    got = _check(x, go, idx)
    if case == "all_pairless":
        assert torch.all(got == 0)


def test_four_byte_copies_match_plain(dev):
    # Cin % 4 != 0, and a view one row in (4-byte aligned only)
    x, go, idx = _inputs(dev, 27, 801, 700, 5, 64)
    for xv in (x[:800], x[1:]):
        _check(xv, go, idx)
        assert conv_dw.last_plan.vec == 1
    # Cin % 4 == 0 but g starts 4 bytes past a 16-byte boundary
    x8, g8, idx8 = _inputs(dev, 8, 500, 400, 8, 32)
    flat = torch.cat([g8.new_zeros(1), g8.flatten()])
    gv = flat[1:].view(400, 32)
    assert gv.data_ptr() % 16 != 0
    _check(x8, gv, idx8)
    assert conv_dw.last_plan.vec == 1


def test_two_launches_are_bit_equal(dev):
    for shape in [(27, 20000, 20000, 96, 96), (125, 5000, 5000, 3, 32), (27, 618, 618, 384, 256)]:
        x, go, idx = _inputs(dev, *shape)
        assert torch.equal(conv_dw(x, go, idx), conv_dw(x, go, idx))


def test_rejects_what_it_does_not_take(dev):
    x, go, idx = _inputs(dev, 8, 100, 200, 16, 16)
    with pytest.raises(ValueError):
        conv_dw(x.t().contiguous().t(), go, idx)  # not contiguous
    with pytest.raises(TypeError):
        conv_dw(x.half(), go, idx)
    with pytest.raises(TypeError):  # float64 runs on the CPU only
        conv_dw(x.double(), go.double(), idx)
    with pytest.raises(ValueError):
        conv_dw(x, go.cpu(), idx)
    with pytest.raises(ValueError):
        conv_dw(x, go[:10], idx)


def _matching(dev, K, n_in, n_out, seed=0):
    """Injective per-offset map with -1 holes, and its inverse."""
    gen = torch.Generator().manual_seed(seed)
    m = min(n_in, n_out)
    idx = torch.full((K, n_out), -1, dtype=torch.int32)
    for k in range(K):
        idx[k, torch.randperm(n_out, generator=gen)[:m]] = torch.randperm(n_in, generator=gen)[:m].int()
    idx[torch.rand(K, n_out, generator=gen) > 0.7] = -1
    return idx.to(dev), _invert_matching(idx, n_in).to(dev)


@pytest.mark.parametrize("K,n_in,n_out,cin,cout", [(27, 900, 900, 32, 64), (8, 300, 1200, 96, 96)])
def test_autograd_matches_cpu_plain_path(dev, K, n_in, n_out, cin, cout):
    in_idx, out_idx_t = _matching(dev, K, n_in, n_out)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(n_in, cin, generator=gen)
    w = torch.randn(K, cin, cout, generator=gen) / (K * cin) ** 0.5
    go = torch.randn(n_out, cout, generator=gen)
    grads = []
    for d in ("cpu", dev):
        xd = x.to(d, copy=True).requires_grad_()
        wd = w.to(d, copy=True).requires_grad_()
        sparse_conv(xd, wd, in_idx.to(d), out_idx_t.to(d)).backward(go.to(d))
        grads.append((xd.grad.cpu(), wd.grad.cpu()))
    (dx_cpu, dw_cpu), (dx_gpu, dw_gpu) = grads
    assert _rel(dx_gpu, dx_cpu) <= 1e-5
    assert _rel(dw_gpu, dw_cpu) <= DW_RTOL


def test_cuda_grad_launches_both_kernels(dev):
    in_idx, out_idx_t = _matching(dev, 27, 500, 500)
    x = torch.randn(500, 32, device=dev, requires_grad=True)
    w = torch.randn(27, 32, 32, device=dev, requires_grad=True)
    fwd_dx, dw = gather_gemm.launches, conv_dw.launches
    sparse_conv(x, w, in_idx, out_idx_t).sum().backward()
    assert gather_gemm.launches == fwd_dx + 2  # forward, then dX
    assert conv_dw.launches == dw + 1
    x2 = torch.randn(500, 32, device=dev)  # an input without a gradient: no dX launch
    before = gather_gemm.launches
    sparse_conv(x2, w, in_idx, out_idx_t).sum().backward()
    assert gather_gemm.launches == before + 1


# CompletionNet's and the VAE's new shapes: the Cin = 1 stems at stride 1
# and 2, the k = 4 generative conv (K = 64, 1024 -> 512), Cout = 16
GENERATIVE_CONVS = [
    (27, 1, 16, 60000, 60000), (27, 1, 16, 80000, 21000), (64, 1024, 512, 60, 2000),
    (27, 16, 16, 50000, 50000), (27, 32, 16, 9000, 9000),
]


@pytest.mark.parametrize(
    "K,cin,cout,n_in,n_out", GENERATIVE_CONVS,
    ids=[f"k{k}-{ci}to{co}-{a}to{b}" for k, ci, co, a, b in GENERATIVE_CONVS],
)
def test_generative_shapes(dev, K, cin, cout, n_in, n_out):
    in_idx, _ = _matching(dev, K, n_in, n_out)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(n_in, cin, device=dev, generator=g)
    go = torch.randn(n_out, cout, device=dev, generator=g)
    _check(x, go, in_idx)
    assert conv_dw.last_plan.body == ("simt" if cin <= 4 else "mma")
    if cin > 4:
        assert conv_dw.last_plan.vec == 4  # Cin and Cout multiples of 4


def test_generative_map(dev):
    """A k = 2 generative map: each output row has one paired slot of 8."""
    n_in = 20000
    o = torch.arange(8 * n_in)
    idx = torch.where(o[None, :] % 8 == torch.arange(8)[:, None], o // 8, -1).int().to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(n_in, 32, device=dev, generator=g)
    go = torch.randn(8 * n_in, 16, device=dev, generator=g)
    _check(x, go, idx)


def test_two_million_rows_at_stride_one(dev):
    """A stride-1 weight gradient summed over 2.1M rows per offset."""
    n = 2_100_000
    in_idx, _ = _matching(dev, 27, n, n)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n, 16, device=dev, generator=g)
    go = torch.randn(n, 16, device=dev, generator=g)
    _check(x, go, in_idx)


def test_splat_map(dev):
    """K = 27, 32 -> 48 on MinkowskiSplatFCNN's conv1 map of a splat."""
    from test_torch_gather_gemm_cuda import splat_conv1_map

    n, kmap = splat_conv1_map(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(n, 32, device=dev, generator=g)
    go = torch.randn(n, 48, device=dev, generator=g)
    _check(x, go, kmap.in_idx)


# --- the bf16 instance: bf16 x and g, a float32 dW ---------------------------
# Tolerance: DW_RTOL, as the float32 instance: bf16 x bf16 products are
# exact in float32, so both sides sum the same float32 terms in another
# order.


@pytest.mark.parametrize(
    "K,n_in,n_out,cin,cout",
    [
        (125, 3000, 3000, 3, 32),      # the stem: mma.sync, G by 16-byte copies
        (27, 2000, 2000, 1, 16),       # Cin = 1
        (27, 2000, 2000, 4, 70),       # the stem with G by 4-byte copies
        (27, 2000, 2000, 3, 33),       # the stem with G by plain loads
        (27, 700, 650, 256, 256),      # two warpgroups of 128 columns
        (27, 20000, 20000, 96, 96),    # many rows: the row split, ragged Cout tile
        (8, 300, 1200, 128, 96),
        (27, 47834, 27633, 336, 256),  # FCNN conv5a: Cin 336
        (27, 47834, 47834, 32, 48),    # FCNN conv1: Cout 48
        (27, 9538, 3012, 512, 1024),   # FCNN conv5c: Cout 1024
        (27, 1500, 1700, 6, 70),       # even widths: 4-byte copies
        (27, 1500, 1700, 5, 70),       # odd Cin: plain loads
        (8, 1500, 1700, 96, 33),       # odd Cout: plain loads
        (27, 1500, 1700, 64, 8),       # Cout 8: a 16-wide tile
        (27, 2000, 2000, 128, 192),    # Cout 192: two warpgroups of 96
        (27, 3000, 2500, 96, 336),     # Cout 336: two 192-wide tiles, the second ragged
        (27, 3000, 2500, 256, 512),    # Cout 512
        (4, 10, 0, 8, 8),
        # CompletionNet's and the VAE's bf16 shapes
        (27, 60000, 60000, 1, 16),     # the Cin = 1 stem
        (27, 1100000, 1100000, 16, 16),  # a stride-1 decoder level: the row split
        (64, 60, 2000, 1024, 512),     # the k = 4 generative conv
    ],
)
def test_bf16_kernel_matches_plain(dev, K, n_in, n_out, cin, cout):
    x, go, idx = _inputs(dev, K, n_in, n_out, cin, cout)
    x, go = x.bfloat16(), go.bfloat16()
    f32_before, before = conv_dw.launches, conv_dw.bf16_launches
    got = conv_dw(x, go, idx)
    want = conv_dw_reference(x, go, idx)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32 and got.shape == (K, cin, cout)
    assert conv_dw.bf16_launches == before + 1 and conv_dw.launches == f32_before
    if n_out:
        assert _rel(got, want) <= DW_RTOL
        p = conv_dw.last_plan
        if cin > 4:
            want_vec = 8 if cin % 8 == 0 and cout % 8 == 0 else 2 if cin % 2 == 0 and cout % 2 == 0 else 1
            assert p.vec == want_vec
            assert p.body == ("wgmma" if want_vec == 8 else "mma")
        else:  # G's copy width
            assert p.body == "stem_mma"
            assert p.vec == (8 if cout % 8 == 0 else 2 if cout % 2 == 0 else 1)
        if (n_out, cin, cout) == (20000, 96, 96):
            assert p.splits > 1
    else:
        assert torch.all(got == 0)


def test_bf16_two_launches_are_bit_equal(dev):
    for shape, bodies in [((27, 20000, 20000, 96, 96), ("wgmma", "mma")),
                          ((125, 3000, 3000, 3, 32), ("stem_mma", "simt")),
                          ((27, 2000, 2000, 128, 256), ("wgmma",))]:
        x, go, idx = _inputs(dev, *shape)
        x, go = x.bfloat16(), go.bfloat16()
        for body in bodies:
            assert torch.equal(conv_dw(x, go, idx, body=body), conv_dw(x, go, idx, body=body))


def test_bf16_pairless_and_out_of_range_rows_add_nothing(dev):
    """The wgmma body and the stem: a whole stage of pairless rows, indices
    >= N_in and a map with no pair at all, as the float32 instance."""
    for cin in (16, 3):
        x, go, idx = _inputs(dev, 8, 100, 200, cin, 16)
        x, go = x.bfloat16(), go.bfloat16()
        idx[:, :64] = -1           # a whole chunk with no pair: skipped
        idx[:, 64] = 100           # outside [0, n_in): gathers zero
        idx[2, 65:70] = 1 << 30
        got = conv_dw(x, go, idx)
        assert conv_dw.last_plan.body == ("wgmma" if cin > 4 else "stem_mma")
        idx[2, 65:70] = -1
        want = conv_dw_reference(x, go[65:].contiguous(), idx[:, 65:].contiguous())
        assert _rel(got, want) <= DW_RTOL
        empty = torch.full((3, 130), -1, dtype=torch.int32, device=dev)
        assert torch.all(conv_dw(x, go[:130].contiguous(), empty) == 0)


@pytest.mark.parametrize("case", ["all_pairless", "last_tile_only", "straddle"])
def test_bf16_row_compaction_edges(dev, case):
    """The wgmma body's 64-row stages at the edges of the compaction: no
    pair, a partial last stage only, pairs straddling two row splits."""
    K, n, cin, cout = 4, 3000, 64, 96
    x, go, idx = _inputs(dev, K, n, n, cin, cout, density=1.0)
    x, go = x.bfloat16(), go.bfloat16()
    if case == "all_pairless":
        idx[:] = -1
    elif case == "last_tile_only":
        idx[:, :-5] = -1
    else:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = plan(K, cin, cout, n, sms, bf16=True).splits
        assert splits > 1
        per = -(-n // 256 // splits) * 256  # rows per split (csrc/conv_dw_wgmma.cu)
        idx[:] = -1
        idx[:, per - 37: per + 41] = torch.arange(78, device=dev, dtype=torch.int32)
    got = _check(x, go, idx)
    assert conv_dw.last_plan.body == "wgmma"
    if case == "all_pairless":
        assert torch.all(got == 0)


@pytest.mark.parametrize("K,cin,cout,n_in,n_out", STEP_CONVS + CLASSIFICATION_CONVS,
                         ids=STEP_IDS + CLASSIFICATION_IDS)
def test_bf16_step_convs_weight_gradient(dev, K, cin, cout, n_in, n_out):
    """Every distinct conv of a MinkUNet34 and a MinkowskiFCNN step in bf16:
    the weight gradient on the wgmma body (the Cin = 3 stem on mma.sync),
    against plain."""
    in_idx, _ = _matching(dev, K, n_in, n_out)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n_in, cin, device=dev, generator=g).bfloat16()
    go = torch.randn(n_out, cout, device=dev, generator=g).bfloat16()
    got = conv_dw(x, go, in_idx)
    assert conv_dw.last_plan.body == ("stem_mma" if cin <= 4 else "wgmma")
    assert _rel(got, conv_dw_reference(x, go, in_idx)) <= DW_RTOL


def test_bf16_sparse_conv_grads(dev):
    """bf16 features with the float32 weight: a bf16 output and input
    gradient (the bf16 K1 instance, one ulp), a float32 weight gradient
    (the bf16 K2 instance, the float32 sum, not its bf16 rounding)."""
    from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm_reference

    n_in, n_out, K, cin, cout = 3000, 2500, 27, 64, 96
    gen = torch.Generator().manual_seed(0)
    m = min(n_in, n_out)
    in_idx = torch.full((K, n_out), -1, dtype=torch.int32)
    for k in range(K):
        in_idx[k, torch.randperm(n_out, generator=gen)[:m]] = torch.randperm(n_in, generator=gen)[:m].int()
    in_idx[torch.rand(K, n_out, generator=gen) > 0.7] = -1
    out_idx_t = _invert_matching(in_idx, n_in).to(dev)
    in_idx = in_idx.to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n_in, cin, device=dev, generator=g).bfloat16().requires_grad_()
    w = (torch.randn(K, cin, cout, device=dev, generator=g) / (K * cin) ** 0.5).requires_grad_()
    go = torch.randn(n_out, cout, device=dev, generator=g).bfloat16()
    counts = (gather_gemm.launches, gather_gemm.bf16_launches, conv_dw.launches, conv_dw.bf16_launches)
    out = sparse_conv(x, w, in_idx, out_idx_t)
    out.backward(go)
    assert (gather_gemm.launches, gather_gemm.bf16_launches, conv_dw.launches,
            conv_dw.bf16_launches) == (counts[0], counts[1] + 2, counts[2], counts[3] + 1)
    wb = w.detach().bfloat16()
    assert out.dtype == x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert _rel(out.float(), gather_gemm_reference(x.detach(), wb, in_idx).float()) <= 2.0**-7
    want_dx = gather_gemm_reference(go, wb.transpose(1, 2).contiguous(), out_idx_t)
    assert _rel(x.grad.float(), want_dx.float()) <= 2.0**-7
    want_dw = conv_dw_reference(x.detach(), go, in_idx)
    assert _rel(w.grad, want_dw) <= DW_RTOL
    assert not torch.equal(w.grad, w.grad.bfloat16().float())  # not rounded to bf16
