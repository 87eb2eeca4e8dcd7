"""The CUDA gather-GEMM kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.  Run
them on the card with
``python -m pytest --noconftest tests/test_torch_gather_gemm_cuda.py``
(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use and the card's machine need not have).
Tolerance: max |Δ| / max |ref| <= 1e-5, the f32 summation-order bound that
chip_smoke.py states (``KERNEL_RTOL``), for every float32 body.
"""

import pytest
import torch

from minkowskiengine_tpu_torch.coords.kernel_map import _invert_matching
from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm, gather_gemm_reference
from minkowskiengine_tpu_torch.ops.functional import sparse_conv
from test_torch_kernel_plans import STEP_CONVS

pytestmark = pytest.mark.cuda
STEP_IDS = [f"k{k}-{ci}to{co}-{a}to{b}" for k, ci, co, a, b in STEP_CONVS]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _inputs(dev, K, n_in, n_out, cin, cout, density=0.7, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n_in, cin, device=dev, generator=g)
    w = torch.randn(K, cin, cout, device=dev, generator=g)
    idx = torch.randint(0, max(n_in, 1), (K, n_out), device=dev, generator=g, dtype=torch.int32)
    idx[torch.rand(K, n_out, device=dev, generator=g) > density] = -1
    return x, w, idx


@pytest.mark.parametrize(
    "K,n_in,n_out,cin,cout",
    [
        (125, 1000, 1000, 3, 32),   # stem
        (27, 700, 650, 96, 96),     # ragged Cout tile, rows not a multiple of 64
        (8, 300, 1200, 256, 128),   # transposed conv: more outputs than inputs
        (27, 63, 63, 384, 256),
        (1, 5, 3, 5, 70),
        (4, 10, 0, 8, 8),           # no output rows
    ],
)
def test_kernel_matches_plain(dev, K, n_in, n_out, cin, cout):
    x, w, idx = _inputs(dev, K, n_in, n_out, cin, cout)
    before = gather_gemm.launches
    got = gather_gemm(x, w, idx)
    want = gather_gemm_reference(x, w, idx)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n_out, cout)
    if n_out:
        rel = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
        assert rel <= 1e-5
        assert gather_gemm.launches == before + 1


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize(
    "K,n,cin,cout",
    [(27, 125, 256, 256), (27, 125, 384, 256), (27, 618, 256, 256), (27, 618, 384, 256)],
)
def test_offset_split_on_the_deep_levels(dev, K, n, cin, cout):
    x, w, idx = _inputs(dev, K, n, n, cin, cout, density=0.4)
    want = gather_gemm_reference(x, w, idx)
    got = gather_gemm(x, w, idx)
    assert gather_gemm.last_plan.splits > 1 and gather_gemm.last_plan.body == "wgmma_3xtf32"
    assert _rel(got, want) <= 1e-5
    got = gather_gemm(x, w, idx, body="mma")
    assert gather_gemm.last_plan.splits > 1 and gather_gemm.last_plan.body == "mma"
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("K,n,cin,cout", [(27, 20000, 96, 64), (1, 3000, 64, 96), (1, 40, 32, 32)])
def test_one_split_and_one_offset(dev, K, n, cin, cout):
    x, w, idx = _inputs(dev, K, n, n, cin, cout)
    got = gather_gemm(x, w, idx)
    if n >= 20000:
        assert gather_gemm.last_plan.splits == 1  # enough row tiles: no second pass
    assert _rel(got, gather_gemm_reference(x, w, idx)) <= 1e-5


# (K, Cin, Cout, rows in, rows out): MinkowskiFCNN's seven convs and
# ResNet18's k = 1, stride-2 downsamples on a batch of 32 shapes x 2048
# points at 2.5 cm (47,834 / 27,633 / 9,538 / 3,012 / 1,142 / 262 / 246
# rows at strides 1-64).  Cin 48 and 336 end in a ragged 32-wide chunk of
# the 16-byte copy ring; Cout 48 pads to a 64-wide tile; Cout 1024 takes
# sixteen.
CLASSIFICATION_CONVS = [
    (27, 32, 48, 47834, 47834), (27, 48, 64, 27633, 9538), (27, 64, 96, 3012, 1142),
    (27, 96, 128, 262, 246), (27, 336, 256, 47834, 27633), (27, 256, 512, 27633, 9538),
    (27, 512, 1024, 9538, 3012),
    (1, 64, 64, 9538, 3012), (1, 64, 128, 3012, 1142), (1, 128, 256, 1142, 262),
    (1, 256, 512, 262, 246),
]
CLASSIFICATION_IDS = [f"k{k}-{ci}to{co}-{a}to{b}" for k, ci, co, a, b in CLASSIFICATION_CONVS]


def _matching(dev, K, n_in, n_out, seed=0):
    """Injective per-offset map with -1 holes, and its inverse."""
    gen = torch.Generator().manual_seed(seed)
    m = min(n_in, n_out)
    idx = torch.full((K, n_out), -1, dtype=torch.int32)
    for k in range(K):
        idx[k, torch.randperm(n_out, generator=gen)[:m]] = torch.randperm(n_in, generator=gen)[:m].int()
    idx[torch.rand(K, n_out, generator=gen) > 0.7] = -1
    return idx.to(dev), _invert_matching(idx, n_in).to(dev)


@pytest.mark.parametrize("K,cin,cout,n_in,n_out", CLASSIFICATION_CONVS, ids=CLASSIFICATION_IDS)
def test_classification_shapes_forward_and_input_gradient(dev, K, cin, cout, n_in, n_out):
    in_idx, out_idx_t = _matching(dev, K, n_in, n_out)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n_in, cin, device=dev, generator=g)
    w = torch.randn(K, cin, cout, device=dev, generator=g) / (K * cin) ** 0.5
    go = torch.randn(n_out, cout, device=dev, generator=g)
    assert _rel(gather_gemm(x, w, in_idx), gather_gemm_reference(x, w, in_idx)) <= 1e-5
    assert gather_gemm.last_plan.vec == 4 and gather_gemm.last_plan.body == "wgmma_3xtf32"
    wt = w.transpose(1, 2).contiguous()
    assert _rel(gather_gemm(go, wt, out_idx_t), gather_gemm_reference(go, wt, out_idx_t)) <= 1e-5


def test_four_byte_copies_match_plain(dev):
    # Cin % 4 != 0, and a view one row in (4-byte aligned only)
    x, w, idx = _inputs(dev, 27, 801, 700, 5, 64)
    for xv in (x[:800], x[1:]):
        got = gather_gemm(xv, w, idx)
        assert gather_gemm.last_plan.vec == 1
        assert _rel(got, gather_gemm_reference(xv, w, idx)) <= 1e-5
    # Cin % 4 == 0 but x starts 4 bytes past a 16-byte boundary
    x8, w8, idx8 = _inputs(dev, 8, 500, 400, 8, 32)
    flat = torch.cat([x8.new_zeros(1), x8.flatten()])
    xv = flat[1:].view(500, 8)
    assert xv.data_ptr() % 16 != 0
    got = gather_gemm(xv, w8, idx8)
    assert gather_gemm.last_plan.vec == 1
    assert _rel(got, gather_gemm_reference(x8, w8, idx8)) <= 1e-5


def test_two_launches_are_bit_equal(dev):
    for shape in [(27, 618, 618, 384, 256), (27, 5000, 5000, 96, 96), (125, 2000, 2000, 3, 32)]:
        x, w, idx = _inputs(dev, *shape)
        assert torch.equal(gather_gemm(x, w, idx), gather_gemm(x, w, idx))


def test_rows_without_pairs_and_out_of_range_are_zero(dev):
    x, w, idx = _inputs(dev, 8, 100, 200, 16, 16)
    idx[:, :64] = -1           # a whole tile with no pair: every offset skipped
    idx[:, 64] = 100           # outside [0, n_in): gathers zero
    got = gather_gemm(x, w, idx)
    assert torch.all(got[:65] == 0)


def test_rejects_what_it_does_not_take(dev):
    x, w, idx = _inputs(dev, 8, 100, 200, 16, 16)
    with pytest.raises(ValueError):
        gather_gemm(x.t().contiguous().t(), w, idx)  # not contiguous
    with pytest.raises(TypeError):
        gather_gemm(x.half(), w, idx)
    with pytest.raises(TypeError):  # float64 runs on the CPU only
        gather_gemm(x.double(), w.double(), idx)
    with pytest.raises(ValueError):
        gather_gemm(x, w.cpu(), idx)
    # the input gradient runs the kernel on the inverse matching with W[k]ᵀ
    in_idx = torch.stack([torch.randperm(100, device=x.device)[:64] for _ in range(8)]).int()
    in_idx[:, ::3] = -1
    out_idx_t = _invert_matching(in_idx, 100)
    xg = x.clone().requires_grad_()
    go = torch.randn(64, 16, device=x.device)
    before = gather_gemm.launches
    sparse_conv(xg, w, in_idx, out_idx_t).backward(go)
    assert gather_gemm.launches == before + 2
    want = gather_gemm_reference(go, w.transpose(1, 2).contiguous(), out_idx_t)
    assert ((xg.grad - want).abs().max() / want.abs().max()).item() <= 1e-5


# CompletionNet's and the VAE's new shapes: the Cin = 1 stems at stride 1
# and 2, the k = 4 generative conv (K = 64, 1024 -> 512), Cout = 16
GENERATIVE_CONVS = [
    (27, 1, 16, 60000, 60000), (27, 1, 16, 80000, 21000), (64, 1024, 512, 60, 2000),
    (27, 16, 16, 50000, 50000), (27, 32, 16, 9000, 9000),
]
GENERATIVE_IDS = [f"k{k}-{ci}to{co}-{a}to{b}" for k, ci, co, a, b in GENERATIVE_CONVS]


@pytest.mark.parametrize("K,cin,cout,n_in,n_out", GENERATIVE_CONVS, ids=GENERATIVE_IDS)
def test_generative_shapes_forward_and_input_gradient(dev, K, cin, cout, n_in, n_out):
    in_idx, out_idx_t = _matching(dev, K, n_in, n_out)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(n_in, cin, device=dev, generator=g)
    w = torch.randn(K, cin, cout, device=dev, generator=g) / (K * cin) ** 0.5
    go = torch.randn(n_out, cout, device=dev, generator=g)
    assert _rel(gather_gemm(x, w, in_idx), gather_gemm_reference(x, w, in_idx)) <= 1e-5
    assert gather_gemm.last_plan.body == ("simt" if cin <= 4 else "wgmma_3xtf32")
    wt = w.transpose(1, 2).contiguous()
    assert _rel(gather_gemm(go, wt, out_idx_t), gather_gemm_reference(go, wt, out_idx_t)) <= 1e-5


def generative_map(dev, n_in, k_vol=8):
    """A k = 2 generative map: every input row has 8 children, each output
    row exactly one paired slot of 8."""
    o = torch.arange(k_vol * n_in)
    idx = torch.where(o[None, :] % k_vol == torch.arange(k_vol)[:, None], o // k_vol, -1)
    return idx.int().to(dev)


def test_generative_map_forward_and_input_gradient(dev):
    in_idx = generative_map(dev, 20000)
    out_idx_t = _invert_matching(in_idx, 20000)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(20000, 32, device=dev, generator=g)
    w = torch.randn(8, 32, 16, device=dev, generator=g)
    go = torch.randn(160000, 16, device=dev, generator=g)
    assert _rel(gather_gemm(x, w, in_idx), gather_gemm_reference(x, w, in_idx)) <= 1e-5
    wt = w.transpose(1, 2).contiguous()
    assert _rel(gather_gemm(go, wt, out_idx_t), gather_gemm_reference(go, wt, out_idx_t)) <= 1e-5


def test_two_million_rows_at_stride_one(dev):
    """A stride-1 conv over 2.1M rows: no 32-bit index product overflows."""
    n = 2_100_000
    in_idx, out_idx_t = _matching(dev, 27, n, n)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n, 16, device=dev, generator=g)
    w = torch.randn(27, 16, 16, device=dev, generator=g) / (27 * 16) ** 0.5
    assert _rel(gather_gemm(x, w, in_idx), gather_gemm_reference(x, w, in_idx)) <= 1e-5
    wt = w.transpose(1, 2).contiguous()
    assert _rel(gather_gemm(x, wt, out_idx_t), gather_gemm_reference(x, wt, out_idx_t)) <= 1e-5


def splat_conv1_map(dev):
    """MinkowskiSplatFCNN's conv1 map (k = 3, stride 1) on a splat: 8
    synthetic shapes x 2048 points at 2.5 cm, each point's 2x2x2 corners."""
    import minkowskiengine_tpu_torch as MT
    from minkowskiengine_tpu_torch.utils.datasets import modelnet_batch

    coords, feats, _ = modelnet_batch(8, n_points=2048, seed=0, voxel_size=0.025)
    st = MT.TensorField(torch.from_numpy(feats).to(dev), torch.from_numpy(coords).to(dev), device=dev).splat()
    key = st.coordinate_map_key
    return st.size, st.coordinate_manager.kernel_map(key, key, kernel_size=3)


def test_splat_map_forward_and_input_gradient(dev):
    """K = 27, 32 -> 48 on the splat map: dense little blocks of corners."""
    n, kmap = splat_conv1_map(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(n, 32, device=dev, generator=g)
    w = torch.randn(27, 32, 48, device=dev, generator=g) / (27 * 32) ** 0.5
    go = torch.randn(n, 48, device=dev, generator=g)
    assert _rel(gather_gemm(x, w, kmap.in_idx), gather_gemm_reference(x, w, kmap.in_idx)) <= 1e-5
    wt = w.transpose(1, 2).contiguous()
    assert _rel(gather_gemm(go, wt, kmap.out_idx_t), gather_gemm_reference(go, wt, kmap.out_idx_t)) <= 1e-5


# --- the float32 wgmma body -------------------------------------------------
# Every float32 call with Cin and Cout multiples of 8 and 16-byte aligned
# operands takes it; each case is held to plain at 1e-5, forward and input
# gradient, and to the mma.sync body it replaced (asked for with ``body=``).
F32_WGMMA_CASES = [
    # MinkUNet34's widths at a room2cm batch's rows (~326k at stride 1):
    # the stride-1 block convs, the last level's concatenated input
    (27, 326000, 96, 96), (27, 326000, 128, 96),
    (27, 80000, 32, 32), (8, 20000, 32, 64),  # k = 2 strided: 8 offsets
    (27, 5000, 64, 128), (27, 5000, 128, 256),
    (27, 900, 256, 256), (27, 900, 384, 256),  # the deep levels: offsets split, S > 1
    (27, 200, 256, 256), (8, 200, 256, 128),
    (27, 3000, 192, 128), (27, 3000, 96, 192),  # Cout 192: two 96-wide tiles
    # CompletionNet: its 16-wide levels, the k = 4 generative conv
    (27, 1000000, 16, 16), (27, 50000, 16, 32), (64, 2000, 1024, 512),
    # ragged Cin chunks (8, 24, 40, 336), Cout 8 and 1024, K = 125
    (27, 3000, 8, 8), (27, 3000, 24, 40), (27, 3000, 336, 48), (27, 3000, 512, 1024),
    (125, 700, 40, 24),
]
F32_WGMMA_IDS = [f"k{k}-{n}-{ci}to{co}" for k, n, ci, co in F32_WGMMA_CASES]


@pytest.mark.parametrize("K,n,cin,cout", F32_WGMMA_CASES, ids=F32_WGMMA_IDS)
def test_f32_wgmma_body_matches_plain_and_the_mma_body(dev, K, n, cin, cout):
    """The forward on an injective map with holes, and the input gradient
    through ``sparse_conv``'s autograd on the inverse map (``out_idx_t``,
    W[k] transposed), on the wgmma body; the mma.sync body on the same
    forward within the same tolerance of plain."""
    in_idx, out_idx_t = _matching(dev, K, n, n)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(n, cin, device=dev, generator=g)
    w = torch.randn(K, cin, cout, device=dev, generator=g) / (K * cin) ** 0.5
    go = torch.randn(n, cout, device=dev, generator=g)
    want = gather_gemm_reference(x, w, in_idx)
    before = dict(gather_gemm.float32_body_launches)
    xg = x.clone().requires_grad_()
    out = sparse_conv(xg, w, in_idx, out_idx_t)
    assert gather_gemm.last_plan.body == "wgmma_3xtf32"
    assert _rel(out.detach(), want) <= 1e-5
    out.backward(go)
    assert gather_gemm.last_plan.body == "wgmma_3xtf32"
    dx = gather_gemm_reference(go, w.transpose(1, 2).contiguous(), out_idx_t)
    assert _rel(xg.grad, dx) <= 1e-5
    assert gather_gemm.float32_body_launches["wgmma_3xtf32"] == before["wgmma_3xtf32"] + 2
    assert _rel(gather_gemm(x, w, in_idx, body="mma"), want) <= 1e-5


def test_f32_wgmma_two_launches_are_bit_equal(dev):
    for shape in [(27, 618, 618, 384, 256), (27, 5000, 5000, 96, 96), (8, 3000, 3000, 16, 16),
                  (27, 900, 900, 128, 192)]:
        x, w, idx = _inputs(dev, *shape)
        got = gather_gemm(x, w, idx)
        assert gather_gemm.last_plan.body == "wgmma_3xtf32"
        assert torch.equal(got, gather_gemm(x, w, idx))


def test_f32_wgmma_rows_without_pairs_and_out_of_range_are_zero(dev):
    """A row tile whose offsets are all -1 (every offset skipped by the
    vote) and a row whose indices lie at or past N_in come out zero."""
    x, w, idx = _inputs(dev, 8, 100, 300, 16, 16)
    idx[:, :64] = -1
    idx[:, 64] = 100
    idx[:, 65] = 2**31 - 1
    got = gather_gemm(x, w, idx)
    assert gather_gemm.last_plan.body == "wgmma_3xtf32"
    assert torch.all(got[:66] == 0)
    assert _rel(got, gather_gemm_reference(x, w, idx)) <= 1e-5


def test_f32_wgmma_body_by_shape(dev):
    """Odd and unaligned widths keep the mma.sync body, Cin <= 4 the SIMT
    stem, and the wgmma body refuses what it does not take."""
    for shape, body in [((27, 800, 700, 12, 64), "mma"), ((27, 800, 700, 64, 36), "mma"),
                        ((27, 800, 700, 4, 32), "simt"), ((27, 800, 700, 64, 64), "wgmma_3xtf32")]:
        x, w, idx = _inputs(dev, *shape)
        got = gather_gemm(x, w, idx)
        assert gather_gemm.last_plan.body == body
        assert _rel(got, gather_gemm_reference(x, w, idx)) <= 1e-5
    x, w, idx = _inputs(dev, 27, 801, 700, 64, 64)
    xu = x.flatten()[1:1 + 800 * 64].view(800, 64)  # 4 bytes past a 16-byte boundary
    assert xu.data_ptr() % 16 != 0
    got = gather_gemm(xu, w, idx)
    assert gather_gemm.last_plan.body == "mma"
    assert _rel(got, gather_gemm_reference(xu, w, idx)) <= 1e-5
    with pytest.raises(ValueError):
        gather_gemm(xu, w, idx, body="wgmma_3xtf32")
    with pytest.raises(ValueError):
        gather_gemm(x[:, :12].contiguous(), w[:, :12].contiguous(), idx, body="wgmma_3xtf32")
    with pytest.raises(ValueError):
        gather_gemm(x, w, idx, body="wgmma")  # the bf16 body


def test_f32_minkunet34_training_step_counts(dev):
    """A float32 MinkUNet34 training step launches 109 K1 calls: the Cin = 3
    stem's forward on the SIMT body, the other 54 forwards and 54 input
    gradients on the wgmma body; a request 55, 54 on the wgmma body."""
    import numpy as np

    import minkowskiengine_tpu_torch as MT
    from minkowskiengine_tpu_torch.models import MinkUNet34

    rng = np.random.RandomState(0)
    pts = np.unique(rng.randint(0, 60, size=(12000, 3)), axis=0)
    coords = np.concatenate([np.zeros((len(pts), 1), np.int64), pts], 1)
    net = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).train()
    x = MT.SparseTensor(torch.randn(len(pts), 3, device=dev),
                        torch.from_numpy(coords).int().to(dev), device=dev)
    before = dict(gather_gemm.float32_body_launches)
    net(x).F.square().mean().backward()
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in gather_gemm.float32_body_launches.items()}
    assert delta == {"wgmma_3xtf32": 108, "mma": 0, "simt": 1}
    # a request (no gradient): the 54 forwards on the wgmma body, the stem on SIMT
    before = dict(gather_gemm.float32_body_launches)
    with torch.no_grad():
        net.eval()(MT.SparseTensor(x.F, x.C, device=dev))
    delta = {k: v - before[k] for k, v in gather_gemm.float32_body_launches.items()}
    assert delta == {"wgmma_3xtf32": 54, "mma": 0, "simt": 1}


# --- the bf16 instance -------------------------------------------------------
# Tolerance: max |Δ| / max |ref| <= 2^-7, one bf16 ulp at the output's
# largest value: the kernel and the plain version both sum exact products
# in float32, in different orders, and round once, so a sum next to a
# rounding boundary may land one ulp apart.
BF16_RTOL = 2.0**-7

# (K, rows in, rows out, Cin, Cout, copy width or None for the stem); the
# wgmma body takes every case with 16-byte copies, the mma.sync body the
# even (4-byte) and odd (plain-load) widths
BF16_CASES = [
    (125, 1000, 1000, 3, 32, None),    # the stem: bf16 loads, float32 FMAs
    (27, 700, 650, 96, 96, 8),         # one 96-wide tile, rows not a multiple of 64
    (8, 300, 1200, 256, 128, 8),       # transposed conv: more outputs than inputs
    (27, 3012, 1142, 336, 48, 8),      # Cin 336: a ragged last chunk; Cout 48: a 48-wide tile
    (27, 9538, 3012, 512, 1024, 8),    # FCNN conv5c: Cout 1024, four 256-wide tiles
    (27, 27633, 9538, 48, 64, 8),      # FCNN conv2: Cin 48
    (27, 900, 700, 64, 8, 8),          # Cout 8: a 16-wide tile, half of it past Cout
    (27, 900, 700, 128, 192, 8),       # Cout 192
    (27, 900, 700, 128, 256, 8),       # Cout 256: one tile
    (27, 900, 700, 96, 336, 8),        # Cout 336: two 192-wide tiles, the second ragged
    (27, 2000, 1500, 256, 512, 8),     # Cout 512: two tiles
    (125, 700, 700, 40, 24, 8),        # K = 125: four groups of staged offsets
    (27, 800, 700, 6, 70, 2),          # even widths: 4-byte copies
    (27, 800, 700, 5, 64, 1),          # odd Cin: plain loads
    (8, 600, 500, 64, 33, 1),          # odd Cout: plain loads
    (1, 5, 3, 5, 70, 1),
    (4, 10, 0, 8, 8, 8),               # no output rows
    # CompletionNet's and the VAE's bf16 shapes
    (27, 60000, 60000, 1, 16, None),   # the Cin = 1 stem
    (27, 1100000, 1100000, 16, 16, 8),  # a stride-1 decoder level: 16-wide tiles, 64-row tiles
    (64, 60, 2000, 1024, 512, 8),      # the k = 4 generative conv
]


def _bf16_body(cin, vec):
    return "simt" if cin <= 4 else "wgmma" if vec == 8 else "mma"


@pytest.mark.parametrize("K,n_in,n_out,cin,cout,vec", BF16_CASES)
def test_bf16_kernel_matches_plain(dev, K, n_in, n_out, cin, cout, vec):
    x, w, idx = _inputs(dev, K, n_in, n_out, cin, cout)
    x, w = x.bfloat16(), (w / (K * cin) ** 0.5).bfloat16()
    f32_before, before = gather_gemm.launches, gather_gemm.bf16_launches
    got = gather_gemm(x, w, idx)
    want = gather_gemm_reference(x, w, idx)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == (n_out, cout)
    if n_out:
        assert _rel(got.float(), want.float()) <= BF16_RTOL
        assert gather_gemm.bf16_launches == before + 1 and gather_gemm.launches == f32_before
        p = gather_gemm.last_plan
        assert p.body == _bf16_body(cin, vec)
        if vec is not None:
            assert p.vec == vec


@pytest.mark.parametrize("K,n,cin,cout", [(27, 125, 256, 256), (27, 618, 384, 256)])
def test_bf16_offset_split_rounds_once(dev, K, n, cin, cout):
    """S > 1: float32 partials summed in order, then one rounding."""
    x, w, idx = _inputs(dev, K, n, n, cin, cout, density=0.4)
    x, w = x.bfloat16(), (w / (K * cin) ** 0.5).bfloat16()
    got = gather_gemm(x, w, idx)
    assert gather_gemm.last_plan.splits > 1 and gather_gemm.last_plan.body == "wgmma"
    assert _rel(got.float(), gather_gemm_reference(x, w, idx).float()) <= BF16_RTOL


def test_bf16_four_byte_copies_from_an_unaligned_view(dev):
    x, w, idx = _inputs(dev, 8, 501, 400, 8, 32)
    xv = x.bfloat16()[1:]  # 16 bytes in: 16-byte aligned, 8 bf16 per row
    flat = torch.cat([x.new_zeros(2).bfloat16(), x.bfloat16()[:500].flatten()])
    xu = flat[2:].view(500, 8)  # 4 bytes past a 16-byte boundary
    assert xu.data_ptr() % 16 != 0 and xu.data_ptr() % 4 == 0
    wb = w.bfloat16()
    for xb, vec, body in ((xv, 8, "wgmma"), (xu, 2, "mma")):
        got = gather_gemm(xb, wb, idx)
        assert gather_gemm.last_plan.vec == vec and gather_gemm.last_plan.body == body
        assert _rel(got.float(), gather_gemm_reference(xb, wb, idx).float()) <= BF16_RTOL


def test_bf16_two_launches_are_bit_equal(dev):
    for shape in [(27, 618, 618, 384, 256), (27, 5000, 5000, 96, 96), (125, 2000, 2000, 3, 32),
                  (27, 3000, 2000, 256, 1024)]:
        x, w, idx = _inputs(dev, *shape)
        x, w = x.bfloat16(), w.bfloat16()
        for body in ("simt",) if shape[3] <= 4 else ("wgmma", "mma"):
            assert torch.equal(gather_gemm(x, w, idx, body=body), gather_gemm(x, w, idx, body=body))


def test_bf16_rows_without_pairs_and_out_of_range_are_zero(dev):
    """The wgmma body: a row tile whose offsets are all -1 (every offset
    voted out), indices >= N_in (zero rows), as the float32 instance."""
    x, w, idx = _inputs(dev, 8, 100, 200, 16, 16)
    x, w = x.bfloat16(), w.bfloat16()
    idx[:, :64] = -1           # a whole tile with no pair: every offset skipped
    idx[:, 64] = 100           # outside [0, n_in): gathers zero
    idx[3, 65:70] = 1 << 30
    got = gather_gemm(x, w, idx)
    assert gather_gemm.last_plan.body == "wgmma"
    assert torch.all(got[:65] == 0)
    assert _rel(got.float(), gather_gemm_reference(x, w, idx).float()) <= BF16_RTOL


@pytest.mark.parametrize("K,n,cin,cout", [(27, 5000, 96, 96), (27, 618, 256, 256),
                                          (27, 3000, 336, 48)])
def test_bf16_mma_body_on_request_matches_the_wgmma_body(dev, K, n, cin, cout):
    """The PR 8 mma.sync body, asked for by ``body=``, on the shapes the plan
    gives the wgmma body: both within one bf16 ulp of plain."""
    x, w, idx = _inputs(dev, K, n, n, cin, cout)
    x, w = x.bfloat16(), (w / (K * cin) ** 0.5).bfloat16()
    want = gather_gemm_reference(x, w, idx).float()
    for body in ("wgmma", "mma"):
        assert _rel(gather_gemm(x, w, idx, body=body).float(), want) <= BF16_RTOL
        assert gather_gemm.last_plan.body == body
    with pytest.raises(ValueError):
        gather_gemm(x[:, :cin - 1].contiguous(), w[:, :cin - 1].contiguous(), idx, body="wgmma")


@pytest.mark.parametrize("K,cin,cout,n_in,n_out", STEP_CONVS + CLASSIFICATION_CONVS,
                         ids=STEP_IDS + CLASSIFICATION_IDS)
def test_bf16_step_convs_forward_and_input_gradient(dev, K, cin, cout, n_in, n_out):
    """Every distinct conv of a MinkUNet34 and a MinkowskiFCNN step in bf16:
    the forward on the wgmma body (the Cin = 3 stem on SIMT) and the input
    gradient on the wgmma body, each within one bf16 ulp of plain."""
    in_idx, out_idx_t = _matching(dev, K, n_in, n_out)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n_in, cin, device=dev, generator=g).bfloat16()
    w = (torch.randn(K, cin, cout, device=dev, generator=g) / (K * cin) ** 0.5).bfloat16()
    go = torch.randn(n_out, cout, device=dev, generator=g).bfloat16()
    got = gather_gemm(x, w, in_idx)
    assert gather_gemm.last_plan.body == ("simt" if cin <= 4 else "wgmma")
    assert _rel(got.float(), gather_gemm_reference(x, w, in_idx).float()) <= BF16_RTOL
    if cin > 4:  # the stem's input takes no gradient
        wt = w.transpose(1, 2).contiguous()
        got = gather_gemm(go, wt, out_idx_t)
        assert gather_gemm.last_plan.body == "wgmma"
        assert _rel(got.float(), gather_gemm_reference(go, wt, out_idx_t).float()) <= BF16_RTOL


def test_bf16_rejects_mixed_and_half(dev):
    x, w, idx = _inputs(dev, 8, 100, 200, 16, 16)
    with pytest.raises(TypeError):
        gather_gemm(x.bfloat16(), w, idx)  # the weight must be cast by the caller
    with pytest.raises(TypeError):
        gather_gemm(x.half(), w.half(), idx)
