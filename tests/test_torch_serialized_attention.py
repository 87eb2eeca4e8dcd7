"""Serialized attention's plain version and its autograd Function, on the CPU.

The plain windowed attention (``kernels/attention.py``, what the CPU runs
in place of the card's kernel) against a float64 ``softmax(Q Kᵀ · scale)
V`` taken window by window from the packed ``qkv`` rows: full windows, a
scene's shifted last window, short windows of 1, 7 and K − 1 rows (and one
of exactly K), 2 and 4 heads.  The Function's gradients against
``torch.autograd`` of that reference and by ``gradcheck`` in float64; the
window plan's kernel fields; the kernel wrapper's argument checks (run on
the check itself, no card needed); the benchmark's reader of the kernels'
device time.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.kernels import attention as A
from minkowskiengine_tpu_torch.nn.serialized import serialized_attention

ROOT = Path(__file__).resolve().parents[1]
K = 16
# 3 full windows, 3 with a shifted last (37 rows), short windows of 1, 7, K - 1 and K
SIZES = (48, 37, 1, 7, K - 1, K)


def scenes_plan(sizes, k, curve="hilbert", seed=0):
    rng = np.random.default_rng(seed)
    coords = []
    for b, n in enumerate(sizes):
        side = max(4, int(np.ceil((4 * n) ** (1 / 3))))
        g = np.stack(np.unravel_index(rng.permutation(side ** 3)[:n], (side,) * 3), 1)
        coords.append(np.concatenate([np.full((n, 1), b), g], 1))
    mgr = MT.CoordinateManager(D=3, device="cpu")
    key, _ = mgr.insert_and_map(torch.from_numpy(np.concatenate(coords).astype(np.int32)), 1)
    return mgr.window_plan(key, curve, k), sum(sizes)


def windows(plan):
    """Each window's places in ``plan.rows``."""
    k = plan.patch_size
    out = [range(w * k, (w + 1) * k) for w in range(plan.n_full)]
    first = plan.n_full * k
    for n in plan.short:
        out.append(range(first, first + n))
        first += n
    return out


def reference(qkv, plan, heads, scale):
    """softmax(scale · Q Kᵀ) V in each window, from the packed rows, each map
    row's output from the window place ``plan.select`` names."""
    c = qkv.shape[1] // 3
    d = c // heads
    placed = qkv.new_zeros(plan.rows.numel(), c)
    for places in windows(plan):
        idx = torch.tensor(list(places))
        rows = qkv[plan.rows[idx]]
        for h in range(heads):
            q, k, v = (rows[:, s * c + h * d: s * c + (h + 1) * d] for s in range(3))
            placed[idx, h * d:(h + 1) * d] = torch.softmax(q @ k.T * scale, 1) @ v
    return placed[plan.select]


@pytest.mark.parametrize("heads", [2, 4])
def test_the_plain_attention_matches_float64_windows(heads):
    plan, n = scenes_plan(SIZES, K)
    assert plan.n_full == 6 and plan.short == (1, 7, K - 1, K)
    d = 16
    qkv = torch.randn(n, 3 * heads * d, generator=torch.Generator().manual_seed(heads))
    want = reference(qkv.double(), plan, heads, d ** -0.5)
    got32 = A.attention(qkv, plan, heads, d ** -0.5)
    got64 = serialized_attention(qkv.double(), plan, heads, d ** -0.5)
    assert float((got32.double() - want).abs().max() / want.abs().max()) < 1e-6
    assert float((got64 - want).abs().max()) < 1e-12


def test_the_functions_gradients_match_autograd_of_the_reference():
    plan, n = scenes_plan(SIZES, K, curve="z")
    heads, d = 2, 4
    qkv = torch.randn(n, 3 * heads * d, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(5))
    g = torch.randn(n, heads * d, dtype=torch.float64, generator=torch.Generator().manual_seed(6))
    x, y = qkv.clone().requires_grad_(True), qkv.clone().requires_grad_(True)
    A.attention(x, plan, heads, 0.7).backward(g)
    reference(y, plan, heads, 0.7).backward(g)
    assert float((x.grad - y.grad).abs().max()) < 1e-12
    # rows in two windows (the shifted last) take their gradient from the owner alone
    assert bool((plan.kernel_rows < 0).any())


def test_gradcheck_in_float64():
    plan, n = scenes_plan((13, 1, 5), 8)
    assert plan.n_full == 2 and plan.short == (1, 5)
    qkv = torch.randn(n, 3 * 2 * 2, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(7)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: A.attention(t, plan, 2, 0.6), (qkv,))


def test_the_plan_gives_the_kernel_its_windows_and_owners():
    plan, n = scenes_plan(SIZES, K)
    bounds = plan.bounds.tolist()
    assert plan.bounds.dtype == plan.kernel_rows.dtype == torch.int32
    assert [b - a for a, b in zip(bounds, bounds[1:])] == [K] * plan.n_full + list(plan.short)
    places = torch.arange(plan.rows.numel())
    owns = plan.select[plan.rows] == places
    assert torch.equal(plan.kernel_rows >= 0, owns)
    assert torch.equal(torch.where(owns, plan.kernel_rows, ~plan.kernel_rows).long(), plan.rows)
    assert int(owns.sum()) == n  # every map row is owned once


def test_the_kernel_checks_refuse_what_it_does_not_take():
    for d in (16, 32, 64):
        assert A.check(torch.zeros(10, 3 * 2 * d), 2) == d
    for d in (8, 24, 128):
        with pytest.raises(ValueError, match="head widths"):
            A.check(torch.zeros(10, 3 * 2 * d), 2)
    with pytest.raises(ValueError, match="contiguous"):
        A.check(torch.zeros(96, 10).T, 2)
    with pytest.raises(TypeError):
        A.check(torch.zeros(10, 96, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="heads"):
        A.check(torch.zeros(10, 100), 2)


def test_cpu_calls_count_no_launch():
    plan, n = scenes_plan((20, 3), 8)
    before = (A.attention.fwd_launches, A.attention.bwd_launches)
    x = torch.randn(n, 3 * 32, requires_grad=True)
    A.attention(x, plan, 2, 0.25).sum().backward()
    assert (A.attention.fwd_launches, A.attention.bwd_launches) == before


def test_the_benchmark_reads_the_kernels_device_time():
    path = ROOT / "portbench" / "metrics" / "attn_kernel_ms.train.py"
    spec = importlib.util.spec_from_file_location("attn_kernel_ms_train", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fwd = ["void (anonymous namespace)::attention_fwd_3xtf32_kernel<16>(float const*, ...)", 0.03]
    bwd = ["void (anonymous namespace)::attention_bwd_3xtf32_kernel<16>(float const*, ...)", 0.08]
    delta = ["void (anonymous namespace)::attention_bwd_delta_kernel<16>(float const*, ...)", 0.003]
    other = [[f"kernel{i}", 0.01] for i in range(7)]
    summary = dict(role="train", profiled_steps=3, breakdown={"device_ops": [bwd, fwd, delta] + other})
    assert module.read(summary) == pytest.approx(1e3 * 0.113 / 3)
    # a full list that lacks the backward: the part cut away is unknown
    summary["breakdown"] = {"device_ops": [fwd] + other + [["kernel7", 0.01], ["kernel8", 0.01]]}
    assert module.read(summary) is None
    # a list shorter than the cut holds every operation
    summary["breakdown"] = {"device_ops": [fwd] + other[:3]}
    assert module.read(summary) == pytest.approx(10.0)
    # PyTorch's attention kernels (a program without these kernels) read nothing
    summary["breakdown"] = {"device_ops": [["fmha_cutlassF_f32_aligned_64x64_rf_sm80", 0.2],
                                           ["fmha_cutlassB_f32_aligned_64x64_k32_sm80", 0.4]]}
    assert module.read(summary) is None
    assert module.read(dict(summary, role="infer")) is None
