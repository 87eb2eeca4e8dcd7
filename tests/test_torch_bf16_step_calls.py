"""What ``chip_smoke.py``'s phase 42 times, on the CPU at a small size: the
bf16 conv calls of one MinkUNet34 and one MinkowskiFCNN training step as
``bf16_step_calls`` captures them, each call's parts and bounds from
``bf16_parts``, and ``tools/bf16_step_times.py``'s refusal without a card.
The timing itself (``device_ms``) needs the card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels  # noqa: E402


@pytest.fixture(scope="module")
def steps():
    """Phase 42's inputs with 30 cm voxels and a classification batch of 4
    shapes x 512 points, so the CPU's plain path takes seconds."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "scan", lambda seed: room_scan_voxels(
            voxel_size=0.3, n_points=120_000, extent=(2.0, 2.0, 2.2), n_objects=4, seed=seed))
        mp.setattr(cs, "SHAPES", 4)
        mp.setattr(cs, "POINTS", 512)
        dev = torch.device("cpu")
        yield cs.bf16_step_calls(dev, cs.step_inputs(dev))


def test_every_conv_of_both_steps_is_captured(steps):
    import minkowskiengine_tpu_torch as MT

    assert MT.config.compute_dtype() is None  # left as it was found
    assert [len(steps[n]) for n in ("MinkUNet34", "MinkowskiFCNN")] == [cs.MIN_LAUNCHES,
                                                                       cs.FCNN_CONVS]
    for net, calls in steps.items():
        for i, (x, w, g, in_idx, out_idx_t, label, with_dx) in enumerate(calls):
            assert label == f"{'call' if net == 'MinkUNet34' else 'fcnn'}{i}"
            assert w.dtype == torch.float32 and g.dtype == torch.bfloat16
            assert x.shape[1] == w.shape[1] and g.shape[1] == w.shape[2]
            assert in_idx.shape == (w.shape[0], g.shape[0])
            assert out_idx_t.shape == (w.shape[0], x.shape[0])
            # the stem's input (the features) takes no gradient; every other does
            assert with_dx == (net != "MinkUNet34" or i > 0)


def test_parts_carry_bf16_arguments_and_the_bound(steps):
    for calls in steps.values():
        for x, w, g, in_idx, out_idx_t, label, with_dx in calls:
            parts = cs.kernel_parts(x, w, g, in_idx, out_idx_t, with_dx)
            assert set(parts) == ({"fwd", "dx", "dw"} if with_dx else {"fwd", "dw"})
            K, cin, cout = w.shape
            for p, (kernel, plain, args, args32, rtol, bound_ms, bound_by) in parts.items():
                assert all(a.dtype == torch.bfloat16 for a in args[:2])
                assert all(a.dtype == torch.float32 for a in args32[:2])
                assert rtol == (cs.DW_RTOL if p == "dw" else cs.K1_BF16_RTOL)
                assert bound_ms > 0 and bound_by in ("bytes", "operations")
            assert parts["fwd"][2][1].shape == (K, cin, cout)
            if with_dx:
                assert parts["dx"][2][1].shape == (K, cout, cin)
                assert parts["dx"][0] is cs.gather_gemm
            assert parts["dw"][0] is cs.conv_dw
    # the bound of one call by hand: 2 pairs Cin Cout over the bf16 rate,
    # or 2 bytes a feature and weight element, 4 an index
    x, w, g, in_idx, out_idx_t, _, _ = steps["MinkUNet34"][2]
    K, cin, cout = w.shape
    n_in, n_out = x.shape[0], g.shape[0]
    flop = 2 * int(((in_idx >= 0) & (in_idx < n_in)).sum()) * cin * cout
    nbytes = 2 * (n_in * cin + K * cin * cout + n_out * cout) + 4 * K * n_out
    fwd = cs.kernel_parts(x, w, g, in_idx, out_idx_t)["fwd"]
    assert fwd[5] == pytest.approx(max(flop / cs.BF16_PEAK, nbytes / cs.HBM_RATE) * 1e3)


def test_float32_parts_are_k1_alone_with_the_tf32_bound(steps):
    for calls in steps.values():
        for x, w, g, in_idx, out_idx_t, label, with_dx in calls:
            parts = cs.kernel_parts(x, w, g, in_idx, out_idx_t, with_dx, bf16=False)
            assert set(parts) == ({"fwd", "dx"} if with_dx else {"fwd"})
            for p, (kernel, plain, args, args32, rtol, bound_ms, bound_by) in parts.items():
                assert kernel is cs.gather_gemm and rtol == cs.KERNEL_RTOL
                assert all(a.dtype == torch.float32 for a in args[:2] + args32[:2])
    # the bound of one call by hand: 2 pairs Cin Cout over the TF32 rate, or
    # 4 bytes a feature, weight element and index
    x, w, g, in_idx, out_idx_t, _, _ = steps["MinkUNet34"][2]
    K, cin, cout = w.shape
    n_in, n_out = x.shape[0], g.shape[0]
    flop = 2 * int(((out_idx_t >= 0) & (out_idx_t < n_out)).sum()) * cin * cout
    nbytes = 4 * (n_out * cout + K * cin * cout + n_in * cin) + 4 * K * n_in
    dx = cs.kernel_parts(x, w, g, in_idx, out_idx_t, bf16=False)["dx"]
    assert dx[5] == pytest.approx(max(flop / cs.TF32_PEAK, nbytes / cs.HBM_RATE) * 1e3)


def test_step_times_tool_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run for real")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "bf16_step_times.py")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
