"""What ``chip_smoke.py``'s phase 45 times, on the CPU at a small size: the
batch of cropped rooms, every sparse conv call of one Point Transformer V3
training step as ``ptv3_step_calls`` captures it, each call's float32 K1
and K2 parts with their tolerances and bounds, and the body each part must
take on the card.  The timing (``device_ms``) and the launch counts need the
card."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SMALL = dict(enc_depths=(1, 1), enc_channels=(16, 32), enc_num_head=(2, 2), dec_depths=(1,),
             dec_channels=(16,), dec_num_head=(2,), patch_size=16)
CONVS = 1 + 3  # the stem and one CPE conv a block


@pytest.fixture(scope="module")
def small():
    """Phase 45 at 30 cm voxels, 300 voxels a crop and two levels."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "ROOM2CM", dict(voxel_size=0.3, n_points=20_000, extent=(4.0, 5.0, 2.5),
                                       n_objects=6))
        mp.setattr(cs, "PTV3_CROP", 300)
        mp.setattr(cs, "PTV3_CONVS", CONVS)
        batch = cs.ptv3_batch()
        yield batch, cs.ptv3_step_calls(torch.device("cpu"), batch, **SMALL)["PTv3"]


def test_batch_is_cropped_rooms_on_a_grid_from_zero(small):
    (coords, feats, labels), _ = small
    assert coords.shape[1] == 4 and feats.shape == (len(coords), 6) and len(labels) == len(coords)
    for b in range(cs.PTV3_ROOMS):
        room = coords[coords[:, 0] == b, 1:]
        assert len(room) == 300
        assert room.min(0).values.tolist() == [0, 0, 0]
        assert len(torch.unique(room, dim=0)) == len(room)


def test_every_conv_of_the_step_is_captured(small):
    _, calls = small
    assert len(calls) == CONVS
    for i, (x, w, g, in_idx, out_idx_t, label, with_dx) in enumerate(calls):
        assert label == f"ptv3{i}"
        assert x.dtype == w.dtype == g.dtype == torch.float32
        assert x.shape[1] == w.shape[1] and g.shape[1] == w.shape[2]
        assert in_idx.shape == (w.shape[0], g.shape[0])
        # the stem (5^3, 6 -> 16) takes the features, which take no gradient
        assert w.shape[0] == (125 if i == 0 else 27)
        assert with_dx == (i > 0)


def test_float32_parts_carry_k2_and_the_bodies(small):
    _, calls = small
    for x, w, g, in_idx, out_idx_t, label, with_dx in calls:
        parts = cs.kernel_parts(x, w, g, in_idx, out_idx_t, with_dx, bf16=False, with_dw=True)
        assert set(parts) == ({"fwd", "dx", "dw"} if with_dx else {"fwd", "dw"})
        for p, (kernel, plain, args, args32, rtol, bound_ms, bound_by) in parts.items():
            assert all(a.dtype == torch.float32 for a in args[:2])
            assert (kernel, rtol) == ((cs.conv_dw, cs.DW_RTOL) if p == "dw"
                                      else (cs.gather_gemm, cs.KERNEL_RTOL))
            assert bound_ms > 0 and bound_by in ("bytes", "operations")
            # plain on the CPU is what the kernel's CPU path runs
            torch.testing.assert_close(kernel(*args), plain(*args), rtol=0, atol=0)
    # the stem's forward on the mma.sync body (Cin 6), every other K1 part on
    # wgmma_3xtf32, every K2 part on the float32 mma.sync body
    stem = cs.kernel_parts(*calls[0][:5], False, bf16=False, with_dw=True)
    assert cs.expected_body(cs.gather_gemm, 6, 16, False) == "mma"
    assert cs.expected_body(cs.conv_dw, 6, 16, False) == "mma"
    assert stem["fwd"][2][1].shape[1:] == (6, 16)
    assert cs.expected_body(cs.gather_gemm, 32, 32, False) == "wgmma_3xtf32"
    assert cs.expected_body(cs.gather_gemm, 3, 32, False) == "simt"
    assert cs.expected_body(cs.conv_dw, 3, 32, False) == "simt"
    assert cs.expected_body(cs.conv_dw, 3, 32, True) == "stem_mma"
    assert cs.expected_body(cs.conv_dw, 32, 32, True) == "wgmma"
    assert cs.PTV3_K1_BODIES == {"wgmma_3xtf32": 44, "mma": 1}
    # K2's float32 bound by hand: 2 pairs Cin Cout over the TF32 rate, or
    # 4 bytes a feature, index and dW element
    x, w, g, in_idx, out_idx_t, _, _ = calls[1]
    K, cin, cout = w.shape
    n_in, n_out = x.shape[0], g.shape[0]
    flop = 2 * int(((in_idx >= 0) & (in_idx < n_in)).sum()) * cin * cout
    nbytes = 4 * (n_in * cin + n_out * cout) + 4 * K * n_out + 4 * K * cin * cout
    dw = cs.kernel_parts(x, w, g, in_idx, out_idx_t, bf16=False, with_dw=True)["dw"]
    assert dw[5] == pytest.approx(max(flop / cs.TF32_PEAK, nbytes / cs.HBM_RATE) * 1e3)


@pytest.fixture(scope="module")
def attention_calls(small):
    """Phase 46's calls of the same small step."""
    (batch, _) = small
    return cs.ptv3_attention_calls(torch.device("cpu"), batch, **SMALL)


def test_every_attention_call_of_the_step_is_captured(attention_calls):
    blocks = sum(SMALL["enc_depths"]) + sum(SMALL["dec_depths"])
    assert len(attention_calls) == blocks
    for label, qkv, plan, heads, scale, dout in attention_calls:
        c = qkv.shape[1] // 3
        assert qkv.dtype == torch.float32 and dout.shape == (qkv.shape[0], c)
        assert scale == pytest.approx((c // heads) ** -0.5)
        assert int(plan.bounds[-1]) == plan.rows.numel() == plan.kernel_rows.numel()


def test_each_attention_call_is_held_and_timed(attention_calls, monkeypatch):
    """``attention_row`` with the card's parts stood in for: the kernel's
    launches by the plain versions (what the CPU runs), the timings by one
    call each."""
    from minkowskiengine_tpu_torch.kernels import attention as A

    timed = []
    monkeypatch.setattr(cs, "device_ms", lambda fn, graph=False: (timed.append(fn()), (1.0, None))[1])
    monkeypatch.setattr(cs, "sdpa_ms", lambda *args: (2.0, 3.0))
    monkeypatch.setattr(A, "_launch_forward", A.attention_forward_reference)
    monkeypatch.setattr(A, "_launch_backward", A.attention_backward_reference)
    for call in attention_calls:
        row = cs.attention_row(*call)
        assert row["err"] <= cs.ATTN_RTOL and row["bound_ms"] > 0
        assert (row["ms"], row["library_ms"], row["library_bwd_ms"]) == (1.0, 2.0, 3.0)
    assert len(timed) == 4 * len(attention_calls)
