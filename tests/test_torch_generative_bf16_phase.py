"""A CPU rehearsal of ``chip_smoke.py``'s phase 43: CompletionNet and the VAE
in bf16, each held to its own keep masks.

The phase's code runs on the CPU at a small size: 4-level nets of channels
8-16 (3 decoder levels) on shapes at a 16³ resolution.  The kernel wrappers are faked by their
plain versions, which count launches as the card's wrappers do (by dtype,
and by the body the plan picks for an H100's 132 SMs), so the phase's
launch and body checks, its flip counts, its parity judgements (the CPU's
bf16 and float64 runs held to the "card's" masks) and its per-call rows run
as on the card.  The timing (``device_ms``) needs the card and is stubbed.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.kernels import conv_dw as K2  # noqa: E402
from minkowskiengine_tpu_torch.kernels import gather_gemm as K1  # noqa: E402
from minkowskiengine_tpu_torch.ops import functional  # noqa: E402

CHANNELS = (8, 8, 16, 16)  # multiples of 8: every call but the stem's on wgmma
# sparse convs: CompletionNet's first, then two per encoder and decoder
# level; the VAE's two per encoder level and two per decoder level
COMPLETION_CONVS = 1 + 4 * (len(CHANNELS) - 1)
VAE_CONVS = 2 * len(CHANNELS) + 2 * (len(CHANNELS) - 1)
RES, SHAPES = 16, 3
SMS = 132  # an H100 SXM's


def _counting(reference, plan_of):
    """A plain version that counts launches and keeps the plan, as the
    card's wrapper does."""
    def kernel(a, b, idx, *, body=None):
        out = reference(a, b, idx)
        p = plan_of(a, b, idx, body)
        if a.dtype == torch.bfloat16:
            kernel.bf16_launches += 1
            kernel.bf16_body_launches[p.body] += 1
        else:
            kernel.launches += 1
        kernel.last_plan = p
        return out

    kernel.launches = kernel.bf16_launches = 0
    kernel.bf16_body_launches = dict.fromkeys(K2.BODIES, 0)
    kernel.last_plan = None
    kernel.__name__ = reference.__name__.replace("_reference", "")
    return kernel


@pytest.fixture(scope="module")
def phase():
    k1 = _counting(K1.gather_gemm_reference, lambda x, w, idx, body: K1.plan(
        idx.shape[1], idx.shape[0], x.shape[1], w.shape[2], SMS, True,
        x.dtype == torch.bfloat16, body))
    k2 = _counting(K2.conv_dw_reference, lambda x, g, idx, body: K2.plan(
        idx.shape[0], x.shape[1], g.shape[1], idx.shape[1], SMS, True,
        x.dtype == torch.bfloat16, body))
    calls = []

    def device_ms(fn, warmup=2, iters=10, graph=False):
        fn()
        calls.append(graph)
        return 1.0, None if graph else 10.0

    with pytest.MonkeyPatch.context() as mp:
        for owner in (cs, functional):
            mp.setattr(owner, "gather_gemm", k1)
            mp.setattr(owner, "conv_dw", k2)
        mp.setattr(cs, "device_ms", device_ms)
        for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
            mp.setattr(torch.cuda, name, lambda *a, **k: None)
        mp.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 2**30)
        mp.setattr(cs, "GEN_WIDTHS", dict(resolution=RES, in_nchannel=1, enc_channels=CHANNELS,
                                          dec_channels=CHANNELS))
        mp.setattr(cs, "VAE_WIDTHS", dict(channels=CHANNELS, in_nchannel=1, resolution=RES))
        mp.setattr(cs, "COMPLETION_CONVS", COMPLETION_CONVS)
        mp.setattr(cs, "VAE_CONVS", VAE_CONVS)
        mp.setattr(cs, "PARITY_SHAPES", 2)
        mp.setattr(cs, "PARITY_RES", RES)
        reuse = {
            "gen_batches": {s: cs.gen_batch(s, SHAPES, RES) for s in range(cs.TRAIN_STEPS)},
            "gen_float32": {"completion": [([1], 1.0)] * cs.TRAIN_STEPS,
                            "completion_peak": 2**30, "vae": [([1], 1.0, 2**30)] * 2},
        }
        launches = dict.fromkeys(cs.KERNELS, 0)
        rows = cs.generative_bf16(torch.device("cpu"), launches, reuse)
        yield rows, launches, calls


def test_the_policy_is_left_off(phase):
    assert MT.config.compute_dtype() is None


def test_main_path_launches_are_bf16_only(phase):
    """Four CompletionNet steps (49 + 25 each), two VAE steps (51 + 26) and
    two generations (26 K1 each: every sparse conv's forward)."""
    _, launches, _ = phase
    k1 = cs.TRAIN_STEPS * (2 * cs.COMPLETION_CONVS - 1) + 2 * (2 * cs.VAE_CONVS - 1) + 2 * cs.VAE_CONVS
    k2 = cs.TRAIN_STEPS * cs.COMPLETION_CONVS + 2 * cs.VAE_CONVS
    assert launches == {"gather_gemm": 0, "conv_dw": 0, "gather_gemm_bf16": k1, "conv_dw_bf16": k2}


def test_every_call_of_both_steps_has_its_row(phase):
    """Phase 43d: one row per sparse conv call of each net, each part held
    and timed, the stem's on the SIMT K1 body and K2's stem, the others on
    wgmma; the stem takes no input gradient."""
    rows, _, calls = phase
    nets = [r["net"] for r in rows]
    assert nets == ["CompletionNet"] * cs.COMPLETION_CONVS + ["VAE"] * cs.VAE_CONVS
    for r in rows:
        stem = r["cin"] == 1
        assert set(r) >= ({"fwd", "dw"} if stem else {"fwd", "dx", "dw"})
        assert ("dx" in r) != stem
        assert r["fwd"]["body"] == ("simt" if stem else "wgmma")
        assert r["dw"]["body"] == ("stem_mma" if stem else "wgmma")
        for p in ("fwd", "dx", "dw"):
            if p in r:
                assert r[p]["max_rel_err"] <= (cs.DW_RTOL if p == "dw" else cs.K1_BF16_RTOL)
                assert r[p]["bound_ms"] > 0 and "pr8_ms" not in r[p]
    # per part: the bf16 kernel and the float32 instance as launches, the plain version as a graph
    parts = sum(len([p for p in ("fwd", "dx", "dw") if p in r]) for r in rows)
    assert sorted(calls) == [False] * 2 * parts + [True] * parts
