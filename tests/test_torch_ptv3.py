"""Point Transformer V3 on the port against ``plain_ptv3.py``.

CPU: the curve codes against their definitions (Morton's bit layout, the
Hilbert curve's bijection and unit steps, the nesting that makes a pooled
level's code the finer code shifted right by 3, and the bit-array encoder
Pointcept vendors); the window plan on scenes of fewer rows than a window,
exactly one, several whole windows and a remainder; a small model's
logits, loss and every parameter's gradient against the plain reference,
and the same tolerances failing a reference whose products are rounded to
TF32; the published model's parameter count.

Card (marked ``cuda``; skips where no card is visible, decided inside the
test): one float32 training step at the published widths on three 2 cm
rooms cropped to 102,400 voxels runs every attention call on the port's
attention kernel (one forward and one backward launch a block, no
PyTorch attention), and every synchronizing CUDA call of the step lies
in an ``me.sync.*`` span, as many as the ``sync.*`` counters count.
"""

import json
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT
import plain_ptv3 as plain
from minkowskiengine_tpu_torch.coords.serialize import CURVES, hilbert_code, morton_code
from minkowskiengine_tpu_torch.kernels.attention import attention
from minkowskiengine_tpu_torch.utils import profiling as P
from minkowskiengine_tpu_torch.utils.datasets import make_room_scan
from test_torch_tracing import SYNC_CALLS, sync_counts, trace_events

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(in_channels=6, out_channels=20, enc_depths=(1, 1, 1, 1, 1),
             enc_channels=(16, 16, 32, 32, 64), enc_num_head=(1, 1, 2, 2, 4),
             dec_depths=(1, 1, 1, 1), dec_channels=(16, 16, 32, 32), dec_num_head=(1, 1, 2, 2),
             patch_size=16, mlp_ratio=4)


def cells(depth, n=None, seed=0):
    """Every cell of the cube of side 2**depth, or ``n`` random ones."""
    side = 1 << depth
    if n is None:
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    else:
        g = np.random.default_rng(seed).integers(0, side, (n, 3))
    return torch.from_numpy(g.astype(np.int64))


def test_morton_codes_follow_the_bit_definition():
    g = cells(10, 500)
    want = [sum(((int(x) >> i) & 1) << (3 * i + 2) | ((int(y) >> i) & 1) << (3 * i + 1)
                | ((int(z) >> i) & 1) << (3 * i) for i in range(10)) for x, y, z in g]
    assert morton_code(g, 10).tolist() == want


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_hilbert_codes_are_a_bijection_with_unit_steps(depth):
    g = cells(depth)
    code = hilbert_code(g, depth)
    assert sorted(code.tolist()) == list(range(8 ** depth))
    walk = g[torch.argsort(code)]
    assert bool(((walk[1:] - walk[:-1]).abs().sum(1) == 1).all())


@pytest.mark.parametrize("curve", CURVES)
def test_a_coarser_code_is_the_finer_code_shifted(curve):
    from minkowskiengine_tpu_torch.coords.serialize import curve_code

    for depth in (2, 5, 9):
        g = cells(depth, 2000, seed=depth)
        assert torch.equal(curve_code(g, depth, curve) >> 3, curve_code(g >> 1, depth - 1, curve))


def test_hilbert_codes_match_the_bit_array_encoder():
    for depth in (1, 4, 8, 16):
        g = cells(depth, 3000, seed=depth)
        assert torch.equal(hilbert_code(g, depth), plain.hilbert(g, depth))


def scenes(sizes, seed=0):
    """Batch-first coordinates of scenes of the given numbers of distinct cells."""
    rng = np.random.default_rng(seed)
    rows = []
    for b, n in enumerate(sizes):
        flat = rng.choice(16 ** 3, n, replace=False)
        xyz = np.stack([flat // 256, flat // 16 % 16, flat % 16], 1)
        rows.append(np.concatenate([np.full((n, 1), b), xyz], 1))
    return torch.from_numpy(np.concatenate(rows).astype(np.int32))


@pytest.mark.parametrize("curve", CURVES)
def test_the_window_plan_holds_every_case(curve):
    K = 16
    sizes = (5, 16, 48, 37, 0, 17)  # n < K, n = K, n = 3K, n % K != 0, an empty scene, n = K + 1
    coords = scenes(sizes)
    mgr = MT.CoordinateManager(D=3, device="cpu")
    key, _ = mgr.insert_and_map(coords, 1)
    plan = mgr.window_plan(key, curve, K)
    m = mgr.get_coordinate_map(key)
    (ser,) = mgr.serialize(key, (curve,))
    depth = int(m.coordinates[:, 1:].max()).bit_length()
    assert torch.equal(ser.order, torch.argsort(plain.encode(m.coordinates, depth, curve)))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    full, short, owner = plain.window_plan(ser.order, offsets, K)
    assert plan.n_full == 3 + 3 + 2 and plan.short == (5, 16)
    assert torch.equal(plan.rows, torch.from_numpy(np.concatenate([full.reshape(-1), *short])))
    assert torch.equal(plan.select, torch.from_numpy(owner))
    # the remainder scene's windows are 3-5 (after the 48-row scene's 0-2): the last holds its
    # last K rows, and row 21, in windows 4 and 5, reads the first
    scene = ser.order[offsets[3]:offsets[4]]
    assert torch.equal(plan.rows[5 * K:6 * K], scene[37 - K:])
    assert int(plan.select[scene[37 - K]]) == 4 * K + 37 - 2 * K
    assert sorted(plan.select.tolist()) == sorted(set(plan.select.tolist()))


def small_batch():
    """Two scenes: an 8 × 8 slab (4 windows of 16, then exactly one window
    and fewer rows than one at the pooled levels) and 37 random cells (a
    remainder)."""
    a = np.stack(np.meshgrid(np.arange(8), np.arange(8), [3], indexing="ij"), -1).reshape(-1, 3)
    b = np.unique(np.random.default_rng(1).integers(0, 8, (80, 3)), axis=0)[:37]
    coords = np.concatenate([np.c_[np.zeros(len(a)), a], np.c_[np.ones(len(b)), b]])
    coords = torch.from_numpy(coords.astype(np.int32))
    feats = torch.randn(len(coords), 6, generator=torch.Generator().manual_seed(2))
    labels = torch.randint(0, 20, (len(coords),), generator=torch.Generator().manual_seed(3))
    return coords, feats, labels


ORDERS = [[0, 1, 2, 3], [2, 3, 0, 1], [1, 0, 3, 2], [3, 2, 1, 0], [0, 2, 1, 3]]


def port_step(params, coords, feats, labels, orders):
    model = MT.models.PointTransformerV3(**SMALL, device="cpu").train()
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    x = MT.SparseTensor(feats, coords, device="cpu")
    out = model(x, orders)
    loss = torch.nn.functional.cross_entropy(out.F, labels.index_select(0, x.unique_index))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return x.C, out.F.detach(), loss.detach(), grads, x.coordinate_manager


def plain_step(params, coords, feats, labels, orders, precision):
    p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    logits, base = plain.forward(SMALL, p, coords, feats, orders, True, precision)
    inv = plain.unique(coords)[2]
    loss = torch.nn.functional.cross_entropy(logits.index_select(0, inv), labels)
    loss.backward()
    return base, logits.detach(), loss.detach(), {n: t.grad for n, t in p.items()}


# Tolerances.  Both sides are float32 and compute the same sums in other
# orders (K1's plain version, the math attention path's split scale, the
# norms' reductions); on these inputs the port lies 9e-6 from the reference
# in the logits (relative to their largest entry), 7e-8 in the loss and
# 3.4e-4 in the worst gradient leaf, each leaf's largest difference taken
# relative to the larger of its own largest entry and the median leaf's: a
# bias that a batch norm follows has a gradient of round-off alone.
# Products with TF32 operands move them by 2.8e-3, 6.1e-5 and 0.39.
TOL = {"logits": 1e-4, "loss": 2e-6, "grad": 2e-3}


def gaps(port, ref):
    (c_p, l_p, loss_p, g_p), (c_r, l_r, loss_r, g_r) = port, ref
    order = torch.argsort(plain.pack(c_p))  # the port's row of each reference row:
    rows = order[torch.searchsorted(plain.pack(c_p)[order], plain.pack(c_r))]
    out = {"logits": float((l_p[rows] - l_r).abs().max() / l_r.abs().max()),
           "loss": float((loss_p - loss_r).abs() / loss_r.abs())}
    floor = torch.stack([g.abs().max() for g in g_r.values()]).median()
    out["grad"] = max(float((g_p[n] - g_r[n]).abs().max() / torch.maximum(g_r[n].abs().max(), floor))
                      for n in g_r)
    return out


@pytest.fixture(scope="module")
def small_runs():
    coords, feats, labels = small_batch()
    params = plain.make_params(SMALL, 4)
    port = port_step(params, coords, feats, labels, ORDERS)
    refs = {prec: plain_step(params, coords, feats, labels, ORDERS, prec)
            for prec in ("float32", "tf32")}
    return port, refs


def test_the_small_model_holds_every_window_case(small_runs):
    mgr = small_runs[0][4]
    cases = set()
    for (_, _, K), plan in mgr._window_plans.items():
        cases |= {"n < K" for n in plan.short if n < K} | {"n = K" for n in plan.short if n == K}
    for k, (offsets, host, _) in mgr._scene_offsets.items():
        for n in np.diff(host):
            if n > 16:
                cases.add("n = mK" if n % 16 == 0 else "n % K != 0")
    assert cases == {"n < K", "n = K", "n = mK", "n % K != 0"}


def test_the_port_matches_the_plain_reference(small_runs):
    port, refs = small_runs
    got = gaps(port[:4], refs["float32"])
    assert all(got[k] <= TOL[k] for k in TOL), got


def test_tf32_products_fail_the_tolerances(small_runs):
    port, refs = small_runs
    got = gaps(port[:4], refs["tf32"])
    assert any(got[k] > TOL[k] for k in TOL), got


def test_the_published_model_has_the_configurations_parameters():
    cfg = json.loads((ROOT / "portbench" / "configs" / "ptv3.json").read_text())
    model = MT.models.PointTransformerV3(device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"] == 46_167_572
    assert shapes == {n: tuple(s) for n, s, _ in plain.parameter_spec(cfg)}


def cell_step(dev):
    """One SGD step of the published model on three 2 cm rooms cropped to
    102,400 voxels each, the benchmark cell's size."""
    coords, feats = [], []
    for b in range(3):
        vox = np.unique(np.floor(make_room_scan(n_points=200_000, seed=200 + b) / 0.02)
                        .astype(np.int32), axis=0)
        vox -= vox.min(0)
        d = ((vox - vox[len(vox) // 2]).astype(np.int64) ** 2).sum(1)
        keep = np.sort(np.argsort(d, kind="stable")[:102_400])
        coords.append(np.concatenate([np.full((len(keep), 1), b, np.int32), vox[keep]], 1))
        feats.append(np.random.RandomState(b).randn(len(keep), 6).astype(np.float32))
    coords = torch.from_numpy(np.concatenate(coords)).to(dev)
    feats = torch.from_numpy(np.concatenate(feats)).to(dev)
    labels = torch.randint(0, 20, (len(coords),), generator=torch.Generator().manual_seed(0)).to(dev)
    model = MT.models.PointTransformerV3(generator=torch.Generator().manual_seed(0),
                                         device=dev).train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01)

    def step():
        x = MT.SparseTensor(feats, coords, device=dev)
        out = model(x, ORDERS).F
        loss = torch.nn.functional.cross_entropy(out, labels.index_select(0, x.unique_index))
        opt.zero_grad()
        loss.backward()
        opt.step()

    return step


@pytest.mark.cuda
def test_a_card_step_runs_memory_efficient_attention_and_counts_its_syncs(tmp_path):
    """The step's attention runs on the port's kernel alone: 22 forward and 22
    backward launches (14 encoder and 8 decoder blocks), by its counters and
    in the trace, and no kernel or call of PyTorch's attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    step = cell_step(dev)
    step()
    step()  # kernels built, plans and allocator warm
    lines = Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]  # this frame left out
                    if "minkowskiengine_tpu_torch" in f.filename or "test_torch_ptv3" in f.filename]
            lines[f"{ours[-1].filename.split('/')[-1]}:{ours[-1].lineno}" if ours
                  else f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        saved, warnings.showwarning = warnings.showwarning, note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = saved
    torch.cuda.synchronize()
    before = P.counters()
    launches = (attention.fwd_launches, attention.bwd_launches)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(tmp_path)),
    ):
        with torch.profiler.record_function("test.step"):
            step()
        counted_syncs = sync_counts(before, P.counters())
        torch.cuda.synchronize()
    counted = (attention.fwd_launches - launches[0], attention.bwd_launches - launches[1])
    xs = trace_events(tmp_path)
    host = [e for e in xs if e.get("cat") != "gpu_user_annotation"]
    (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == "test.step"]
    kernels = Counter(e["name"] for e in xs if e.get("cat") == "kernel")
    fwd = sum(n for k, n in kernels.items() if "attention_fwd_3xtf32_kernel" in k)
    bwd = sum(n for k, n in kernels.items() if "attention_bwd_3xtf32_kernel" in k)
    library = [k for k in kernels if k.startswith("fmha_") or "flash" in k.lower()]
    sdpa = [e["name"] for e in host if "scaled_dot_product" in e["name"]
            or "efficient_attention" in e["name"]]
    print(f"\nattention launches {counted}; kernels forward {fwd}, backward {bwd}; "
          f"syncs {counted_syncs}; synchronizing lines {dict(lines)}")
    assert counted == (22, 22) and (fwd, bwd) == (22, 22), (counted, fwd, bwd)
    assert not library and not sdpa, (library, sdpa[:3])
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in host
             if e["name"].startswith("me.sync.")]
    syncs = [e for e in host if e.get("cat") == "cuda_runtime" and e["name"] in SYNC_CALLS
             and lo <= e["ts"] <= hi]
    outside = [e for e in syncs if not any(t == e["tid"] and a <= e["ts"] <= b
                                           for t, a, b in spans)]
    assert not outside, [(e["name"], e["ts"]) for e in outside]
    assert len(syncs) == sum(counted_syncs.values())
    assert counted_syncs["sync.serialize.offsets"] == 5  # one a level
