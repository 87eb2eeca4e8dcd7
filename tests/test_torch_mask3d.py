"""Mask3D on the port against ``plain_mask3d.py``.

CPU, on seeded random weights at the published widths but 16 queries and
sample sizes (4, 16, 64, 256), two rooms at 10 cm (about 4,000 voxels
each, so that every level's scene is larger than its sample): the FPS rows,
the pooled level coordinates and their Fourier encodings, the attention
masks; the Hungarian assignment against brute force; each of the 13
predictions' class and mask logits, the loss and every parameter's
gradient against the plain reference held to the port's decisions, and
the same tolerances failing a reference whose products are rounded to
TF32; the published model's parameter count; and that ``MinkUNet34``'s
forward is its levels' last through its classifier, call for call.

Card (marked ``cuda``; skips where no card is visible, decided inside the
test): one float32 training step at the published widths on two 2 cm
rooms holds every synchronizing CUDA call in an ``me.sync.*`` span, as
many as the ``sync.*`` counters count, 13 of them ``sync.match.costs``,
and the ``me.mask3d.*`` spans nested as listed.
"""

import itertools
import json
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT
import plain_mask3d as plain
from minkowskiengine_tpu_torch.models.mask3d import HungarianMatcher
from minkowskiengine_tpu_torch.utils import profiling as P
from minkowskiengine_tpu_torch.utils.datasets import make_room_scan
from test_torch_tracing import SYNC_CALLS, sync_counts, trace_events

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench" / "configs" / "mask3d.json").read_text())
QUERIES, SAMPLES = 16, (4, 16, 64, 256)
# Float32 on both sides differs by the order of sums alone (the port's
# batched one-hot reductions and pooling slots against per-scene sums):
# ~1e-6 of the largest value on these rooms.  TF32 products move the same
# numbers by 1e-4 to 1e-2, so the tolerances sit between, with room on both
# sides.
# On one thread: logits 1.3e-6 against TF32's 8.9e-3, the loss 7.9e-8
# against 1.7e-5, the worst gradient leaf 2.5e-6 against 0.48.
LOGIT_TOL = 1e-4  # largest |Δ| over the reference's largest |logit|
LOSS_TOL = 1e-6  # relative
GRAD_TOL = 2e-3  # per leaf, largest |Δ| over the leaf's largest |gradient|


def config():
    return dict(CFG, num_queries=QUERIES, sample_sizes=list(SAMPLES) + [CFG["sample_sizes"][-1]])


def rooms(n=2, voxel=0.1, n_points=20_000, extent=(3.0, 3.0, 2.5)):
    """(coordinates (N, 4) int32, colours, raw coordinates, each row's box
    or -1, the boxes' classes and scenes) of ``n`` rooms, row-unique."""
    coords, feats, raw, inst, labels, scenes = [], [], [], [], [], []
    for b in range(n):
        pts = make_room_scan(n_points, extent=extent, n_objects=3, seed=b)
        vox, first = np.unique(np.floor(pts / voxel).astype(np.int32), axis=0, return_index=True)
        coords.append(np.concatenate([np.full((len(vox), 1), b, np.int32), vox], 1))
        feats.append(np.random.RandomState(b).rand(len(vox), 3).astype(np.float32) - 0.5)
        raw.append(pts[first])
        # three "instances" a room: boxes of space, as the synthetic rooms have
        lo = vox.min(0)
        cell = (vox - lo) // np.maximum((vox.max(0) - lo) // 2 + 1, 1)
        which = cell[:, 0] + 2 * cell[:, 1]
        box = np.where(which < 3, len(labels) + which, -1)
        inst.append(box)
        labels.extend([3 * b + 1, 5, 17])
        scenes.extend([b] * 3)
    return (torch.from_numpy(np.concatenate(coords)), torch.from_numpy(np.concatenate(feats)),
            torch.from_numpy(np.concatenate(raw)), torch.from_numpy(np.concatenate(inst)),
            torch.tensor(labels), scenes)


def port_model(cfg):
    return MT.models.Mask3D(
        cfg["in_channels"], cfg["num_targets"], D=3, out_channels=cfg["out_channels"],
        num_queries=cfg["num_queries"], sample_sizes=cfg["sample_sizes"][:4],
        generator=torch.Generator().manual_seed(0), device="cpu").train()


def port_step(cfg, batch):
    coords, feats, raw, inst, labels, scenes = batch
    model = port_model(cfg)
    state = {n: t.detach().clone() for n, t in model.named_parameters()}
    gauss = model.decoder.pos_enc.gauss_B.clone()
    x = MT.SparseTensor(feats, coords, device="cpu")
    rows = x.unique_index.long()
    out = model(x, raw[rows], torch.Generator().manual_seed(1))
    crit = MT.models.SetCriterion(cfg["num_targets"], cfg["eos_coef"], device="cpu")
    loss, assign = crit(out, MT.models.InstanceTargets(inst[rows], labels, scenes))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return dict(model=model, x=x, out=out, loss=float(loss.detach()), assign=assign,
                grads=grads, state=state, gauss=gauss)


def plain_step(cfg, batch, port, precision):
    coords, feats, raw, inst, labels, scenes = batch
    out = port["out"]
    held = {"fps": out["fps"], "attn": out["attn_masks"], "samples": out["samples"]}
    p = {n: t.clone().requires_grad_(True) for n, t in port["state"].items()}
    state = dict(p, **plain.buffers(cfg, "cpu"))
    state["decoder.pos_enc.gauss_B"] = port["gauss"]
    rec = plain.forward(cfg, state, coords, feats, raw, held, precision=precision)
    loss, taken, margin = plain.criterion(cfg, rec, inst, labels, scenes, port["assign"],
                                          precision)
    loss.backward()
    grads = {n: t.grad for n, t in p.items() if t.grad is not None}
    return dict(rec=rec, loss=float(loss.detach()), margin=margin, grads=grads)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The file's CPU runs on one torch thread: inside a loaded multi-worker
    test run, torch's thread pool spinning against the other workers' cost
    the published-width step 60x its time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    torch.manual_seed(0)
    cfg, batch = config(), rooms()
    port = port_step(cfg, batch)
    return cfg, batch, port, plain_step(cfg, batch, port, "float32"), \
        plain_step(cfg, batch, port, "tf32")


def gaps(port, ref):
    out = port["out"]
    preds = [(p["pred_logits"], p["pred_masks"]) for p in out["aux_outputs"]]
    preds.append((out["pred_logits"], out["pred_masks"]))
    logit = max(float((a.detach() - b.detach()).abs().max() / b.detach().abs().max())
                for pr, rf in zip(preds, ref["rec"]["predictions"]) for a, b in zip(pr, rf))
    grad = max(float((port["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
               for n, g in ref["grads"].items())
    return dict(logit=logit, loss=abs(port["loss"] - ref["loss"]) / abs(ref["loss"]), grad=grad)


def test_the_decisions_match_the_plain_ones(runs):
    cfg, _, port, ref, _ = runs
    rec = ref["rec"]
    assert port["x"].C.tolist() == rec["coords"].tolist()  # the same rows in the same order
    assert rec["fps_mismatch"] == 0
    # a mask flips only where the reference's pooled logit lies at rounding's distance of 0
    assert rec["attn_flip_margin"] <= 1e-4, rec["attn_flip_margin"]
    assert ref["margin"] <= 1e-5, ref["margin"]  # the port's assignment is the reference's optimum
    assert len(port["assign"]) == 13 and len(rec["decisions"]["attn"]) == 12
    big = [rows.shape[1] for rows, _ in port["out"]["samples"][:4]]
    assert big == list(SAMPLES)
    assert not any(bool(pad.any()) for _, pad in port["out"]["samples"])  # every scene sampled


def test_the_level_coordinates_and_encodings_match(runs):
    cfg, batch, port, ref, _ = runs
    x, model = port["x"], port["model"]
    raw = batch[2][x.unique_index.long()]
    t = MT.SparseTensor(raw, coordinate_map_key=x.coordinate_map_key,
                        coordinate_manager=x.coordinate_manager)
    levels = list(model.backbone.feature_levels(x))
    maps = plain.Maps(plain.Map(*plain.unique(batch[0])[:2], 1))
    want = torch.empty_like(batch[2]).index_copy_(0, plain.unique(batch[0])[2], batch[2])
    gauss = port["gauss"]
    for s in range(4):
        t = model.decoder.pooling(t)
        want = plain.avg_pool(want, maps.at(2 ** s), maps.at(2 ** (s + 1)))
        assert t.coordinate_map_key == levels[3 - s].coordinate_map_key
        torch.testing.assert_close(t.F, want, rtol=1e-6, atol=1e-6)
        lo, hi = want.amin(0), want.amax(0)
        torch.testing.assert_close(model.decoder.pos_enc(t.F, lo, hi),
                                   plain.fourier(want, lo, hi, gauss), rtol=1e-5, atol=1e-5)


def test_the_port_matches_the_plain_reference(runs):
    g = gaps(runs[2], runs[3])
    assert g["logit"] < LOGIT_TOL and g["loss"] < LOSS_TOL and g["grad"] < GRAD_TOL, g


def test_tf32_products_fail_the_tolerances(runs):
    g = gaps(runs[2], runs[4])
    assert g["logit"] > LOGIT_TOL and g["loss"] > LOSS_TOL and g["grad"] > GRAD_TOL, g


@pytest.mark.parametrize("shape", [(5, 3), (6, 6), (8, 2), (7, 4)])
def test_the_matcher_finds_the_least_cost_assignment(shape):
    """Brute force over every injection of the targets into the queries."""
    q, t = shape
    cost = torch.rand((t, q), generator=torch.Generator().manual_seed(q * 10 + t))
    (rows, cols), = HungarianMatcher()(cost, [0] * t, 1)
    c = cost.T.numpy().astype(np.float64)
    best = min(sum(c[p, j] for j, p in enumerate(perm))
               for perm in itertools.permutations(range(q), t))
    assert sorted(cols.tolist()) == list(range(t))
    assert c[rows, cols].sum() == pytest.approx(best, abs=1e-9)


def test_the_matcher_splits_the_scenes():
    cost = torch.rand((5, 4), generator=torch.Generator().manual_seed(3))
    out = HungarianMatcher()(cost, [1, 0, 1, 1, 0], 3)
    assert [sorted(t.tolist()) for _, t in out] == [[1, 4], [0, 2, 3], []]


def test_the_published_model_has_the_configurations_parameters():
    model = MT.models.Mask3D(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == CFG["parameters"] == 39_616_583
    assert sum(p.numel() for n, p in model.named_parameters() if n.startswith("backbone.")) \
        == 37_856_052
    spec = plain.parameter_spec(CFG)
    assert {n: tuple(s) for n, s, _ in spec} == {n: tuple(p.shape)
                                                for n, p in model.named_parameters()}


class Narrow(MT.models.MinkUNet34):
    PLANES, INIT_DIM = (8, 16, 16, 16, 16, 16, 8, 8), 8


def old_forward(net, x):
    """``MinkUNetBase.forward`` as it was before it read ``feature_levels``."""
    relu, cat = net.relu, MT.cat
    out_p1 = relu(net.bn0(net.conv0p1s1(x)))
    out_b1p2 = net.block1(relu(net.bn1(net.conv1p1s2(out_p1))))
    out_b2p4 = net.block2(relu(net.bn2(net.conv2p2s2(out_b1p2))))
    out_b3p8 = net.block3(relu(net.bn3(net.conv3p4s2(out_b2p4))))
    out = net.block4(relu(net.bn4(net.conv4p8s2(out_b3p8))))
    out = net.block5(cat(relu(net.bntr4(net.convtr4p16s2(out))), out_b3p8))
    out = net.block6(cat(relu(net.bntr5(net.convtr5p8s2(out))), out_b2p4))
    out = net.block7(cat(relu(net.bntr6(net.convtr6p4s2(out))), out_b1p2))
    out = net.block8(cat(relu(net.bntr7(net.convtr7p2s2(out))), out_p1))
    return net.final(out)


def test_minkunet_forward_is_its_levels_through_the_classifier():
    coords, feats = rooms(n=1, voxel=0.2, n_points=5000)[:2]
    net = Narrow(3, 20, D=3, generator=torch.Generator().manual_seed(0), device="cpu").train()
    calls = []
    for name, m in net.named_modules():
        if name:
            m.register_forward_hook(lambda m, a, o, name=name: calls.append(name))
    outs = []
    for run in (net.forward, lambda x: old_forward(net, x)):
        calls.clear()
        torch.manual_seed(0)
        outs.append((run(MT.SparseTensor(feats, coords, device="cpu")).F, list(calls)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    levels = list(net.feature_levels(MT.SparseTensor(feats, coords, device="cpu")))
    assert [lv.tensor_stride[0] for lv in levels] == [16, 8, 4, 2, 1]
    assert [lv.F.shape[1] for lv in levels] == [16, 16, 16, 8, 8]


SPANS = ("levels", "fps", "posenc", "mask_module", "cross_attn", "self_attn", "ffn",
         "criterion")


def span_check(host, before, after):
    """The ``me.mask3d.*`` spans of one step, nested as listed and as many as
    the ``mask3d`` counter counts; returns them by name."""
    named = {n: [(e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == "me.mask3d." + n]
             for n in SPANS + ("pool", "match")}
    assert all(named[n] for n in named), {n: len(v) for n, v in named.items()}
    for inner, outer in (("pool", "mask_module"), ("match", "criterion")):
        assert all(any(a <= s and t <= b for a, b in named[outer]) for s, t in named[inner])
    assert len(named["mask_module"]) == 13 and len(named["pool"]) == 12
    assert len(named["match"]) == 13 and len(named["fps"]) == 1
    assert after["mask3d"]["count"] - before.get("mask3d", {"count": 0})["count"] == \
        sum(len(named[n]) for n in SPANS)
    return named


def test_a_step_counts_its_parts_and_nests_its_spans(tmp_path):
    cfg, (coords, feats, raw, inst, labels, scenes) = config(), rooms(n=2, voxel=0.2)
    model = port_model(cfg)
    crit = MT.models.SetCriterion(cfg["num_targets"], cfg["eos_coef"], device="cpu")
    before = P.counters()
    with MT.utils.trace(str(tmp_path)):
        x = MT.SparseTensor(feats, coords, device="cpu")
        rows = x.unique_index.long()
        out = model(x, raw[rows], torch.Generator().manual_seed(1))
        crit(out, MT.models.InstanceTargets(inst[rows], labels, scenes))[0].backward()
    after = P.counters()
    span_check(trace_events(tmp_path), before, after)
    counted = sync_counts(before, after)
    assert counted["sync.match.costs"] == 13 and counted["sync.match.indices"] == 1


# -- the card ------------------------------------------------------------------


def card_step(dev, n_rooms=2):
    """One SGD step of the published Mask3D on ``n_rooms`` 2 cm rooms, inputs
    already on the card."""
    coords, feats, raw, inst, labels, scenes = rooms(
        n=n_rooms, voxel=0.02, n_points=200_000, extent=(4.0, 5.0, 2.5))
    coords, feats, raw, inst, labels = (t.to(dev) for t in (coords, feats, raw, inst, labels))
    model = MT.models.Mask3D(generator=torch.Generator().manual_seed(0), device=dev).train()
    crit = MT.models.SetCriterion(device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=1e-4)
    gen = torch.Generator(dev).manual_seed(1)

    def step():
        x = MT.SparseTensor(feats, coords, device=dev)
        rows = x.unique_index.to(dev).long()
        out = model(x, raw.index_select(0, rows), gen)
        loss, _ = crit(out, MT.models.InstanceTargets(inst.index_select(0, rows), labels, scenes))
        opt.zero_grad()
        loss.backward()
        opt.step()

    return step


@pytest.mark.cuda
def test_a_card_step_holds_its_syncs_and_nests_its_spans(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    step = card_step(dev)
    step()
    step()  # kernels built, allocator warm
    lines = Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]
                    if "minkowskiengine_tpu_torch" in f.filename
                    or "test_torch_mask3d" in f.filename]
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
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(tmp_path)),
    ):
        with torch.profiler.record_function("test.step"):
            step()
        counted_syncs = sync_counts(before, P.counters())
        torch.cuda.synchronize()
    after = P.counters()
    xs = trace_events(tmp_path)
    host = [e for e in xs if e.get("cat") != "gpu_user_annotation"]
    (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == "test.step"]
    print(f"\nsyncs {counted_syncs}; synchronizing lines {dict(lines)}")
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in host
             if e["name"].startswith("me.sync.")]
    syncs = [e for e in host if e.get("cat") == "cuda_runtime" and e["name"] in SYNC_CALLS
             and lo <= e["ts"] <= hi]
    outside = [e for e in syncs if not any(t == e["tid"] and a <= e["ts"] <= b
                                           for t, a, b in spans)]
    assert not outside, [(e["name"], e["ts"]) for e in outside]
    assert len(syncs) == sum(counted_syncs.values())
    assert counted_syncs["sync.match.costs"] == 13 and counted_syncs["sync.match.indices"] == 1
    span_check(host, before, after)
