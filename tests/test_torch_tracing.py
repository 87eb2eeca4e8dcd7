"""The port's own spans and counters (``utils/profiling.py``).

CPU: ``span`` is a shared no-op with no profiler recording; a profiled
step holds the ``me.*`` spans, nested as the calls nest; the host-read
counters repeat exactly from step to step; a nested manager call adds
once to ``coords``; a CompletionNet step counts one keep read per level.

Card (marked ``cuda``; skips where no card is visible, decided inside the
test): in one profiled step of MinkUNet34 training at 5 cm, one 2 cm
MinkUNet34 inference request and one CompletionNet training step, every
synchronizing CUDA runtime call lies inside an ``me.sync.*`` span, and
there are as many as the ``sync.*`` counters count.  A float32 MinkUNet34
training step and a 2 cm request build their 10 kernel maps with 10
launches of the grid-probe kernel (``kernels/grid_probe.py``), each in an
``me.coords.kernel_map.grid`` span inside ``me.coords.kernel_map``, and no
half in plain ops; the same step with the plain version on the card
launches as many device operations outside those spans, and the plain
version's inside them.  Run with ``-s`` to see each synchronizing call's
Python line and the launch counts.
"""

import glob
import json
import traceback
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.coords import kernel_map as KM
from minkowskiengine_tpu_torch.kernels import grid_probe as GP
from minkowskiengine_tpu_torch.models import CompletionNet, MinkUNet34
from minkowskiengine_tpu_torch.utils import profiling as P
from minkowskiengine_tpu_torch.utils.datasets import completion_batch, make_room_scan, room_scan_voxels

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


class Narrow(MinkUNet34):
    PLANES, INIT_DIM = (8, 16, 16, 16, 16, 16, 8, 8), 8


def segmentation_train_step(dev, net=MinkUNet34, voxel_size=0.05, n_points=120_000, batch=2):
    """One SGD step of a MinkUNet34 on ``batch`` room scans (the 5 cm
    training cell's scans at the defaults), inputs already on ``dev``."""
    coords, feats = [], []
    for b in range(batch):
        c, f = room_scan_voxels(voxel_size=voxel_size, n_points=n_points, extent=(2.0, 2.0, 2.2),
                                n_objects=4, seed=b)
        coords.append(np.concatenate([np.full((len(c), 1), b, np.int32), c[:, 1:]], 1))
        feats.append(f)
    coords = torch.from_numpy(np.concatenate(coords)).to(dev)
    feats = torch.from_numpy(np.concatenate(feats)).to(dev)
    labels = torch.randint(0, 20, (len(coords),), generator=torch.Generator().manual_seed(0)).to(dev)
    model = net(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01)

    def step():
        x = MT.SparseTensor(feats, coords, device=dev)
        out = model(x).F
        loss = torch.nn.functional.cross_entropy(out, labels.index_select(0, x.unique_index))
        opt.zero_grad()
        loss.backward()
        opt.step()

    return step


def segmentation_request(dev, voxel_size=0.02, n_points=200_000):
    """One MinkUNet34 request on a room at ``voxel_size`` (the 2 cm
    inference cell's): field, ``sparse()``, the forward, ``slice()``."""
    pts = make_room_scan(n_points=n_points, extent=(4.0, 5.0, 2.5), n_objects=6, seed=0)
    coords = np.zeros((len(pts), 4), np.float32)
    coords[:, 1:] = pts / np.float32(voxel_size)
    coords = torch.from_numpy(coords).to(dev)
    colors = torch.rand(len(pts), 3, generator=torch.Generator().manual_seed(0)).to(dev)
    model = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).eval()

    def step():
        with torch.no_grad():
            field = MT.TensorField(
                features=colors, coordinates=coords, device=dev,
                quantization_mode=MT.SparseTensorQuantizationMode.UNWEIGHTED_AVERAGE,
            )
            model(field.sparse()).slice(field)

    return step


def completion_train_step(dev, shapes=16, resolution=128, n_points=None, **widths):
    """One CompletionNet training step (the completion cell's widths and
    shapes at the defaults): the mean of each level's BCE, SGD."""
    kw = {} if n_points is None else {"n_points": n_points}
    partial, feats, full = (torch.from_numpy(a).to(dev)
                            for a in completion_batch(shapes, resolution, seed=0, **kw))
    model = CompletionNet(resolution=resolution, generator=torch.Generator().manual_seed(0),
                          device=dev, **widths).train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9, weight_decay=1e-4)
    levels = []

    def step():
        mgr = MT.CoordinateManager(D=3, device=dev)
        x = MT.SparseTensor(feats, partial, coordinate_manager=mgr)
        target_key, _ = mgr.insert_and_map(full, 1)
        out_cls, targets, _ = model(x, target_key)
        loss = sum(
            torch.nn.functional.binary_cross_entropy_with_logits(c.F[:, 0], t.to(c.F.dtype))
            for c, t in zip(out_cls, targets)
        ) / len(out_cls)
        opt.zero_grad()
        loss.backward()
        opt.step()
        levels[:] = [len(out_cls)]

    step.levels = levels
    return step


def small_train_step():
    return segmentation_train_step("cpu", Narrow, voxel_size=0.2, n_points=20_000)


def small_completion_step():
    return completion_train_step("cpu", shapes=2, resolution=16, n_points=2000,
                                 enc_channels=(4, 8, 8), dec_channels=(4, 8, 8))


def sync_counts(before, after):
    """The ``sync.*`` counts added between two ``counters()`` snapshots, by site."""
    out = {k: v["count"] - before.get(k, {"count": 0})["count"]
           for k, v in after.items() if k.startswith("sync.")}
    return {k: n for k, n in out.items() if n}


def trace_events(log_dir):
    (path,) = glob.glob(f"{log_dir}/*.json")
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    step = small_train_step()
    assert P.span("a") is P.span("b") is P._NOOP
    with P.span("a"), P.host_read("a"), P.coords_call("a"), P.conv_part("a"):
        pass
    step()
    assert entered == []


def test_a_profiled_step_holds_the_ports_spans_nested(tmp_path):
    step = small_train_step()
    step()  # the first step builds what later steps find ready
    with MT.utils.trace(str(tmp_path)):
        step()
    xs = trace_events(tmp_path)
    names = Counter(e["name"] for e in xs if e["name"].startswith("me."))
    for name in ("me.tensor.sparse", "me.coords.insert_and_map", "me.coords.unique",
                 "me.coords.kernel_map", "me.coords.kernel_map.in_idx",
                 "me.coords.kernel_map.out_idx_t", "me.coords.stride", "me.conv.fwd",
                 "me.conv.dx", "me.conv.dw", "me.sync.register_unique.bbox"):
        assert names[name] > 0, name
    assert names["me.conv.fwd"] == names["me.conv.dw"] == 55  # MinkUNet34's convs
    outer = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in xs if e["name"] == "me.coords.kernel_map"]
    for e in xs:
        if e["name"] in ("me.coords.kernel_map.in_idx", "me.coords.kernel_map.out_idx_t"):
            assert any(t == e["tid"] and lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                       for t, lo, hi in outer), e


def test_two_identical_steps_count_the_same_host_reads():
    step = small_train_step()
    step()
    counts = []
    for _ in range(2):
        before = P.counters()
        step()
        counts.append(sync_counts(before, P.counters()))
    assert counts[0] == counts[1]
    assert counts[0]["sync.register_unique.bbox"] == 5  # the input and four strides
    assert all(isinstance(v, dict) for v in P.counters().values())


def test_a_nested_manager_call_adds_once_to_coords():
    mgr = MT.CoordinateManager(D=3, device="cpu")
    key, _ = mgr.insert_and_map(torch.tensor([[0, 0, 0, 0], [0, 2, 0, 0], [1, 0, 2, 4]]), 1)
    P.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mgr.kernel_map(key, key, kernel_size=3)  # builds the map's dense plan inside
    assert P.counters()["coords"]["count"] == 1
    names = {e.name for e in prof.events()}
    assert {"me.coords.kernel_map", "me.coords.dense_plan", "me.coords.probe_grid"} <= names
    mgr.kernel_map(key, key, kernel_size=3)  # a cache hit builds nothing
    assert P.counters()["coords"]["count"] == 1


def test_a_completion_step_counts_one_keep_read_per_level():
    step = small_completion_step()
    P.reset_counters()
    step()
    c = P.counters()
    assert step.levels[0] > 1 and c["sync.completion.keep"]["count"] == step.levels[0]
    assert c["coords"]["seconds"] >= c["sync.completion.keep"]["seconds"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("make", [segmentation_train_step, segmentation_request, completion_train_step])
def test_every_synchronizing_call_of_a_step_is_a_counted_host_read(make, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    step = make(dev)
    step()
    step()  # the kernels are built and the allocator warm
    torch.cuda.synchronize()
    # where each synchronizing call comes from, for the report below
    lines = Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            port = [f for f in traceback.extract_stack() if "minkowskiengine_tpu_torch" in f.filename]
            lines[f"{port[-1].filename.split('minkowskiengine_tpu_torch/')[-1]}:{port[-1].lineno}"
                  if port else f"{filename}:{lineno}"] += 1

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
        counted = sync_counts(before, P.counters())
        torch.cuda.synchronize()  # outside the step, as the profiler's own stop
    host = [e for e in trace_events(tmp_path) if e.get("cat") != "gpu_user_annotation"]
    (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == "test.step"]
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
             if e["name"].startswith("me.sync.")]
    calls = [e for e in host if e.get("cat") == "cuda_runtime" and e["name"] in SYNC_CALLS
             and lo <= e["ts"] <= hi]
    outside = [e for e in calls if not any(t == e["tid"] and a <= e["ts"] <= b
                                           for t, a, b, _ in spans)]
    print(f"\n{make.__name__}: {len(calls)} synchronizing calls, counters {sum(counted.values())}: "
          f"{counted}\nsynchronizing lines (sync debug mode): {dict(lines)}")
    assert not outside, [(e["name"], e["ts"]) for e in outside]
    assert len(calls) == sum(counted.values())


def plain_on_card(in_map, out_map, offsets, probe, probe_out):
    """``kernel_map._probe_on_card`` in the plain version's ATen ops."""
    rows = lambda p, offs, base: None if p is None else KM._build_in_idx_grid(  # noqa: E731
        p, base.coordinates, offs, base.valid_mask())
    return rows(probe, offsets, out_map), rows(probe_out, -offsets, in_map)


def profiled_launches(step, log_dir):
    """(device operations of one profiled step, those launched inside an
    ``me.coords.kernel_map.grid`` span, the spans, the ``kernel_map`` spans)."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ):
        step()
        torch.cuda.synchronize()
    xs = [e for e in trace_events(log_dir) if e.get("cat") != "gpu_user_annotation"]
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in xs
             if e["name"] == "me.coords.kernel_map.grid"]
    outer = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in xs
             if e["name"] == "me.coords.kernel_map"]
    launch_at = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in xs
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    device = P.device_operations(xs)
    inside = 0
    for e in device:
        tid, ts = launch_at.get(e["args"].get("correlation"), (None, None))
        inside += any(t == tid and lo <= ts <= hi for t, lo, hi in spans)
    return len(device), inside, spans, outer


@pytest.mark.cuda
@pytest.mark.parametrize("make", [segmentation_train_step, segmentation_request])
def test_a_step_builds_each_kernel_map_in_one_launch(make, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    step = make(dev)
    step()
    step()  # the kernels are built and the allocator warm
    before, launches = dict(KM.build_kernel_map.route_builds), GP.grid_probe.launches
    step()
    routes = {k: v - before[k] for k, v in KM.build_kernel_map.route_builds.items()}
    assert routes == {"kernel": 20, "ops": 0, "search": 0}
    assert GP.grid_probe.launches - launches == 10
    total, inside, spans, outer = profiled_launches(step, tmp_path / "kernel")
    assert len(spans) == inside == 10, (len(spans), inside)
    for t, lo, hi in spans:
        assert any(t == u and a <= lo and hi <= b for u, a, b in outer)
    monkeypatch.setattr(KM, "_probe_on_card", plain_on_card)
    step()
    p_total, p_inside, p_spans, _ = profiled_launches(step, tmp_path / "plain")
    print(f"\n{make.__name__}: {total} device operations a step with the kernel, {p_total} with "
          f"the plain version on the card; inside the 10 map builds {inside} against {p_inside}")
    assert len(p_spans) == 10 and p_inside > 10 * inside, (len(p_spans), p_inside, inside)
    assert p_total - total == p_inside - inside, (total, inside, p_total, p_inside)
