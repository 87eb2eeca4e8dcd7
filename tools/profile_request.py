#!/usr/bin/env python3
"""Where the time of one MinkUNet34 inference request and training step,
of one MinkowskiFCNN classification batch and training step, of one
CompletionNet training step and of one MinkowskiSplatFCNN training step
goes on one CUDA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 tools/profile_request.py

Model and input are ``chip_smoke.py``'s: ``MinkUNet34(3, 20, D=3)`` with
weights from torch.Generator seed 0 in eval mode, and the surface-26k room
scan of seed 0 (about 26k voxels at 5 cm).  After one warm-up request it
prints:

1. the wall time of five requests, each with a fresh coordinate manager,
   so the coordinate phase (unique, stride maps, kernel maps) is included;
2. the wall time of the same forward on a warm manager, whose stride maps
   and kernel maps are all cached; the difference from 1 is the cost of
   the coordinate phase on the request's critical path;
3. one fresh request under ``torch.profiler``: the device time of all its
   kernels and copies, gather_gemm's share of it, and the device's busy
   share of that request's wall time.  The profiler slows the host, so the
   idle share from this run is an upper bound;
4. the profiler's table, by device time.

Then the training step, in train mode, as ``chip_smoke.py`` takes it: a
batch of the scans of seeds 0 and 1 (about 51k voxels) collated into a
fresh manager, forward, cross-entropy, backward, SGD step.  It prints

5. the wall time of five steps;
6. one profiled step: the device time of gather_gemm (forward and input
   gradient), of conv_dw (weight gradient) and of the in-order sums over
   both kernels' splits, and the device's idle share; then the profiler's
   table.

Then ``chip_smoke.py``'s classifier, ``MinkowskiFCNN(3, 40,
embedding_channel=1024, channels=(32, 48, 64, 96, 128))``, on its batch of
seed 0 (32 synthetic shapes x 2048 points, a TensorField):

7. eval mode: the wall time of five batches, each with a fresh manager,
   then one profiled batch, as in 6;
8. train mode (SGD with momentum, as chip_smoke.py's phase 13, on the same
   batch with ``CoordinateTransformation``): five steps, then one profiled
   step, as in 6;

Then ``chip_smoke.py``'s CompletionNet (the reference widths, 16 stand-in
shapes at 128³, batch of seed 0) in train mode with SGD as in its phase 18:

9. four steps (after one warm-up) with the host's time inside the
   coordinate manager's calls (maps, kernel maps, merge, union, prune; the
   outermost call only), inside the per-level ``keep.any()`` syncs of the
   decoder and inside the sparse convs, and the step's host reads of device
   values, all from the port's counters; then one profiled step, as in 6;

Then ``chip_smoke.py``'s ``MinkowskiSplatFCNN`` (the FCNN's widths, voxelized
by splatting) in train mode as in its phase 23, on the batch of step 8:

10. five steps, one profiled step as in 6, then the splat (corner set,
    map, weights, the weighted scatter) and an interpolation (of conv1's
    output at the field's points) alone on that batch, each forward and
    backward under the profiler: their busy device time beside the step's;

Then the training step of 5-6 again under ``MT.set_compute_dtype(torch.bfloat16)``:

11. five steps and one profiled step as in 6 (K1 and K2 run their bf16
    instances), with the device time and count of the elementwise copy
    kernels, which carry the dtype casts (the conv's features and weights,
    batch norm's float32 round trip), beside step 6's;

Then the training step of 5-6 on fresh geometry: the coordinate phase
recorded once, a ``GeometryReplayer`` warmed on two other batches, and
per step ``CompiledReplayer.run`` (one CUDA graph, one host sync) ->
``from_geometry`` -> ``SparseTensor`` -> forward, backward, SGD:

12. five steps with the host time of the replay, then one profiled step:
    device busy, the idle share and the replay's host time, beside step
    6's eager step;

Then ``chip_smoke.py``'s 7-D U-Net (phase 39: ``HighDimUNet(3, 20, D=7)``
on its first training batch, two room scans lifted to (x, y, z, r, g, b,
t), ~238k rows, two-word keys):

13. five training steps, one profiled step as in 6, then its largest
    kernel map (K = 128 at stride 1) built piece by piece, each timed with
    CUDA events: the query keys, the overflow mask, the search (the
    multi-word lower bound), the inverse map; and, for scale, the same
    queries' first words searched alone with ``torch.searchsorted``;

and, last, one JSON line with the numbers of all nine.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import minkowskiengine_tpu_torch as MT  # noqa: E402
from chip_smoke import (  # noqa: E402
    CLASSES, FCNN_LR, FCNN_MOMENTUM, FCNN_WD, FCNN_WIDTHS, GEN_WIDTHS, HIGH_D_TRAIN,
    HighDimUNet, answer, bce, classify, collate, completion_input, cuda_ms, fcnn_step, field,
    gen_batch, gen_sgd, labels_for, lifted_voxels, scan, shapes, splat_fcnn, train_step,
)
from minkowskiengine_tpu_torch.coords import keys as K  # noqa: E402
from minkowskiengine_tpu_torch.coords.kernel_map import (  # noqa: E402
    _build_queries, _invert_matching,
)
from minkowskiengine_tpu_torch.coords.lookup import find_rows  # noqa: E402
from minkowskiengine_tpu_torch.utils.collation import sparse_collate  # noqa: E402
from minkowskiengine_tpu_torch.coords.manager import CoordinateManager  # noqa: E402
from minkowskiengine_tpu_torch.models import CompletionNet, MinkowskiFCNN, MinkUNet34  # noqa: E402
from minkowskiengine_tpu_torch.utils.datasets import CoordinateTransformation  # noqa: E402

K1_NAME = "gather_gemm_"  # gather_gemm_mma_kernel, gather_gemm_stem_kernel
K2_NAME = "conv_dw_"  # conv_dw_mma_kernel, conv_dw_stem_kernel
SPLITS_NAME = "sum_splits_kernel"  # the second pass of either kernel
COPY_NAME = "copy_kernel"  # elementwise copies: dtype casts, contiguous()
SEED = 0
REPEATS = 5


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def warm_request(model, x):
    """The forward again on ``x``'s manager, where every map is cached."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = MT.SparseTensor(
        x.F, coordinate_map_key=x.coordinate_map_key, coordinate_manager=x.coordinate_manager
    )
    with torch.no_grad():
        model(warm).F.cpu()
    return time.perf_counter() - t0


def device_split(prof, secs):
    """Busy device time, per-kernel shares and the idle share of a profiled
    run that took ``secs`` on the host clock."""
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise AssertionError("the profiler recorded no device activity")

    def span(name):
        events = [e for e in device if name in e.name]
        return busy_us((e.time_range.start, e.time_range.end) for e in events), len(events)

    device_us = busy_us((e.time_range.start, e.time_range.end) for e in device)
    k1_us, k1_n = span(K1_NAME)
    k2_us, k2_n = span(K2_NAME)
    sums_us, sums_n = span(SPLITS_NAME)
    copy_us, copy_n = span(COPY_NAME)
    wall_us = secs * 1e6
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=device_us / 1e3, device_events=len(device),
        gather_gemm_ms=k1_us / 1e3, gather_gemm_launches=k1_n,
        conv_dw_ms=k2_us / 1e3, conv_dw_launches=k2_n,
        split_sums_ms=sums_us / 1e3, split_sums=sums_n, copy_kernels_ms=copy_us / 1e3,
        copy_kernels=copy_n, idle_share=1 - device_us / wall_us,
    )


def train_once(model, opt, scans, labels, dev):
    """One chip_smoke.py training step, collate to SGD step, synced."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coords, feats = collate(scans)
    train_step(model, opt, coords, feats, labels, dev)
    opt.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_train(dev, steps_tag="5 training steps", profiled_tag="6 profiled step"):
    model = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    scans = [scan(SEED), scan(SEED + 1)]
    labels = labels_for(0, sum(len(c) for c, _ in scans))
    train_once(model, opt, scans, labels, dev)  # warm-up
    steps = [train_once(model, opt, scans, labels, dev) * 1e3 for _ in range(REPEATS)]
    print(f"[{steps_tag}] {len(labels)} voxels, ms: {', '.join(f'{t:.2f}' for t in steps)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = train_once(model, opt, scans, labels, dev)
    split = device_split(prof, secs)
    report(profiled_tag, split, prof)
    return {"voxels": len(labels), "step_ms": steps,
            **{f"profiled_{k}": v for k, v in split.items()}}


def profile_bf16_train(dev):
    """Step 11: the step of 5-6 under the bf16 compute policy."""
    MT.set_compute_dtype(torch.bfloat16)
    try:
        return profile_train(dev, "11 bf16 training steps", "11 profiled bf16 step")
    finally:
        MT.set_compute_dtype(None)


def profile_fresh_geometry(dev, eager):
    """Step 12: step 6's batch through the compiled replay."""
    model = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    coords, feats = collate([scan(SEED), scan(SEED + 1)])
    labels = labels_for(0, len(coords)).to(dev)
    x = MT.SparseTensor(feats.to(dev), coords.to(dev))
    with torch.no_grad():
        model.eval()(x)  # records the coordinate phase
    model.train()
    replayer = MT.GeometryReplayer(x.coordinate_manager)
    for s in (SEED + 2, SEED + 4):
        replayer(collate([scan(s), scan(s + 1)])[0].to(dev))
    compiled = MT.CompiledReplayer(x.coordinate_manager).adopt(replayer)

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, f = coords.to(dev), feats.to(dev)
        t1 = time.perf_counter()
        geo, fp, ok = compiled.run(c, f)
        if not ok:
            geo, fp = compiled.recover(c, f)
        t2 = time.perf_counter()
        view = MT.CoordinateManager.from_geometry(geo)
        out = model(MT.SparseTensor(fp, coordinate_map_key=geo.entry_key, coordinate_manager=view))
        loss = torch.nn.functional.cross_entropy(out.F, labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, t2 - t1

    step()  # warm-up: the graph's capture
    runs = [step() for _ in range(REPEATS)]
    steps, replay = [t * 1e3 for t, _ in runs], [r * 1e3 for _, r in runs]
    print(f"[12 fresh-geometry training steps] {len(coords)} voxels, ms: "
          f"{', '.join(f'{t:.2f}' for t in steps)}; replay host ms: "
          f"{', '.join(f'{t:.2f}' for t in replay)}; graphs captured {compiled.captures}, "
          f"recoveries {compiled.recoveries}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs, replay_s = step()
    split = device_split(prof, secs)
    report("12 profiled fresh-geometry step", split, prof)
    print(f"  replay host {replay_s * 1e3:.2f} ms of the profiled step; against step 6's eager "
          f"step: wall {split['wall_ms']:.2f} vs {eager['profiled_wall_ms']:.2f} ms, device busy "
          f"{split['device_busy_ms']:.3f} vs {eager['profiled_device_busy_ms']:.3f} ms, idle "
          f"{100 * split['idle_share']:.1f}% vs {100 * eager['profiled_idle_share']:.1f}%")
    return {"voxels": len(coords), "step_ms": steps, "replay_host_ms": replay,
            "profiled_replay_host_ms": replay_s * 1e3, "graphs_captured": compiled.captures,
            "recoveries": compiled.recoveries, **{f"profiled_{k}": v for k, v in split.items()}}


def profile_high_dim(dev):
    """Step 13: chip_smoke.py phase 39's 7-D training step, and its
    largest kernel map built piece by piece."""
    model = HighDimUNet(3, 20, 7, generator=torch.Generator().manual_seed(0), device=dev).train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    clouds = [lifted_voxels(s) for s in HIGH_D_TRAIN[0]]
    coords, feats = sparse_collate([c for c, _ in clouds], [f for _, f in clouds])
    labels = labels_for(0, len(coords))

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(model, opt, coords, feats, labels, dev)
        opt.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step()  # warm-up
    steps = [step() * 1e3 for _ in range(REPEATS)]
    print(f"[13 7-D training steps] {len(coords)} rows, ms: {', '.join(f'{t:.2f}' for t in steps)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = step()
    split = device_split(prof, secs)
    report("13 profiled 7-D step", split, prof)

    mgr = CoordinateManager(D=7, device=dev)
    key, _ = mgr.insert_and_map(coords.to(dev))
    cmap = mgr.get_coordinate_map(key)
    region = MT.KernelGenerator(kernel_size=2, dimension=7).get_kernel((1,) * 7, False)
    offs = np.zeros((region.volume, 8), np.int64)
    offs[:, 1:] = region.offsets
    offs = K.device_constant(offs, device=dev)
    queries, invalid = _build_queries(cmap.coordinates, offs)
    rows = find_rows(cmap.keys, queries)
    first, first_q = cmap.keys[:, 0].contiguous(), queries[..., 0].contiguous()
    pieces = {
        "insert_and_map (unique over two-word keys)":
            lambda: CoordinateManager(D=7, device=dev).insert_and_map(coords.to(dev)),
        "query keys": lambda: K.pack(cmap.coordinates)[None] + K.pack_offsets(offs)[:, None],
        "overflow mask": lambda: K.overflow_mask_of_sum(cmap.coordinates, offs),
        "search, two words": lambda: find_rows(cmap.keys, queries),
        "search, first word alone (searchsorted)": lambda: find_rows(first, first_q),
        "inverse map": lambda: _invert_matching(rows, cmap.size),
    }
    split_ms = {name: cuda_ms(fn, warmup=1, iters=3) for name, fn in pieces.items()}
    print(f"[13 7-D kernel map, K = {region.volume} on {cmap.size} rows, "
          f"{queries.shape[0] * queries.shape[1]} queries, "
          f"{int((rows >= 0).sum())} found] CUDA-event ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in split_ms.items()))
    del invalid
    return {"rows": len(coords), "step_ms": steps, "kernel_map_ms": split_ms,
            **{f"profiled_{k}": v for k, v in split.items()}}


def report(tag, split, prof):
    """A profiled run's device split, then the profiler's table."""
    print(
        f"[{tag}] wall {split['wall_ms']:.2f} ms; device busy "
        f"{split['device_busy_ms']:.3f} ms in {split['device_events']} kernels and copies; "
        f"gather_gemm {split['gather_gemm_ms']:.3f} ms in {split['gather_gemm_launches']} "
        f"launches, conv_dw {split['conv_dw_ms']:.3f} ms in {split['conv_dw_launches']} "
        f"launches, split sums {split['split_sums_ms']:.3f} ms in {split['split_sums']} "
        f"kernels, elementwise copies {split['copy_kernels_ms']:.3f} ms in "
        f"{split['copy_kernels']} kernels; device idle {100 * split['idle_share']:.1f}% of the wall"
    )
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))


def profile_classification(dev):
    """A MinkowskiFCNN batch in eval mode, then a training step."""
    coords, feats, _ = shapes(SEED)
    model = MinkowskiFCNN(
        3, CLASSES, generator=torch.Generator().manual_seed(0), device=dev, **FCNN_WIDTHS
    ).eval()
    classify(model, coords, feats, dev)  # warm-up
    batch = [classify(model, coords, feats, dev)[1] * 1e3 for _ in range(REPEATS)]
    print(f"[7 FCNN batches] {len(coords)} points, ms: {', '.join(f'{t:.2f}' for t in batch)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, secs = classify(model, coords, feats, dev)
    infer = device_split(prof, secs)
    report("7 profiled FCNN batch", infer, prof)

    steps, train = profile_fcnn_steps(model.train(), "8", "FCNN", dev)
    return (
        {"points": len(coords), "batch_ms": batch, **{f"profiled_{k}": v for k, v in infer.items()}},
        {"points": len(coords), "step_ms": steps, **{f"profiled_{k}": v for k, v in train.items()}},
    )


def profile_fcnn_steps(model, tag, name, dev):
    """Five SGD steps (momentum, as chip_smoke.py's phase 13) on the batch of
    seed 0 with ``CoordinateTransformation``, after a warm-up, then one
    profiled step.  Returns (step times in ms, the profiled split)."""
    opt = torch.optim.SGD(
        model.parameters(), lr=FCNN_LR, momentum=FCNN_MOMENTUM, weight_decay=FCNN_WD
    )
    train_batch = shapes(SEED, CoordinateTransformation())

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        fcnn_step(model, *train_batch, dev)
        opt.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step()  # warm-up
    steps = [step() * 1e3 for _ in range(REPEATS)]
    print(f"[{tag} {name} training steps] ms: {', '.join(f'{t:.2f}' for t in steps)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = step()
    split = device_split(prof, secs)
    report(f"{tag} profiled {name} step", split, prof)
    return steps, split


def profiled_busy_ms(fn):
    """Busy device time of one run of ``fn`` under the profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return device_split(prof, secs)["device_busy_ms"]


def profile_splat(dev):
    """A MinkowskiSplatFCNN training step, then the splat and an
    interpolation alone on its batch."""
    model = splat_fcnn(dev, torch.Generator().manual_seed(0)).train()
    steps, split = profile_fcnn_steps(model, "10", "SplatFCNN", dev)
    coords, feats, _ = shapes(SEED, CoordinateTransformation())
    with torch.no_grad():
        x = model.mlp1(field(coords, feats, dev))
        y = model.conv1(x.splat())

    def splat():
        st = x._wrap(x.F.detach().requires_grad_()).splat()
        st.F.sum().backward()
        return st.size

    def interpolate():
        f = y.F.detach().requires_grad_()
        MT.SparseTensor(f, coordinate_map_key=y.coordinate_map_key,
                        coordinate_manager=y.coordinate_manager).interpolate(x).sum().backward()

    rows = splat()  # warm-up
    interpolate()
    splat_ms, interp_ms = profiled_busy_ms(splat), profiled_busy_ms(interpolate)
    busy = split["device_busy_ms"]
    print(
        f"[10 splat and interpolation alone] {len(coords)} points, {rows} splat rows; splat "
        f"forward + backward {splat_ms:.3f} ms of device time ({100 * splat_ms / busy:.1f}% of the "
        f"step's {busy:.3f} ms); interpolation of conv1's output forward + backward "
        f"{interp_ms:.3f} ms ({100 * interp_ms / busy:.1f}%)"
    )
    return {"points": len(coords), "splat_rows": rows, "step_ms": steps,
            "splat_device_ms": splat_ms, "interpolation_device_ms": interp_ms,
            **{f"profiled_{k}": v for k, v in split.items()}}


class HostClock:
    """Host time inside the coordinate manager's building calls (the
    outermost one of nested calls), inside the decoder's per-level
    ``keep.any()`` reads and inside the sparse conv's parts, and the host
    reads of device values, from the port's own counters
    (``MT.utils.profiling.counters()``, read before and after the block)."""

    def __enter__(self):
        self._before = MT.utils.profiling.counters()
        return self

    def __exit__(self, *exc):
        after = MT.utils.profiling.counters()

        def delta(name, field):
            return after.get(name, {field: 0})[field] - self._before.get(name, {field: 0})[field]

        self.keep_any_n = delta("sync.completion.keep", "count")
        self.keep_any_s = delta("sync.completion.keep", "seconds")
        self.coordinate_s = delta("coords", "seconds") - self.keep_any_s
        self.conv_s = delta("conv", "seconds")
        self.host_reads = sum(delta(k, "count") for k in after if k.startswith("sync."))


def profile_completion(dev):
    """CompletionNet training steps with the host clocks, then a profiled one."""
    batch = gen_batch(SEED)
    model = CompletionNet(generator=torch.Generator().manual_seed(0), device=dev, **GEN_WIDTHS)
    opt = gen_sgd(model.train())

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        out_cls, targets, _ = model(*completion_input(batch, dev))
        bce(out_cls, targets).backward()
        opt.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, [c.size for c in out_cls]

    step()  # warm-up
    steps, coordinate, keep_any, conv, levels = [], [], [], [], None
    for _ in range(REPEATS - 1):
        with HostClock() as clock:
            secs, levels = step()
        steps.append(secs * 1e3)
        coordinate.append(clock.coordinate_s * 1e3)
        keep_any.append(clock.keep_any_s * 1e3)
        conv.append(clock.conv_s * 1e3)
    print(
        f"[9 completion training steps] {len(batch[0])} voxels in, rows per decoder level "
        f"{levels}; ms: {', '.join(f'{t:.2f}' for t in steps)}; host in coordinate-manager "
        f"calls: {', '.join(f'{t:.2f}' for t in coordinate)} ms; host in the {clock.keep_any_n} "
        f"keep.any() syncs: {', '.join(f'{t:.2f}' for t in keep_any)} ms; host in the sparse "
        f"convs: {', '.join(f'{t:.2f}' for t in conv)} ms; {clock.host_reads} host reads a step"
    )
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs, _ = step()
    split = device_split(prof, secs)
    report("9 profiled completion step", split, prof)
    return {"voxels": len(batch[0]), "rows_per_level": levels, "step_ms": steps,
            "coordinate_host_ms": coordinate, "keep_any_host_ms": keep_any,
            "conv_host_ms": conv, "host_reads": clock.host_reads,
            **{f"profiled_{k}": v for k, v in split.items()}}


def profile_request(dev):
    coords, feats = scan(SEED)
    model = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).eval()
    answer(model, coords, feats, dev)  # warm-up: kernel build, allocator, cuBLAS

    fresh = [answer(model, coords, feats, dev)[1] * 1e3 for _ in range(REPEATS)]
    print(f"[1 fresh manager] {len(coords)} voxels, ms: {', '.join(f'{t:.2f}' for t in fresh)}")

    x = MT.SparseTensor(torch.from_numpy(feats).to(dev), torch.from_numpy(coords).to(dev))
    with torch.no_grad():
        model(x)  # fills x's manager
    cached = [warm_request(model, x) * 1e3 for _ in range(REPEATS)]
    coord_ms = statistics.median(fresh) - statistics.median(cached)
    print(
        f"[2 warm manager] ms: {', '.join(f'{t:.2f}' for t in cached)}; "
        f"coordinate phase (median difference) {coord_ms:.2f} ms"
    )

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, secs = answer(model, coords, feats, dev)
    split = device_split(prof, secs)
    print(
        f"[3 profiled request] wall {split['wall_ms']:.2f} ms; device busy "
        f"{split['device_busy_ms']:.3f} ms in {split['device_events']} kernels and copies; "
        f"gather_gemm {split['gather_gemm_ms']:.3f} ms in {split['gather_gemm_launches']} "
        f"launches ({100 * split['gather_gemm_ms'] / split['device_busy_ms']:.1f}% of "
        f"device time), split sums {split['split_sums_ms']:.3f} ms in {split['split_sums']} "
        f"kernels; device idle {100 * split['idle_share']:.1f}% of the wall"
    )
    print("[4 profiler table]")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    return {
        "voxels": len(coords),
        "fresh_ms": fresh,
        "warm_manager_ms": cached,
        "coordinate_phase_ms": coord_ms,
        **{f"profiled_{k}": v for k, v in split.items()},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_request: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    request = profile_request(dev)
    train = profile_train(dev)
    fcnn_batch, fcnn_train = profile_classification(dev)
    completion = profile_completion(dev)
    splat = profile_splat(dev)
    bf16_train = profile_bf16_train(dev)
    fresh = profile_fresh_geometry(dev, train)
    high_dim = profile_high_dim(dev)
    print(json.dumps({
        "request": request, "train_step": train,
        "fcnn_batch": fcnn_batch, "fcnn_train_step": fcnn_train,
        "completion_train_step": completion, "splat_fcnn_train_step": splat,
        "bf16_train_step": bf16_train, "fresh_geometry_train_step": fresh,
        "high_dim_train_step": high_dim,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
