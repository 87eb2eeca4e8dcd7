#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU: MinkUNet34 inference
and training, then point-cloud classification with MinkowskiFCNN and a
ResNet18 classifier.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off, so every comparison below is full float32.
2. build: compile the CUDA kernels (``minkowskiengine_tpu_torch/csrc``) with
   nvcc for sm_90a and load them; print each instance's ptxas report
   (registers, shared memory, spills).
3. kernel check, synthetic maps: ``gather_gemm`` against its plain PyTorch
   version at every shape MinkUNet34's sparse convs give it (rows of each
   level of a 26k-voxel room scan, about 30% of indices -1).
4. kernel check, real maps: the same comparison on the 55 conv calls of one
   MinkUNet34 forward, captured with forward hooks; both timed per call.
5. inference slice: ``MinkUNet34(3, 20, D=3)`` (weights from
   torch.Generator seed 0, eval mode, no_grad) answers 3 room-scan requests
   of ~26k voxels, each with a fresh coordinate manager; wall time per
   request and points/s.  The kernel's launch count must rise by >= 55 per
   request.
6. parity: request 0 again on the CPU plain path with the same weights; the
   logits must agree with the card's.
7. backward kernels, synthetic maps: at every shape of phase 3, on the row
   counts of a batch of two scans, ``gather_gemm`` as the input gradient
   (output gradient, W[k]ᵀ, the inverse of an injective map) and
   ``conv_dw`` (the weight gradient) against their plain versions; per
   call each kernel's split S and its useful TFLOP/s
   (2 · pairs · Cin · Cout / time) and bound (below).  The same at the
   distinct shapes of MinkowskiFCNN's convs and ResNet18's k = 1, stride-2
   downsamples, on the rows of a 32-shape classification batch.
8. backward kernels, real maps: the 55 conv calls of one training step
   (inputs, kernel maps and output gradients captured with hooks); forward,
   input gradient and weight gradient against their plain versions, per
   call and summed over the step, with the bound.
9. training slice: 4 SGD steps of ``MinkUNet34(3, 20, D=3)`` in train mode,
   each on a new batch of 2 room scans (seeds 0-7) collated by
   ``sparse_collate`` into a fresh coordinate manager, cross-entropy against
   seeded labels; wall time per step and points/s.  ``gather_gemm`` must
   launch >= 109 times per step (55 forward + 54 input gradients; the stem's
   input needs none) and ``conv_dw`` 55 times.
10. gradient parity: step 0 again on the CPU plain path with the same
   weights; loss, every parameter gradient and the BN running statistics
   must agree with the card's.
11. classification inference: ``MinkowskiFCNN(3, 40, embedding_channel=1024,
   channels=(32, 48, 64, 96, 128), D=3)`` (the reference ModelNet40
   example's widths; weights from torch.Generator seed 0, eval mode)
   classifies 3 batches of 32 synthetic shapes x 2048 points (seeds 0-2,
   ``modelnet_batch`` at 2.5 cm voxels, ~48k voxels), each a TensorField
   with a fresh coordinate manager; wall time per batch and points/s.
   Logits (32, 40), finite; ``gather_gemm`` launches >= 7 per batch (its
   seven sparse convs), ``conv_dw`` none.
12. kernels on the FCNN's real maps: the 7 conv calls of one training step
   (train mode, dropout off), forward, input gradient and weight gradient
   against their plain versions, per call and summed, with the bound.
13. classification training: 4 steps of SGD (lr 0.1, momentum 0.9, weight
   decay 1e-4) on batches of seeds 0-3 with ``CoordinateTransformation``,
   cross-entropy, dropout on; wall time per step, points/s, peak memory.
   ``gather_gemm`` >= 14 launches per step (7 forward + 7 input
   gradients), ``conv_dw`` exactly 7.
14. classification parity: (a) phase 11's batch-0 logits against the CPU
   plain path; (b) phase 12's step (loss and every parameter gradient,
   dropout off) against CPU runs in float32 and float64, as phase 10;
   (c) ``ResNet18(3, 40, D=3)`` logits on batch 0 (``TensorField.sparse()``)
   on the card against the CPU; its ``gather_gemm`` launches must equal its
   sparse-conv count.

Bound of a kernel call: the larger of its useful operations (2 · pairs ·
Cin · Cout) over the H100's 495 TFLOP/s dense TF32 tensor peak and its
bytes (each input read once, the output written once) over 3.35 TB/s.  The
kernels keep float32 accuracy with 3xTF32 (three tensor passes), so they
cannot pass a third of that peak.

Then a JSON line describing each kernel and, last, the device line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.coords.kernel_map import _invert_matching
from minkowskiengine_tpu_torch.kernels import build
from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw, conv_dw_reference
from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm, gather_gemm_reference
from minkowskiengine_tpu_torch.models import MinkowskiFCNN, MinkUNet34, ResNet18
from minkowskiengine_tpu_torch.nn.conv import MinkowskiConvolutionBase
from minkowskiengine_tpu_torch.nn.nonlinearity import MinkowskiDropout
from minkowskiengine_tpu_torch.utils.collation import sparse_collate
from minkowskiengine_tpu_torch.utils.datasets import (
    CoordinateTransformation,
    modelnet_batch,
    room_scan_voxels,
)

# f32 sums of up to 27,648 products (K*Cout of FCNN conv5c's input
# gradient) taken in another order.  Relative to the output's largest
# value the differences measured at most 1.2e-6 on every shape; 1e-5
# leaves a factor of eight.
KERNEL_RTOL = 1e-5
# dW sums over the output rows, up to ~59k (FCNN conv1 on an augmented
# batch) at stride 1: sqrt(59k) * 2^-24 = 1.5e-5 relative to the output
# scale; 1e-4 leaves a factor of six.
DW_RTOL = 1e-4
# logits after 55 conv layers and 33 batch norms, CUDA kernel vs CPU plain path
LOGIT_RTOL = 1e-4
# parameter gradients, max|d|/max|ref| per tensor against a float64 run of
# the plain path: at random weights in train mode the gradients are badly
# conditioned (batch-norm backward subtracts batch means; channels of small
# variance amplify), so the CPU's own float32 run is off float64 by up to
# ~3e-2 on some tensors (median ~4e-3).  The card's float32 run rounds in
# another order (K2 sums up to ~10k rows in series per thread) and is held
# to ten times the CPU float32 error of the same tensor, or of the median
# tensor where that tensor happens to round better than the median.
GRAD_FACTOR = 10.0
LOSS_RTOL = 1e-5
MIN_LAUNCHES = 55  # K > 1 sparse convs per forward: 1 stem + 4 down + 46 block + 4 up
MIN_DX_LAUNCHES = MIN_LAUNCHES - 1  # every sparse conv but the stem
TRAIN_STEPS, BATCH, LR = 4, 2, 0.01
# the H100 SXM's published dense TF32 tensor rate and memory rate
TF32_PEAK, HBM_RATE = 495e12, 3.35e12
# MinkowskiFCNN as the reference ModelNet40 example builds and trains it
FCNN_WIDTHS = dict(embedding_channel=1024, channels=(32, 48, 64, 96, 128), D=3)
CLASSES, SHAPES, POINTS, VOXEL = 40, 32, 2048, 0.025
FCNN_CONVS = 7  # conv1-4 and conv5's three
FCNN_LR, FCNN_MOMENTUM, FCNN_WD = 0.1, 0.9, 1e-4
KERNELS = {
    "gather_gemm": ("minkowskiengine_tpu_torch/csrc/gather_gemm.cu",
                    "minkowskiengine_tpu/ops/pallas/conv_kernel.py:1105"),
    "conv_dw": ("minkowskiengine_tpu_torch/csrc/conv_dw.cu",
                "minkowskiengine_tpu/ops/pallas/conv_kernel.py:1391"),
}

# (name, K, Cin, Cout, tensor stride of the input rows, of the output rows)
SLICE_SHAPES = [("stem", 125, 3, 32, 1, 1)]
SLICE_SHAPES += [
    (f"down{i}", 8, c, c, 2**i, 2 ** (i + 1)) for i, c in enumerate((32, 32, 64, 128))
]
SLICE_SHAPES += [
    (f"block{b}", 27, ci, co, ts, ts)
    for b, ci, co, ts in [
        (1, 32, 32, 2), (2, 32, 64, 4), (2, 64, 64, 4), (3, 64, 128, 8),
        (3, 128, 128, 8), (4, 128, 256, 16), (4, 256, 256, 16), (5, 384, 256, 8),
        (5, 256, 256, 8), (6, 192, 128, 4), (6, 128, 128, 4), (7, 128, 96, 2),
        (7, 96, 96, 2), (8, 128, 96, 1), (8, 96, 96, 1),
    ]
]
SLICE_SHAPES += [
    (f"up{i}", 8, ci, co, ts, ts // 2)
    for i, (ci, co, ts) in enumerate([(256, 256, 16), (256, 128, 8), (128, 96, 4), (96, 96, 2)])
]
# MinkowskiFCNN's seven sparse convs (Cin 48 and 336 leave a ragged 32-wide
# chunk; Cout 48 pads to a 64-wide tile; Cout 1024 is sixteen K1 tiles),
# and ResNet18's k = 1, stride-2 downsamples, on a classification batch
CLASSIFICATION_SHAPES = [
    ("fcnn.c1", 27, 32, 48, 1, 1), ("fcnn.c2", 27, 48, 64, 2, 4),
    ("fcnn.c3", 27, 64, 96, 8, 16), ("fcnn.c4", 27, 96, 128, 32, 64),
    ("fcnn.c5a", 27, 336, 256, 1, 2), ("fcnn.c5b", 27, 256, 512, 2, 4),
    ("fcnn.c5c", 27, 512, 1024, 4, 8),
    ("rn.down1", 1, 64, 64, 4, 8), ("rn.down2", 1, 64, 128, 8, 16),
    ("rn.down3", 1, 128, 256, 16, 32), ("rn.down4", 1, 256, 512, 32, 64),
]


def scan(seed):
    """~26k voxels at 5 cm: the room scan bench.py calls surface-26k."""
    return room_scan_voxels(
        voxel_size=0.05, n_points=120_000, extent=(2.0, 2.0, 2.2), n_objects=4, seed=seed
    )


def cuda_ms(fn, warmup=2, iters=10):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(kernel, plain, args, rtol, label):
    """A kernel against its plain version on the same CUDA inputs: error
    and both times."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    abs_err = (got - want).abs().max().item() if want.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    rel = abs_err / scale if scale > 0 else abs_err
    if not (torch.isfinite(got).all() and rel <= rtol):
        raise AssertionError(f"{label}: {kernel.__name__} disagrees, max rel err {rel:.3e}")
    return dict(
        max_abs_err=abs_err, max_rel_err=rel,
        ms=cuda_ms(lambda: kernel(*args)), plain_ms=cuda_ms(lambda: plain(*args)),
    )


def compare(x, w, idx, label):
    """Phases 3-4: gather_gemm against its plain version; returns a row."""
    row = dict(
        label=label, K=w.shape[0], cin=w.shape[1], cout=w.shape[2], n_in=x.shape[0],
        n_out=idx.shape[1], pairs=int((idx >= 0).sum()),
        **check(gather_gemm, gather_gemm_reference, (x, w, idx), KERNEL_RTOL, label),
    )
    print(
        f"  {label:>9} K={row['K']:<3} {row['cin']:>3}->{row['cout']:<3} "
        f"rows {row['n_in']:>5}->{row['n_out']:<5} pairs {row['pairs']:>8}  "
        f"rel err {row['max_rel_err']:.1e}  kernel {row['ms']:.4f} ms  "
        f"plain {row['plain_ms']:.4f} ms"
    )
    return row


def answer(model, coords, feats, device):
    """One request: voxels in, logits out; a fresh coordinate manager."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = MT.SparseTensor(
        torch.from_numpy(feats).to(device), torch.from_numpy(coords).to(device)
    )
    with torch.no_grad():
        logits = model(x).F.cpu()
    return logits, time.perf_counter() - t0


def collate(scans):
    """A batch of room scans: batch index in column 0 of the coordinates."""
    return sparse_collate([c[:, 1:] for c, _ in scans], [f for _, f in scans])


def labels_for(step, n):
    """Seeded 20-class labels, drawn the way bench.py draws them."""
    return torch.randint(0, 20, (n,), generator=torch.Generator().manual_seed(step))


def train_step(model, opt, coords, feats, labels, device):
    """One SGD step on a fresh coordinate manager; returns (loss, output)."""
    x = MT.SparseTensor(feats.to(device), coords.to(device))
    out = model(x)
    loss = torch.nn.functional.cross_entropy(out.F, labels.to(device))
    if opt is not None:
        opt.zero_grad()
    loss.backward()
    return loss, out


def shapes(seed, transform=None):
    """A classification batch: 32 synthetic shapes x 2048 points at 2.5 cm
    voxels; (float coordinates with the batch index, features, labels)."""
    return modelnet_batch(SHAPES, n_points=POINTS, seed=seed, transform=transform, voxel_size=VOXEL)


def field(coords, feats, device):
    """The batch as a TensorField on ``device``, with a fresh coordinate manager."""
    return MT.TensorField(
        torch.as_tensor(feats).to(device), torch.as_tensor(coords).to(device), device=device
    )


def classify(model, coords, feats, device):
    """One classification batch: points in, logits out."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(field(coords, feats, device)).cpu()
    return logits, time.perf_counter() - t0


def fcnn_step(model, coords, feats, labels, device):
    """Forward, cross-entropy and backward of one classification batch."""
    logits = model(field(coords, feats, device))
    loss = torch.nn.functional.cross_entropy(logits, torch.as_tensor(labels).long().to(device))
    loss.backward()
    return loss, logits


def pyramid(mgr, key, strides):
    """Rows of the map at ``key`` and of its stride-2 descendants."""
    rows = {strides[0]: mgr.size(key)}
    for ts in strides[1:]:
        key = mgr.stride(key, 2)
        rows[ts] = mgr.size(key)
    return rows


def sparse_convs(model):
    return [m for m in model.modules() if isinstance(m, MinkowskiConvolutionBase) and not m.use_mm]


def capture_step(convs, run):
    """Run one forward and backward with hooks on ``convs``: every call's
    (module, input, output), and the gradient of each call's output."""
    calls, grads = [], {}

    def capture(m, a, o):
        i = len(calls)
        calls.append((m, a[0], o))
        o.F.register_hook(lambda g: grads.__setitem__(i, g))

    hooks = [m.register_forward_hook(capture) for m in convs]
    try:
        result = run()
    finally:
        for h in hooks:
            h.remove()
    return calls, grads, result


def bound(flop, nbytes):
    """(ms, what sets it): the least time the card could take for the work."""
    ops_ms, bytes_ms = flop / TF32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def injective_map(K, n_in, n_out, gen, dev):
    """(K, n_out) matching, each input row used at most once per offset,
    about 30% of the slots -1."""
    m = min(n_in, n_out)
    idx = torch.full((K, n_out), -1, dtype=torch.int32, device=dev)
    for k in range(K):
        dst = torch.randperm(n_out, generator=gen, device=dev)[:m]
        idx[k, dst] = torch.randperm(n_in, generator=gen, device=dev)[:m].int()
    idx[torch.rand(K, n_out, device=dev, generator=gen) < 0.3] = -1
    return idx


def pairs(idx, n_in):
    return int(((idx >= 0) & (idx < n_in)).sum())


def backward_rows(x, w, g, in_idx, out_idx_t, label, with_dx=True):
    """Phases 7-8: forward, input gradient and weight gradient of one conv,
    each against its plain version, with the kernel's split S and its
    useful TFLOP/s (2 * pairs * Cin * Cout / time)."""
    K, cin, cout = w.shape
    n_in, n_out = x.shape[0], g.shape[0]
    row = dict(label=label, K=K, cin=cin, cout=cout, n_in=n_in, n_out=n_out)
    flop = 2 * pairs(in_idx, n_in) * cin * cout
    nbytes = {  # each input read once (the map too), the output written once
        "fwd": 4 * (n_in * cin + K * cin * cout + K * n_out + n_out * cout),
        "dx": 4 * (n_out * cout + K * cin * cout + K * n_in + n_in * cin),
        "dw": 4 * (n_in * cin + n_out * cout + K * n_out + K * cin * cout),
    }
    row["fwd"] = check(gather_gemm, gather_gemm_reference, (x, w, in_idx), KERNEL_RTOL, label)
    row["fwd"]["splits"] = gather_gemm.last_plan.splits
    if with_dx:
        args = (g, w.transpose(1, 2).contiguous(), out_idx_t)
        row["dx"] = check(gather_gemm, gather_gemm_reference, args, KERNEL_RTOL, label + " dX")
        row["dx"]["splits"] = gather_gemm.last_plan.splits
        row["dx"]["flop"] = 2 * pairs(out_idx_t, g.shape[0]) * w.shape[1] * w.shape[2]
    row["dw"] = check(conv_dw, conv_dw_reference, (x, g, in_idx), DW_RTOL, label + " dW")
    row["dw"]["splits"] = conv_dw.last_plan.splits
    for p in ("fwd", "dx", "dw"):
        if p in row:
            f = row[p].setdefault("flop", flop)
            row[p]["tflops"] = f / (row[p]["ms"] * 1e-3) / 1e12
            row[p]["bound_ms"], row[p]["bound_by"] = bound(f, nbytes[p])
    parts = "  ".join(
        f"{p} {row[p]['ms']:.4f}/{row[p]['plain_ms']:.4f} ms ({row[p]['max_rel_err']:.1e}, "
        f"S={row[p]['splits']}, {row[p]['tflops']:.2f} TFLOP/s, bound {row[p]['bound_ms']:.4f} ms "
        f"by {row[p]['bound_by']})"
        for p in ("fwd", "dx", "dw") if p in row
    )
    print(
        f"  {label:>9} K={row['K']:<3} {row['cin']:>3}->{row['cout']:<3} "
        f"rows {row['n_in']:>5}->{row['n_out']:<5}  kernel/plain {parts}"
    )
    return row


def step_sums(rows):
    """Per-part sums over a step's calls: (kernel ms, plain ms, bound ms,
    bound ms of the calls whose operations set the bound)."""
    sums = {}
    for p in ("fwd", "dx", "dw"):
        parts = [r[p] for r in rows if p in r]
        sums[p] = (
            sum(q["ms"] for q in parts), sum(q["plain_ms"] for q in parts),
            sum(q["bound_ms"] for q in parts),
            sum(q["bound_ms"] for q in parts if q["bound_by"] == "operations"),
        )
    return sums


def print_sums(sums):
    for p, name in (("fwd", "K1 forward"), ("dx", "K1 input gradient"), ("dw", "K2 weight gradient")):
        ms, plain, bnd, ops = sums[p]
        print(
            f"  sum over one step, {name}: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {bnd:.4f} ms ({ops:.4f} ms of it in operations-bound calls)"
        )


def median(values: dict) -> float:
    return sorted(values.values())[len(values) // 2]


def rel_diff(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale > 0 else (got - want).abs().max().item()


def take_launches(total):
    """Read the launch counts after a main-path phase (they were set to 0
    just before it), add them to ``total`` and return them."""
    got = {"gather_gemm": gather_gemm.launches, "conv_dw": conv_dw.launches}
    for k, v in got.items():
        total[k] += v
    return got


def set_dropout(model, on):
    for m in model.modules():
        if isinstance(m, MinkowskiDropout):
            m.train(on)


def cpu_steps(run, tag, unit):
    """A training step on the CPU plain path in float32 and float64:
    ``run(dtype)`` returns (loss, model, rows).  Returns {dtype: (loss,
    float64 gradients, float64 running statistics)}."""
    cpu = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        loss, net, n = run(dtype)
        print(f"[{tag}] CPU plain-path step, {dtype}, {n} {unit}: {time.perf_counter() - t0:.1f} s")
        cpu[dtype] = (
            loss.item(),
            {k: p.grad.double() for k, p in net.named_parameters()},
            {k: v.double() for k, v in net.state_dict().items() if "running" in k},
        )
    return cpu


def judge_step(tag, loss0, grads0, stats0, cpu):
    """The card's step (loss, every parameter gradient, the batch norms'
    running statistics) against the CPU float32 run, each gradient judged
    against the float64 run (GRAD_FACTOR)."""
    (loss32, grads32, stats32), (_, grads64, _) = cpu[torch.float32], cpu[torch.float64]
    loss_rel = abs(loss32 - loss0) / abs(loss32)
    if set(grads32) != set(grads0):
        raise AssertionError(f"{tag}: the card's and the CPU's parameters differ")
    card_vs_cpu = {k: rel_diff(grads0[k].double(), grads32[k]) for k in grads0}
    card_err = {k: rel_diff(grads0[k].double(), grads64[k]) for k in grads0}
    cpu_err = {k: rel_diff(grads32[k], grads64[k]) for k in grads0}
    bound = {k: GRAD_FACTOR * max(cpu_err[k], median(cpu_err)) for k in grads0}
    stat_rel = {k: rel_diff(v.double(), stats32[k]) for k, v in stats0.items()}
    worst = max(card_vs_cpu, key=card_vs_cpu.get)
    worst64 = max(card_err, key=card_err.get)
    tightest = max(card_err, key=lambda k: card_err[k] / bound[k])
    worst_stat = max(stat_rel, key=stat_rel.get)
    print(
        f"  loss {loss0:.7f} (card) vs {loss32:.7f} (CPU): rel {loss_rel:.2e}\n"
        f"  {len(grads0)} gradients, card vs CPU float32: worst {worst} {card_vs_cpu[worst]:.2e}, "
        f"median {median(card_vs_cpu):.2e}\n"
        f"  against float64: card median {median(card_err):.2e}, worst {worst64} "
        f"{card_err[worst64]:.2e}; CPU float32 median {median(cpu_err):.2e}, worst "
        f"{max(cpu_err.values()):.2e}\n"
        f"  closest to its bound: {tightest} card {card_err[tightest]:.2e}, CPU float32 "
        f"{cpu_err[tightest]:.2e}, bound {bound[tightest]:.2e}\n"
        f"  {len(stat_rel)} running stats, worst {worst_stat} {stat_rel[worst_stat]:.2e}"
    )
    if not (loss_rel <= LOSS_RTOL and card_err[tightest] <= bound[tightest]
            and stat_rel[worst_stat] <= LOGIT_RTOL):
        raise AssertionError(f"{tag}: training step disagrees with the CPU plain path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"[1 device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, capability {torch.cuda.get_device_capability(0)}"
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    path = build.library_path()
    build.library()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())

    coords0, feats0 = scan(0)
    mgr = MT.CoordinateManager(D=3, device=dev)
    key, _ = mgr.insert_and_map(torch.from_numpy(coords0))
    level_rows = pyramid(mgr, key, (1, 2, 4, 8, 16))

    # 3. kernel check, synthetic maps
    print(f"[3 kernel check, synthetic maps] level rows {level_rows}")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, K, cin, cout, ts_in, ts_out in SLICE_SHAPES:
        n_in, n_out = level_rows[ts_in], level_rows[ts_out]
        x = torch.randn(n_in, cin, device=dev, generator=gen)
        w = torch.randn(K, cin, cout, device=dev, generator=gen) / (K * cin) ** 0.5
        idx = torch.randint(0, n_in, (K, n_out), device=dev, generator=gen, dtype=torch.int32)
        idx[torch.rand(K, n_out, device=dev, generator=gen) < 0.3] = -1
        rows.append(compare(x, w, idx, name))

    # 4. kernel check on the real maps of one forward
    model = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).eval()
    calls = []
    convs = sparse_convs(model)
    hooks = [m.register_forward_hook(lambda m, a, o: calls.append((m, a[0], o))) for m in convs]
    answer(model, coords0, feats0, dev)  # warm-up request
    for h in hooks:
        h.remove()
    if len(calls) != MIN_LAUNCHES:
        raise AssertionError(f"captured {len(calls)} sparse conv calls, expected {MIN_LAUNCHES}")
    print(f"[4 kernel check, room-scan maps] {len(calls)} conv calls of one forward")
    real = []
    for i, (m, inp, out) in enumerate(calls):
        kmap = m._kernel_map(inp, out.coordinate_map_key)
        real.append(compare(inp.F, m.kernel.detach(), kmap.in_idx, f"call{i}"))
    del calls
    kernel_ms = sum(r["ms"] for r in real)
    plain_ms = sum(r["plain_ms"] for r in real)
    print(f"  sum over one forward: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms")

    # 5. the inference slice: three requests, counted
    requests = [(s, *scan(s)) for s in (0, 1, 2)]
    answers = []
    gather_gemm.launches = conv_dw.launches = 0
    for seed, coords, feats in requests:
        before = gather_gemm.launches
        logits, secs = answer(model, coords, feats, dev)
        launched = gather_gemm.launches - before
        answers.append(logits)
        print(
            f"[5 slice] request seed {seed}: {len(coords)} voxels, {secs * 1e3:.2f} ms, "
            f"{len(coords) / secs:.0f} points/s, {launched} gather_gemm launches"
        )
        if launched < MIN_LAUNCHES:
            raise AssertionError(f"only {launched} kernel launches in the request")
        if logits.shape != (len(coords), 20) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    if conv_dw.launches:
        raise AssertionError(f"inference launched conv_dw {conv_dw.launches} times")
    launches = {"gather_gemm": 0, "conv_dw": 0}
    take_launches(launches)

    # 6. parity with the CPU plain path
    cpu_model = MinkUNet34(
        3, 20, D=3, generator=torch.Generator().manual_seed(0), device="cpu"
    ).eval()
    for (k, a), b in zip(model.state_dict().items(), cpu_model.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"CPU model weights differ at {k}")
    with torch.no_grad():
        ref = cpu_model(
            MT.SparseTensor(torch.from_numpy(requests[0][2]), torch.from_numpy(requests[0][1]))
        ).F
    rel = ((answers[0] - ref).abs().max() / ref.abs().max()).item()
    print(f"[6 parity] CUDA vs CPU plain-path logits: max|d|/max|ref| = {rel:.2e}")
    if not rel <= LOGIT_RTOL:
        raise AssertionError(f"logits disagree: {rel:.3e} > {LOGIT_RTOL}")
    del cpu_model, requests, answers

    # the training data: 2 scans per step, seeds 0-7
    raw = [[scan(BATCH * s + b) for b in range(BATCH)] for s in range(TRAIN_STEPS)]
    batches = [collate(r) for r in raw]
    labels = [labels_for(s, len(c)) for s, (c, _) in enumerate(batches)]

    # 7. backward kernels, synthetic maps at the training batch's row counts
    mgr = MT.CoordinateManager(D=3, device=dev)
    key, _ = mgr.insert_and_map(batches[0][0])
    train_rows = pyramid(mgr, key, (1, 2, 4, 8, 16))
    shape_batch = shapes(0, CoordinateTransformation())  # phase 13's first batch
    x0 = field(shape_batch[0], shape_batch[1], dev).sparse()
    class_rows = pyramid(x0.coordinate_manager, x0.coordinate_map_key, (1, 2, 4, 8, 16, 32, 64))
    del x0
    print(
        f"[7 backward kernels, synthetic maps] level rows {train_rows}; classification batch "
        f"{class_rows}; bound: max(2 * pairs * Cin * Cout / {TF32_PEAK / 1e12:.0f} TFLOP/s TF32, "
        f"bytes / {HBM_RATE / 1e12:.2f} TB/s); 3xTF32 runs at most a third of that peak"
    )
    synth_bwd = []
    for name, K, cin, cout, ts_in, ts_out, rows_at in [
        (*shape, train_rows) for shape in SLICE_SHAPES
    ] + [(*shape, class_rows) for shape in CLASSIFICATION_SHAPES]:
        n_in, n_out = rows_at[ts_in], rows_at[ts_out]
        in_idx = injective_map(K, n_in, n_out, gen, dev)
        x = torch.randn(n_in, cin, device=dev, generator=gen)
        w = torch.randn(K, cin, cout, device=dev, generator=gen) / (K * cin) ** 0.5
        g = torch.randn(n_out, cout, device=dev, generator=gen)
        synth_bwd.append(backward_rows(x, w, g, in_idx, _invert_matching(in_idx, n_in), name))

    # 8. backward kernels on the real maps of one training step
    model.train()
    calls, grads, _ = capture_step(convs, lambda: train_step(model, None, *batches[0], labels[0], dev))
    if len(calls) != MIN_LAUNCHES or len(grads) != MIN_LAUNCHES:
        raise AssertionError(f"captured {len(calls)} calls and {len(grads)} output gradients")
    print(f"[8 backward kernels, training-step maps] {len(calls)} conv calls")
    real_bwd = []
    for i, (m, inp, out) in enumerate(calls):
        kmap = m._kernel_map(inp, out.coordinate_map_key)
        real_bwd.append(backward_rows(
            inp.F.detach(), m.kernel.detach(), grads[i].contiguous(), kmap.in_idx,
            kmap.out_idx_t, f"call{i}", with_dx=inp.F.requires_grad,
        ))
    del calls, grads
    model.zero_grad(set_to_none=True)
    print_sums(step_sums(real_bwd))

    # 9. the training slice: four steps, counted
    net = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).train()
    init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    opt = torch.optim.SGD(net.parameters(), lr=LR)
    torch.cuda.reset_peak_memory_stats()
    gather_gemm.launches = conv_dw.launches = 0
    for step, (scans, lab) in enumerate(zip(raw, labels)):
        fwd_dx, dw = gather_gemm.launches, conv_dw.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coords, feats = collate(scans)
        loss, out = train_step(net, opt, coords, feats, lab, dev)
        if step == 0:
            loss0 = loss.item()
            grads0 = {k: p.grad.detach().cpu().clone() for k, p in net.named_parameters()}
        opt.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_fwd_dx, n_dw = gather_gemm.launches - fwd_dx, conv_dw.launches - dw
        print(
            f"[9 train] step {step}: {len(coords)} voxels, {secs * 1e3:.2f} ms, "
            f"{len(coords) / secs:.0f} points/s, loss {loss.item():.6f}, "
            f"{n_fwd_dx} gather_gemm and {n_dw} conv_dw launches"
        )
        if n_fwd_dx < MIN_LAUNCHES + MIN_DX_LAUNCHES or n_dw != MIN_LAUNCHES:
            raise AssertionError(f"step {step}: {n_fwd_dx} gather_gemm, {n_dw} conv_dw launches")
        if out.F.shape != (len(coords), 20) or not torch.isfinite(loss):
            raise AssertionError(f"step {step}: logits {tuple(out.F.shape)}, loss {loss.item()}")
        if step == 0:
            stats0 = {k: v.cpu().clone() for k, v in net.state_dict().items() if "running" in k}
        del loss, out
    take_launches(launches)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 10. gradient parity with the CPU plain path: step 0 again in float32,
    # and in float64 as the yardstick of float32 rounding
    def cpu_unet_step(dtype):
        cpu_net = MinkUNet34(3, 20, D=3, device="cpu").train()
        cpu_net.load_state_dict(init)
        cpu_net.to(dtype)
        coords, feats = batches[0]
        loss, _ = train_step(cpu_net, None, coords, feats.to(dtype), labels[0], "cpu")
        return loss, cpu_net, len(coords)

    judge_step("10 parity", loss0, grads0, stats0, cpu_steps(cpu_unet_step, "10 parity", "voxels"))

    # 11. classification inference: three batches of 32 shapes, counted
    fcnn = MinkowskiFCNN(
        3, CLASSES, generator=torch.Generator().manual_seed(0), device=dev, **FCNN_WIDTHS
    ).eval()
    fcnn_init = {k: v.detach().cpu().clone() for k, v in fcnn.state_dict().items()}
    fcnn_convs = sparse_convs(fcnn)
    if len(fcnn_convs) != FCNN_CONVS:
        raise AssertionError(f"MinkowskiFCNN has {len(fcnn_convs)} sparse convs")
    batches11 = [shapes(s) for s in (0, 1, 2)]
    classify(fcnn, *batches11[0][:2], dev)  # warm-up: allocator, cuBLAS
    logits11 = []
    gather_gemm.launches = conv_dw.launches = 0
    for seed, (coords, feats, _) in enumerate(batches11):
        before = gather_gemm.launches
        logits, secs = classify(fcnn, coords, feats, dev)
        launched = gather_gemm.launches - before
        logits11.append(logits)
        print(
            f"[11 classify] batch seed {seed}: {len(coords)} points, {secs * 1e3:.2f} ms, "
            f"{len(coords) / secs:.0f} points/s, {launched} gather_gemm launches"
        )
        if launched < FCNN_CONVS:
            raise AssertionError(f"only {launched} kernel launches in the batch")
        if logits.shape != (SHAPES, CLASSES) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    if conv_dw.launches:
        raise AssertionError(f"inference launched conv_dw {conv_dw.launches} times")
    take_launches(launches)

    # 12. kernels on the real maps of one FCNN training step, dropout off
    fcnn.train()
    set_dropout(fcnn, False)
    fcnn.zero_grad(set_to_none=True)
    calls, grads, (loss, _) = capture_step(
        fcnn_convs, lambda: fcnn_step(fcnn, *shape_batch, dev)
    )
    if len(calls) != FCNN_CONVS or len(grads) != FCNN_CONVS:
        raise AssertionError(f"captured {len(calls)} calls and {len(grads)} output gradients")
    fcnn_loss0 = loss.item()
    fcnn_grads0 = {k: p.grad.detach().cpu().clone() for k, p in fcnn.named_parameters()}
    fcnn_stats0 = {k: v.cpu().clone() for k, v in fcnn.state_dict().items() if "running" in k}
    print(f"[12 kernels, FCNN training-step maps] {len(calls)} conv calls")
    fcnn_bwd = []
    for i, (m, inp, out) in enumerate(calls):
        kmap = m._kernel_map(inp, out.coordinate_map_key)
        fcnn_bwd.append(backward_rows(
            inp.F.detach(), m.kernel.detach(), grads[i].contiguous(), kmap.in_idx,
            kmap.out_idx_t, f"fcnn{i}", with_dx=inp.F.requires_grad,
        ))
    del calls, grads, loss, fcnn
    print_sums(step_sums(fcnn_bwd))

    # 13. classification training: four SGD steps, counted
    net = MinkowskiFCNN(
        3, CLASSES, generator=torch.Generator().manual_seed(0), device=dev, **FCNN_WIDTHS
    ).train()
    for m in net.modules():
        if isinstance(m, MinkowskiDropout):
            m.generator = torch.Generator(device=dev).manual_seed(0)
    opt = torch.optim.SGD(
        net.parameters(), lr=FCNN_LR, momentum=FCNN_MOMENTUM, weight_decay=FCNN_WD
    )
    batches13 = [shape_batch] + [shapes(s, CoordinateTransformation()) for s in (1, 2, 3)]
    torch.cuda.reset_peak_memory_stats()
    gather_gemm.launches = conv_dw.launches = 0
    for step, (coords, feats, lab) in enumerate(batches13):
        fwd_dx, dw = gather_gemm.launches, conv_dw.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss, logits = fcnn_step(net, coords, feats, lab, dev)
        opt.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_fwd_dx, n_dw = gather_gemm.launches - fwd_dx, conv_dw.launches - dw
        print(
            f"[13 train classifier] step {step}: {len(coords)} points, {secs * 1e3:.2f} ms, "
            f"{len(coords) / secs:.0f} points/s, loss {loss.item():.6f}, "
            f"{n_fwd_dx} gather_gemm and {n_dw} conv_dw launches"
        )
        if n_fwd_dx < 2 * FCNN_CONVS or n_dw != FCNN_CONVS:
            raise AssertionError(f"step {step}: {n_fwd_dx} gather_gemm, {n_dw} conv_dw launches")
        if logits.shape != (SHAPES, CLASSES) or not torch.isfinite(loss):
            raise AssertionError(f"step {step}: logits {tuple(logits.shape)}, loss {loss.item()}")
        del loss, logits
    take_launches(launches)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del net, opt

    # 14. classification parity with the CPU plain path
    # (a) batch 0's logits in eval mode
    cpu_fcnn = MinkowskiFCNN(3, CLASSES, device="cpu", **FCNN_WIDTHS).eval()
    cpu_fcnn.load_state_dict(fcnn_init)
    with torch.no_grad():
        ref = cpu_fcnn(field(*batches11[0][:2], "cpu"))
    rel = rel_diff(logits11[0], ref)
    print(f"[14a parity] FCNN logits, CUDA vs CPU plain path: max|d|/max|ref| = {rel:.2e}")
    if not rel <= LOGIT_RTOL:
        raise AssertionError(f"FCNN logits disagree: {rel:.3e} > {LOGIT_RTOL}")
    del cpu_fcnn

    # (b) phase 12's step, dropout off, in float32 and float64 on the CPU
    def cpu_fcnn_step(dtype):
        cpu_net = MinkowskiFCNN(3, CLASSES, device="cpu", **FCNN_WIDTHS).train()
        cpu_net.load_state_dict(fcnn_init)
        cpu_net.to(dtype)
        set_dropout(cpu_net, False)
        coords, feats, lab = shape_batch
        loss, _ = fcnn_step(cpu_net, coords, torch.from_numpy(feats).to(dtype), lab, "cpu")
        return loss, cpu_net, len(coords)

    judge_step(
        "14b parity", fcnn_loss0, fcnn_grads0, fcnn_stats0,
        cpu_steps(cpu_fcnn_step, "14b parity", "points"),
    )

    # (c) ResNet18 on batch 0, voxelized by the TensorField
    rn = ResNet18(3, CLASSES, D=3, generator=torch.Generator().manual_seed(0), device=dev).eval()
    rn_convs = len(sparse_convs(rn))
    coords, feats, _ = batches11[0]
    gather_gemm.launches = conv_dw.launches = 0
    with torch.no_grad():
        rn_logits = rn(field(coords, feats, dev).sparse())
    rn_launched = take_launches(launches)
    rn_logits = rn_logits.F.cpu()
    if rn_launched["gather_gemm"] != rn_convs or rn_launched["conv_dw"]:
        raise AssertionError(f"ResNet18: {rn_launched} launches for {rn_convs} sparse convs")
    if rn_logits.shape != (SHAPES, CLASSES) or not torch.isfinite(rn_logits).all():
        raise AssertionError(f"ResNet18: bad logits, shape {tuple(rn_logits.shape)}")
    rn_init = {k: v.cpu() for k, v in rn.state_dict().items()}
    del rn
    rn_cpu = {}
    for dtype in (torch.float32, torch.float64):
        cpu_rn = ResNet18(3, CLASSES, D=3, device="cpu").eval()
        cpu_rn.load_state_dict(rn_init)
        cpu_rn.to(dtype)
        with torch.no_grad():
            rn_cpu[dtype] = cpu_rn(field(coords, torch.from_numpy(feats).to(dtype), "cpu").sparse()).F
    del cpu_rn
    rel = rel_diff(rn_logits.double(), rn_cpu[torch.float32].double())
    card64 = rel_diff(rn_logits.double(), rn_cpu[torch.float64])
    cpu64 = rel_diff(rn_cpu[torch.float32].double(), rn_cpu[torch.float64])
    print(
        f"[14c parity] ResNet18, {rn_convs} sparse convs, {rn_launched['gather_gemm']} gather_gemm "
        f"launches; logits CUDA vs CPU float32 {rel:.2e}; against float64: card {card64:.2e}, "
        f"CPU float32 {cpu64:.2e}"
    )
    # instance norm over the few rows each shape keeps at strides 64-192
    # can amplify float32 rounding past LOGIT_RTOL; then the card is held,
    # as in phase 10, to GRAD_FACTOR times the CPU float32 run's error
    if not (rel <= LOGIT_RTOL or card64 <= GRAD_FACTOR * cpu64):
        raise AssertionError(f"ResNet18 logits disagree: {rel:.3e} > {LOGIT_RTOL}")

    bwd = synth_bwd + real_bwd + fcnn_bwd
    errors = {
        "gather_gemm": [r["max_abs_err"] for r in rows + real]
        + [r[p]["max_abs_err"] for r in bwd for p in ("fwd", "dx") if p in r],
        "conv_dw": [r["dw"]["max_abs_err"] for r in bwd],
    }
    # per training step of MinkUNet34 and of MinkowskiFCNN, on their real maps
    sums = step_sums(real_bwd + fcnn_bwd)
    timing = {
        "gather_gemm": [a + b for a, b in zip(sums["fwd"], sums["dx"])],
        "conv_dw": sums["dw"],
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": max(errors[name]),
        "ms": timing[name][0],
        "plain_ms": timing[name][1],
        "bound_ms": timing[name][2],
        "bound_by": "operations" if 2 * timing[name][3] >= timing[name][2] else "bytes",
        "library_ms": None,  # no one PyTorch call gathers rows by a map and multiplies
    } for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
