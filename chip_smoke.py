#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU: MinkUNet34 inference.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off, so every comparison below is full float32.
2. build: compile the CUDA kernels (``minkowskiengine_tpu_torch/csrc``) with
   nvcc for sm_90a and load them.
3. kernel check, synthetic maps: ``gather_gemm`` against its plain PyTorch
   version at every shape MinkUNet34's sparse convs give it (rows of each
   level of a 26k-voxel room scan, about 30% of indices -1).
4. kernel check, real maps: the same comparison on the 55 conv calls of one
   MinkUNet34 forward, captured with forward hooks; both timed per call.
5. slice: ``MinkUNet34(3, 20, D=3)`` (weights from torch.Generator seed 0,
   eval mode, no_grad) answers 3 room-scan requests of ~26k voxels, each
   with a fresh coordinate manager; wall time per request and points/s.
   The kernel's launch count must rise by >= 55 per request.
6. parity: request 0 again on the CPU plain path with the same weights; the
   logits must agree with the card's.

Then a JSON line describing each kernel and, last, the device line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.kernels import build
from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm, gather_gemm_reference
from minkowskiengine_tpu_torch.models import MinkUNet34
from minkowskiengine_tpu_torch.nn.conv import MinkowskiConvolutionBase
from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels

# f32 sums of up to K*Cin = 10,368 products taken in another order: the
# rounding differences grow like sqrt(K*Cin) * 2^-24 relative to the output
# scale, ~1e-6; 1e-5 leaves an order of magnitude.
KERNEL_RTOL = 1e-5
# logits after 55 conv layers and 33 batch norms, CUDA kernel vs CPU plain path
LOGIT_RTOL = 1e-4
MIN_LAUNCHES = 55  # K > 1 sparse convs per forward: 1 stem + 4 down + 46 block + 4 up
SOURCE = "minkowskiengine_tpu_torch/csrc/gather_gemm.cu"
REPLACES = "minkowskiengine_tpu/ops/pallas/conv_kernel.py:1105"

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


def compare(x, w, idx, label):
    """Kernel vs plain version on the same CUDA inputs; returns a row."""
    got = gather_gemm(x, w, idx)
    want = gather_gemm_reference(x, w, idx)
    torch.cuda.synchronize()
    abs_err = (got - want).abs().max().item() if want.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    rel = abs_err / scale if scale > 0 else abs_err
    if not (torch.isfinite(got).all() and rel <= KERNEL_RTOL):
        raise AssertionError(f"{label}: gather_gemm disagrees, max rel err {rel:.3e}")
    row = dict(
        label=label, K=w.shape[0], cin=w.shape[1], cout=w.shape[2], n_in=x.shape[0],
        n_out=idx.shape[1], pairs=int((idx >= 0).sum()), max_abs_err=abs_err,
        max_rel_err=rel,
        ms=cuda_ms(lambda: gather_gemm(x, w, idx)),
        plain_ms=cuda_ms(lambda: gather_gemm_reference(x, w, idx)),
    )
    print(
        f"  {label:>9} K={row['K']:<3} {row['cin']:>3}->{row['cout']:<3} "
        f"rows {row['n_in']:>5}->{row['n_out']:<5} pairs {row['pairs']:>8}  "
        f"rel err {rel:.1e}  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
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
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    coords0, feats0 = scan(0)
    mgr = MT.CoordinateManager(D=3, device=dev)
    key, _ = mgr.insert_and_map(torch.from_numpy(coords0))
    level_rows = {1: mgr.size(key)}
    for ts in (2, 4, 8, 16):
        key = mgr.stride(key, 2)
        level_rows[ts] = mgr.size(key)

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
    convs = [m for m in model.modules() if isinstance(m, MinkowskiConvolutionBase) and not m.use_mm]
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

    # 5. the slice: three requests, counted
    requests = [(s, *scan(s)) for s in (0, 1, 2)]
    answers = []
    gather_gemm.launches = 0
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
    launches = gather_gemm.launches

    # 6. parity with the CPU plain path
    cpu_model = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0)).eval()
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

    all_rows = rows + real
    print(json.dumps({"kernels": [{
        "name": "gather_gemm",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in all_rows),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
