#!/usr/bin/env python3
"""Where the time of one MinkUNet34 inference request goes, on one CUDA card.

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
4. the profiler's table, by device time;

and, last, one JSON line with the numbers.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import minkowskiengine_tpu_torch as MT  # noqa: E402
from chip_smoke import answer, scan  # noqa: E402
from minkowskiengine_tpu_torch.models import MinkUNet34  # noqa: E402

K1_NAME = "gather_gemm_kernel"
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_request: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}")

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
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    k1 = [e for e in device if K1_NAME in e.name]
    device_us = busy_us((e.time_range.start, e.time_range.end) for e in device)
    k1_us = busy_us((e.time_range.start, e.time_range.end) for e in k1)
    wall_us = secs * 1e6
    if not device:
        raise AssertionError("the profiler recorded no device activity")
    print(
        f"[3 profiled request] wall {wall_us / 1e3:.2f} ms; device busy "
        f"{device_us / 1e3:.3f} ms in {len(device)} kernels and copies; gather_gemm "
        f"{k1_us / 1e3:.3f} ms in {len(k1)} launches ({100 * k1_us / device_us:.1f}% of "
        f"device time); device idle {100 * (1 - device_us / wall_us):.1f}% of the wall"
    )
    print("[4 profiler table]")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))

    print(json.dumps({
        "voxels": len(coords),
        "fresh_ms": fresh,
        "warm_manager_ms": cached,
        "coordinate_phase_ms": coord_ms,
        "profiled_wall_ms": wall_us / 1e3,
        "profiled_device_busy_ms": device_us / 1e3,
        "profiled_gather_gemm_ms": k1_us / 1e3,
        "profiled_gather_gemm_launches": len(k1),
        "profiled_idle_share": 1 - device_us / wall_us,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
