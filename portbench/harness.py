"""One run of one cell: set-up, the measured window, the comparison, and
the result line.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic kind
(``traffic/<kind>.py``), the limits of its comparison and its traffic
parameters; a configuration names its plain reference
(``reference/<name>.py``); each per-layer metric of ``BENCHMARK.json`` is
read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import tracing
from . import yardstick as Y
from .traffic.common import reference_module

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "minkowskiengine_tpu")
WARMUP_STEPS = 2
PROFILED_STEPS = 3
PROFILE_AFTER = 0.3  # share of the window before the profiled steps


def load_cell(name, bench=BENCH):
    cell = json.loads((bench / "workloads" / f"{name}.json").read_text())
    cell["config"] = json.loads((bench / "configs" / f"{cell['config']}.json").read_text())
    return cell


def traffic_class(kind):
    return importlib.import_module(f"portbench.traffic.{kind}").Traffic


def reader(metric, bench=BENCH):
    """``read(summary)`` of ``metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def benchmark(root=ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric, cell_name, reported=None):
    """Whether a metric of BENCHMARK.json is reported in this cell: by its
    ``workloads``, or where the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def make_weights(spec, seed, device):
    """Every parameter of a configuration from ``seed``: one uniform draw
    on the device, cut into leaves and scaled by each leaf's bound;
    batch norms' weights 1 and biases 0."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    total = sum(math.prod(shape) for _, shape, stdv in spec if stdv is not None)
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, offset = {}, 0
    for name, shape, stdv in spec:
        if stdv is None:
            fill = 1.0 if name.endswith(".weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[offset:offset + n].view(shape).mul_(stdv)
        offset += n
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i",
             str(device.index or 0)], capture_output=True, text=True, timeout=30,
        )
        info["power_limit_w"] = float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return info


class Window:
    """The closed loop: steps until ``seconds`` have passed; in a traced run
    ``PROFILED_STEPS`` of them under the profiler, the rest timed alone."""

    def __init__(self, traffic, seconds, trace, clock, convs):
        self.traffic, self.seconds, self.trace = traffic, seconds, trace
        self.clock, self.convs = clock, convs
        self.step_s, self.coords_s, self.results, self.profile = [], [], [], None

    def _one(self):
        before = self.clock.seconds if self.clock else 0.0
        t0 = time.perf_counter()
        with self.traffic.tracer.span("step"):
            r = self.traffic.step()
        self.step_s.append(time.perf_counter() - t0)
        self.results.append(r)
        if self.clock:
            self.coords_s.append(self.clock.seconds - before)

    def run(self):
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0
            if self.trace and self.profile is None and elapsed >= PROFILE_AFTER * self.seconds:
                self._profiled()
            else:
                self._one()
            if time.perf_counter() - t0 >= self.seconds and (not self.trace or self.profile):
                break
        self.elapsed = time.perf_counter() - t0

    def _profiled(self):
        self.convs.record = True
        first = len(self.step_s)
        with tracing.profiled() as prof:
            for _ in range(PROFILED_STEPS):
                self._one()
        self.convs.record = False
        self.profile = prof
        self.profiled = set(range(first, first + PROFILED_STEPS))

    def unprofiled(self, values):
        skip = self.profiled if self.profile else set()
        return [v for i, v in enumerate(values) if i not in skip]


def run_cell(cell, seed, seconds, trace, device, t_start, bench_spec, mt, fault=None):
    """One run: returns (result line as a dict, [(check, value, limit)],
    every number the comparison read)."""
    device = torch.device(device)
    name = cell["name"]
    spec = reference_module(cell["config"]).parameter_spec(cell["config"])
    tracer = tracing.Tracer(bool(trace))
    traffic = traffic_class(cell["kind"])(cell, seed, device, tracer)
    traffic.fault = fault
    weight_seed = cell["traffic"].get("weight_seed", seed)
    weights = make_weights(spec, weight_seed, device)
    traffic.setup(mt, weights, WARMUP_STEPS)
    del weights
    clock = convs = None
    if trace:
        clock = tracing.HostClock(mt.CoordinateManager, tracer).__enter__()
        convs = tracing.ConvRanges(traffic.model, mt.MinkowskiConvolutionBase, traffic.role == "train")
        with tracing.profiled():  # the profiler's own first start
            pass
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    window = Window(traffic, seconds, trace, clock, convs)
    window.run()
    attempted = len(window.step_s)
    q = statistics.quantiles(window.step_s, n=4) if attempted > 1 else window.step_s * 3
    print(f"window {window.elapsed:.3f} s, {attempted} steps, step ms quartiles "
          f"{q[0] * 1e3:.2f} {q[1] * 1e3:.2f} {q[2] * 1e3:.2f}, max {max(window.step_s) * 1e3:.2f}; "
          f"host transforms {traffic.transform_s:.3f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dev_info = device_info(device)
    dev_info["memory_peak_bytes"] = max(peak, setup_peak) if cuda else 0

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, "peak_mem_gib": peak / 2**30}
        if traffic.role == "train":
            values["train_samples_per_s"] = attempted * traffic.samples() / window.elapsed
        else:
            lat = [r * 1e3 for r in window.results]
            values["infer_p50_ms"] = Y.percentile(lat, 50)
            values["infer_p95_ms"] = Y.percentile(lat, 95)
        for m in bench_spec["end_to_end"]:
            if m["name"] in values and applies(m, name):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    breakdown = None
    if trace:
        clock.__exit__(None, None, None)
        convs.close()
        summary = summarize(traffic, window, convs, cell["config"].get("precision", "float32"))
        if summary.get("busy_s"):
            dev_info["busy_s"], dev_info["window_s"] = summary["busy_s"], summary["window_s"]
            breakdown = summary["breakdown"]
        reported = {m["name"] for m in bench_spec["end_to_end"] if applies(m, name)}
        for m in bench_spec["per_layer"]:
            if not applies(m, name, reported):
                continue
            value = reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del window.profile

    # the comparison, once the program's state is freed
    traffic.release()
    del window, convs
    if cuda:
        torch.cuda.empty_cache()
    weights = make_weights(spec, weight_seed, device)
    numbers = traffic.compare(traffic.record, traffic.reference(weights), weights)
    checks = [(k, float(numbers[k]), float(lim)) for k, lim in cell["limits"].items()]
    for k, v in numbers.items():
        if k not in cell["limits"]:
            print(f"reading {k} {float(v)!r} (not compared)", file=sys.stderr)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": 0,
        "metrics": metrics,
        "device": dev_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks, numbers


def summarize(traffic, window, convs, precision):
    """What the per-layer readers read."""
    summary = {"role": traffic.role, "peak_flops": Y.PEAK_FLOPS[precision],
               "on_card": traffic.device.type == "cuda"}
    summary["unprofiled_step_s"] = window.unprofiled(window.step_s)
    summary["coords_host_s"] = window.unprofiled(window.coords_s)
    n = len(window.profiled) if window.profile else 0
    summary["profiled_steps"] = n
    flop, bound = tracing.conv_work(convs.calls, precision)
    summary["flop_per_step"] = flop / n if n else None
    summary["conv_bound_s"] = bound
    read = tracing.read_trace(window.profile.get("events", [])) if window.profile else None
    if read:
        summary.update(read)
    return summary
