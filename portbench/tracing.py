"""What a ``--trace 1`` run records, from outside the program.

- ``Tracer.span``: the benchmark's own host ranges around the calls into
  each layer (``load``, ``sparse_tensor``, ``forward``, ``loss``,
  ``backward``, ``optimizer``), as ``torch.profiler`` user annotations.
- ``HostClock``: host time inside ``CoordinateManager``'s public calls
  (the outermost of nested calls) and inside the generative decoder's
  ``keep.any()`` syncs, by wrapping them from outside, as
  ``tools/profile_request.py`` does; each call is also a range
  ``coords.<method>``.
- ``ConvRanges``: a range around every sparse conv module's forward (module
  hooks) and backward (hooks on its output's autograd node), and each
  call's input and output coordinates, from which the yardstick counts its
  pairs.
- ``read_trace``: the profiler's Chrome trace reduced to device intervals,
  the kernels launched inside conv ranges, and the idle gaps labelled by
  the innermost host range at their midpoint.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
from bisect import bisect_right
from collections import defaultdict

import torch

from . import yardstick as Y

PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COORDINATE_CALLS = (
    "insert_and_map", "insert_field", "stride", "stride_region", "kernel_map", "merge",
    "union_map", "prune", "origin", "origin_map", "stride_map", "field_to_sparse_insert_and_map",
    "field_to_sparse_map", "interpolation_map_weight",
)


class Tracer:
    """Host ranges, on only in a traced run."""

    def __init__(self, on: bool):
        self.on = on

    def span(self, name):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)


class HostClock:
    """Host seconds inside the coordinate manager's calls (outermost only)
    and inside ``bool(keep.any())`` of ``generative_levels``, the decoder
    loop, found by its name; ``keep_any_n`` counts those syncs, and
    ``tests/test_portbench_tracing.py`` fails where a completion step
    counts none of them."""

    def __init__(self, manager_cls, tracer: Tracer):
        self.cls, self.tracer = manager_cls, tracer
        self.seconds = 0.0
        self.keep_any_n = 0
        self._depth = 0

    def __enter__(self):
        self._saved = {n: getattr(self.cls, n) for n in COORDINATE_CALLS if hasattr(self.cls, n)}
        for name, fn in self._saved.items():
            setattr(self.cls, name, self._timed(name, fn))
        self._bool = torch.Tensor.__bool__
        clock, original = self, torch.Tensor.__bool__

        def timed_bool(t):
            if sys._getframe(1).f_code.co_name != "generative_levels":
                return original(t)
            t0 = time.perf_counter()
            with clock.tracer.span("coords.keep_any"):
                try:
                    return original(t)
                finally:
                    clock.seconds += time.perf_counter() - t0
                    clock.keep_any_n += 1

        torch.Tensor.__bool__ = timed_bool
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.cls, name, fn)
        torch.Tensor.__bool__ = self._bool

    def _timed(self, name, fn):
        clock = self

        def call(*args, **kw):
            if clock._depth:
                return fn(*args, **kw)
            clock._depth += 1
            t0 = time.perf_counter()
            try:
                with clock.tracer.span(f"coords.{name}"):
                    return fn(*args, **kw)
            finally:
                clock._depth -= 1
                clock.seconds += time.perf_counter() - t0
        return call


class ConvRanges:
    """Ranges around every sparse conv call, and the calls' shapes."""

    def __init__(self, model, conv_cls, training: bool):
        self.training = training
        self.record = False
        self.calls = []
        self._hooks = []
        for m in model.modules():
            if isinstance(m, conv_cls):
                self._hooks.append(m.register_forward_pre_hook(self._enter))
                self._hooks.append(m.register_forward_hook(self._exit))

    def _enter(self, module, args):
        module._portbench_range = torch.autograd.profiler.record_function(PREFIX + "conv.fwd")
        module._portbench_range.__enter__()

    def _exit(self, module, args, out):
        module._portbench_range.__exit__(None, None, None)
        x = args[0]
        sparse = not getattr(module, "use_mm", False)
        node = out.F.grad_fn
        if sparse and node is not None:
            state = {}

            def pre(grad_outputs):
                state["r"] = torch.autograd.profiler.record_function(PREFIX + "conv.bwd")
                state["r"].__enter__()

            def post(grad_inputs, grad_outputs):
                state.pop("r").__exit__(None, None, None)

            node.register_prehook(pre)
            node.register_hook(post)
        if self.record:
            kg = module.kernel_generator
            self.calls.append(dict(
                sparse=sparse, transposed=bool(module.is_transpose),
                kernel_size=int(kg.kernel_size[0]), volume=int(kg.kernel_volume),
                in_coords=x.C, out_coords=out.C,
                in_stride=int(x.tensor_stride[0]), out_stride=int(out.tensor_stride[0]),
                cin=int(module.in_channels), cout=int(module.out_channels),
                dx=self.training and x.F.requires_grad, dw=self.training,
            ))

    def close(self):
        for h in self._hooks:
            h.remove()


def conv_work(calls, precision):
    """(useful operations of every conv call, summed bound seconds of the
    sparse ones), counting pairs from coordinates with the yardstick's own
    lookup."""
    from .reference import plain

    flop_total, bound_total = 0.0, 0.0
    for c in calls:
        n_in, n_out = c["in_coords"].shape[0], c["out_coords"].shape[0]
        if c["sparse"]:
            scale = c["out_stride"] if c["transposed"] else c["in_stride"]
            pairs = plain.count_pairs(c["in_coords"], c["out_coords"], c["kernel_size"], scale,
                                      c["transposed"])
        else:
            pairs = n_in  # a volume-1 product: one pair per row
        for part in Y.PARTS:
            if part == "dx" and not c["dx"] or part == "dw" and not c["dw"]:
                continue
            flop, nbytes = Y.conv_work(pairs, n_in, n_out, c["volume"], c["cin"], c["cout"], part)
            flop_total += flop
            if c["sparse"]:
                bound_total += Y.bound_s(flop, nbytes, precision)
    return flop_total, bound_total


@contextlib.contextmanager
def profiled():
    """Profile the enclosed steps; yields a dict that holds, after exit,
    the Chrome trace's events."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield out
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f).get("traceEvents", [])


def ranges(host, prefix):
    """Sorted (start, end) of the host ranges whose name starts with ``prefix``."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in host if e["name"].startswith(prefix))


def inside(rs, t):
    """Whether ``t`` lies in one of ``rs``, ranges that never overlap."""
    i = bisect_right(rs, (t, float("inf"))) - 1
    return i >= 0 and rs[i][1] >= t


def in_conv_ranges(xs, device):
    """The device events launched inside a conv range and outside the
    coordinate manager's calls: by the host time of the launch that the
    event's correlation id names."""
    host = [e for e in xs if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]
    conv, coords = ranges(host, PREFIX + "conv."), ranges(host, PREFIX + "coords.")
    launch = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = e["ts"]
    out = []
    for e in device:
        t = launch.get((e.get("args") or {}).get("correlation"))
        if t is not None and inside(conv, t) and not inside(coords, t):
            out.append(e)
    return out


def read_trace(events):
    """Device intervals, conv device seconds, idle gaps by host range, and
    device seconds by operation, within the stretch of the ``step`` ranges."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    host = [e for e in xs if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]
    steps = [e for e in host if e["name"] == PREFIX + "step"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not steps or not device:
        return None
    lo = min(e["ts"] for e in steps)
    hi = max(e["ts"] + e["dur"] for e in steps)
    device = [e for e in device if lo <= e["ts"] <= hi]
    intervals = [(e["ts"], min(e["ts"] + e["dur"], hi)) for e in device]
    busy_us = Y.union_length(intervals)

    conv_us = sum(e["dur"] for e in in_conv_ranges(xs, device))

    by_op = defaultdict(float)
    for e in device:
        by_op[e["name"][:160]] += e["dur"] * 1e-6
    labelled = defaultdict(float)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in host
                   if e["name"] != PREFIX + "step")
    active, j = [], 0
    for s, e in Y.gaps(intervals, lo, hi):  # a sweep: gaps in order, the ranges open at each
        mid = 0.5 * (s + e)
        while j < len(spans) and spans[j][0] <= mid:
            active.append(spans[j])
            j += 1
        active = [a for a in active if a[1] >= mid]
        name = min(active, key=lambda a: a[1] - a[0])[2] if active else "between steps"
        labelled[name] += (e - s) * 1e-6
    return dict(
        window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6, device_ops=len(device),
        conv_device_s=conv_us * 1e-6, breakdown={"device_ops": _top(by_op), "idle_gaps": _top(labelled)},
    )


def _top(totals, n=10):
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]
