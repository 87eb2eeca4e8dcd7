"""Profiling and timing helpers.

Counterpart of ``minkowskiengine_tpu/utils/profiling.py`` (``jax.profiler``
there)::

    with MT.utils.trace("runs/profile") as prof:
        train_step(...)              # then: prof.key_averages().table()

``trace`` records the CPU and, when a card is present, CUDA activity with
``torch.profiler`` and writes a Chrome trace under ``log_dir``;
``named_scope`` labels a region in it.  ``timer`` and ``Timer`` read the
host clock after a ``torch.cuda.synchronize()``, so device work queued in
the block is counted.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; the trace goes to ``log_dir`` (TensorBoard's
    profiler plugin or chrome://tracing reads it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def named_scope(name: str):
    """Label a region of the trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timer(name: str = "", sync: bool = True) -> Iterator[dict]:
    """Wall-clock a block; the result is in ``out["seconds"]``.  With
    ``sync`` the card is synchronized before and after."""
    out = {}
    if sync:
        _sync()
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        if sync:
            _sync()
        out["seconds"] = time.perf_counter() - t0
        if name:
            print(f"[timer] {name}: {out['seconds'] * 1e3:.3f} ms")


class Timer:
    """Accumulating timer, ``tic``/``toc`` (reference: src/utils.hpp:40);
    each call synchronizes the card."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def tic(self):
        _sync()
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        _sync()
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        return dt

    @property
    def average(self) -> float:
        return self.total / max(self.count, 1)
