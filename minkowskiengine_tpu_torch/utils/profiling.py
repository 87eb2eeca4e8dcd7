"""Profiling and timing helpers, and the port's own spans and counters.

Counterpart of ``minkowskiengine_tpu/utils/profiling.py`` (``jax.profiler``
there)::

    with MT.utils.trace("runs/profile") as prof:
        train_step(...)              # then: prof.key_averages().table()

``trace`` records the CPU and, when a card is present, CUDA activity with
``torch.profiler`` and writes a Chrome trace under ``log_dir``;
``named_scope`` labels a region in it.  ``timer`` and ``Timer`` read the
host clock after a ``torch.cuda.synchronize()``, so device work queued in
the block is counted.

**Spans.**  The port labels its own work in that trace: ranges named
``me.<name>`` (``span``), on the thread that ran them (the backward on
autograd's), nested as the calls nest.  They exist exactly when a profiler
records (``trace`` or any ``torch.profiler.profile``); otherwise ``span``
returns one shared no-op and costs one check.  The coordinate manager's
building calls are ``me.coords.<method>`` (a cache hit does no work and
has no span), with ``me.coords.unique``, ``me.coords.probe_grid``,
``me.coords.kernel_map.grid`` (on the card, the grid-probe kernel's one
launch for a map's halves that have a row grid),
``me.coords.kernel_map.in_idx`` and ``me.coords.kernel_map.out_idx_t``
(a half built in plain ops or by the key search) and
``me.coords.pool_map`` inside; the sparse conv is ``me.conv.fwd``,
``me.conv.dx`` and ``me.conv.dw`` around K1's and K2's launches
``me.k1.<body>`` and ``me.k2.<body>``; serialized attention (Point
Transformer V3) is ``me.attn.plan`` (a map's window plan),
``me.attn.fwd`` and ``me.attn.bwd`` (the gathers, the fused attention and
the scatter, and their backward), and ordering a map along its curves is
``me.coords.serialize``; Mask3D's query decoder and set criterion are
``me.mask3d.<part>`` (``levels``, ``fps``, ``posenc``, ``mask_module``
with ``.pool`` inside, ``cross_attn``, ``self_attn``, ``ffn``,
``criterion`` with ``.match`` inside); every host read of a device value
is ``me.sync.<site>``; tensor construction and the multi-op layers are
``me.tensor.*`` and ``me.nn.*``.

**Counters**, always on: a count and host seconds (``time.perf_counter``)
under five boundaries.  ``sync.<site>``: each host read at that site
(``host_read``), each of which waits for the card's queue to drain;
``coords``: the coordinate phase's outermost building calls (a nested call
is not counted again) and the generative decoder's keep read; ``conv``:
the sparse conv's forward and each part of its backward; ``attn``: each
part of serialized attention; ``mask3d``: each outer part of Mask3D's
decoder and criterion (their forward, on the host).  ::

    MT.utils.profiling.reset_counters()
    train_step(...)
    MT.utils.profiling.counters()
    # {"coords": {"count": 98, "seconds": 0.035}, "conv": {...},
    #  "sync.register_unique.bbox": {"count": 31, "seconds": 0.004}, ...}
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator

import torch

PREFIX = "me."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")  # a Chrome trace's device operations

_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter
_NOOP = contextlib.nullcontext()
# name -> [count, host seconds]; the backward adds from autograd's thread
_counts: Dict[str, list] = {}
_lock = threading.Lock()
_local = threading.local()


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; the trace goes to ``log_dir`` (TensorBoard's
    profiler plugin or chrome://tracing reads it).  The port's ``me.*``
    spans are in it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def device_operations(events) -> list:
    """The device operations (kernels, copies and memsets) among the
    events of a ``torch.profiler`` Chrome trace."""
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES]


def named_scope(name: str):
    """Label a region of the trace."""
    return torch.profiler.record_function(name)


def span(name: str):
    """The range ``me.<name>`` while a profiler records; else a shared
    no-op."""
    if _profiling():
        return torch.profiler.record_function(PREFIX + name)
    return _NOOP


def _add(key: str, seconds: float, n: int = 1) -> None:
    with _lock:
        c = _counts.get(key)
        if c is None:
            c = _counts[key] = [0, 0.0]
        c[0] += n
        c[1] += seconds


def _coords_depth() -> int:
    return getattr(_local, "coords_depth", 0)


class _Counted:
    """A counter boundary: adds ``n`` and the host seconds of the block to
    ``key``, and is the span ``me.<name>``.  ``outermost``: only where no
    other such block of the thread is open (the ``coords`` counter);
    ``also``: a second counter the block adds to, outside an outermost
    block."""

    __slots__ = ("key", "name", "outermost", "also", "n", "t0", "rf")

    def __init__(self, key, name, outermost=False, also=None, n=1):
        self.key, self.name, self.outermost, self.also, self.n = key, name, outermost, also, n

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        if self.outermost:
            _local.coords_depth = _coords_depth() + 1
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self.t0
        if self.outermost:
            depth = _local.coords_depth = _local.coords_depth - 1
            if depth == 0:
                _add(self.key, dt)
        else:
            _add(self.key, dt, self.n)
            if self.also is not None and _coords_depth() == 0:
                _add(self.also, dt)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def coords_call(method: str) -> _Counted:
    """A building call of the coordinate manager: the span
    ``me.coords.<method>``, and the ``coords`` counter where no other such
    call is open."""
    return _Counted("coords", "coords." + method, outermost=True)


def conv_part(part: str) -> _Counted:
    """One part of the sparse conv (``fwd``, ``dx``, ``dw``): the span
    ``me.conv.<part>`` and the ``conv`` counter."""
    return _Counted("conv", "conv." + part)


def attn_part(part: str) -> _Counted:
    """One part of serialized attention (``plan``, ``fwd``, ``bwd``): the
    span ``me.attn.<part>`` and the ``attn`` counter."""
    return _Counted("attn", "attn." + part)


def mask3d_part(part: str) -> _Counted:
    """One part of Mask3D's query decoder or of its set criterion
    (``levels``, ``fps``, ``posenc``, ``mask_module``, ``cross_attn``,
    ``self_attn``, ``ffn``, ``criterion``): the span ``me.mask3d.<part>``
    and the ``mask3d`` counter.  The parts nested in these (``.pool`` in
    ``mask_module``, ``.match`` in ``criterion``) are spans alone."""
    return _Counted("mask3d", "mask3d." + part)


def host_read(site: str, coords: bool = False, reads: int = 1) -> _Counted:
    """Around a host read of a device value (``.tolist()``, ``bool()``, a
    boolean-mask index, a copy from host memory that waits for the queue):
    the counter and span ``sync.<site>``, which counts ``reads`` (the
    block's waits for the card).  It reads nothing itself: the read stays
    in the caller's frame.  ``coords``: the read belongs to the coordinate
    phase and adds to ``coords`` too, outside its calls."""
    return _Counted("sync." + site, "sync." + site, also="coords" if coords else None, n=reads)


def counters() -> Dict[str, Dict[str, float]]:
    """A snapshot of every counter: ``{name: {"count", "seconds"}}``."""
    with _lock:
        return {k: {"count": c[0], "seconds": c[1]} for k, c in _counts.items()}


def reset_counters() -> None:
    """Clear every counter."""
    with _lock:
        _counts.clear()


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
