"""Spans, counters and set-up phases of the port, on the profiler's clock.

Tracing is on while a ``torch.profiler`` profile records anywhere in the
process (torch's process-wide flag), or inside ``with tracing.on():``.
Off, ``span`` is one flag test that returns a shared no-op context, and
``count`` is one flag test: no profiler range (``record_function`` costs
microseconds even with no profiler running) and no CUDA event.

On, a span records

- a range on the profiler's host timeline, beside the device operations
  it launched (``torch._C._profiler._RecordFunctionFast``: a tenth of
  ``record_function``'s cost, and its ``args`` reach an exported trace
  recorded with ``record_shapes``);
- per name, in a registry shared by every thread: the number of spans,
  their host seconds and their self seconds (duration less the time their
  child spans cover, found through a per-thread stack of open spans, which
  also gives each span its parent);
- with ``device=`` a CUDA device, two timing events on that device's
  current stream: the stream's time from the span's first launch to its
  last, idle stretches inside included.  The pairs are read at
  ``snapshot``; past ``MAX_PENDING`` unread pairs, a closing span reads
  the finished ones, waiting for the oldest.

``count(name, n)`` adds a host integer or a device tensor (summed on the
device, read at ``snapshot``) to a counter.  ``phase(name)`` records host
seconds whether tracing is on or not: it wraps the few set-up phases of a
process, so that their split reaches a run whose profiler starts later.
``snapshot()`` waits for every pending event and returns the registry;
``reset()`` clears it.  Tracing leaves results alone.

    from repro_torch import tracing
    with tracing.on():
        server.search(q, 100)
    tracing.snapshot()["spans"]["ecpfs.packed.rank"]["device_s"]
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter, deque

import torch
from torch.autograd import profiler as _profiler

__all__ = ["MAX_PENDING", "count", "enabled", "on", "phase", "reset", "snapshot", "span"]

# unread event pairs past which a closing span reads them (a few thousand
# a 51 s window of the packed cell)
MAX_PENDING = 8192


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []  # this thread's open spans, innermost last


_lock = threading.Lock()
_local = _Local()
_forced = 0                 # open ``on()`` blocks, in every thread
_spans: dict[str, "_Stat"] = {}
_counters: Counter = Counter()
_device_counters: dict[str, torch.Tensor] = {}
_phases: dict[str, list] = {}   # name -> [count, seconds]
_pending: deque = deque()       # (stat, start event, end event)


def enabled() -> bool:
    """Whether spans and counters record now."""
    return _forced > 0 or _profiler._is_profiler_enabled


@contextlib.contextmanager
def on():
    """Record spans and counters inside this block, with or without a
    profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


class _Stat:
    __slots__ = ("count", "host_s", "self_s", "device_s", "device_n", "parents")

    def __init__(self):
        self.count, self.host_s, self.self_s = 0, 0.0, 0.0
        self.device_s, self.device_n = 0.0, 0
        self.parents: Counter = Counter()

    def as_dict(self) -> dict:
        return {"count": self.count, "host_s": self.host_s, "self_s": self.self_s,
                "device_s": self.device_s, "device_n": self.device_n, "parents": dict(self.parents)}


_NULL = contextlib.nullcontext()


def _resolve(block: bool) -> None:
    """Add the device time of finished event pairs, oldest first (under
    ``_lock``); with ``block``, wait for all of them."""
    while _pending:
        stat, start, end = _pending[0]
        if block:
            end.synchronize()
        elif not end.query():
            return
        _pending.popleft()
        stat.device_s += start.elapsed_time(end) / 1e3
        stat.device_n += 1


class _Span:
    __slots__ = ("name", "stream", "args", "rf", "parent", "child_s", "t0", "start")

    def __init__(self, name: str, stream, args):
        self.name, self.stream, self.args = name, stream, args
        self.child_s = 0.0

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        fast = torch._C._profiler._RecordFunctionFast  # aborts on arguments of other types
        self.rf = fast(self.name) if self.args is None else fast(self.name, (), self.args)
        self.rf.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        end = None
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
        self.rf.__exit__(*exc)
        _local.stack.pop()
        dur = t1 - self.t0
        if self.parent is not None:
            self.parent.child_s += dur
        with _lock:
            stat = _spans.get(self.name)
            if stat is None:
                stat = _spans[self.name] = _Stat()
            stat.count += 1
            stat.host_s += dur
            stat.self_s += dur - self.child_s
            stat.parents[None if self.parent is None else self.parent.name] += 1
            if end is not None:
                _pending.append((stat, self.start, end))
                if len(_pending) > MAX_PENDING:
                    _pending[0][2].synchronize()
                    _resolve(block=False)
        return False


def span(name: str, *, device: torch.device | None = None, args=None):
    """A context manager that records the stage ``name`` while tracing is
    on.  ``device``: time the stage on that device's current stream too
    (a CUDA device; no events on any other).  ``args``: a dict the
    profiler's range carries (a request's id)."""
    if not enabled():
        return _NULL
    stream = torch.cuda.current_stream(device) if device is not None and device.type == "cuda" else None
    return _Span(name, stream, None if args is None else dict(args))


def count(name: str, n=1) -> None:
    """Add ``n`` (an int, or a device tensor summed where it lies) to
    counter ``name`` while tracing is on."""
    if not enabled():
        return
    with _lock:
        if torch.is_tensor(n):
            n = n.detach().sum()
            acc = _device_counters.get(name)
            _device_counters[name] = n if acc is None else acc + n
        else:
            _counters[name] += int(n)


@contextlib.contextmanager
def phase(name: str):
    """Record the host seconds of set-up phase ``name``, traced or not."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            rec = _phases.setdefault(name, [0, 0.0])
            rec[0] += 1
            rec[1] += dt


def snapshot() -> dict:
    """The registry, every pending event pair waited for: ``{"spans":
    {name: {count, host_s, self_s, device_s, device_n, parents}},
    "counters": {name: int}, "phases": {name: {count, s}}}``."""
    with _lock:
        _resolve(block=True)
        counters = Counter(_counters)
        for name, acc in _device_counters.items():
            counters[name] += int(acc)
        return {"spans": {n: s.as_dict() for n, s in _spans.items()},
                "counters": dict(counters),
                "phases": {n: {"count": c, "s": s} for n, (c, s) in _phases.items()}}


def reset() -> None:
    """Forget every span, counter and phase recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _device_counters.clear()
        _phases.clear()
        _pending.clear()
