"""What the program records of itself (``repro_torch.tracing``), for the
per-layer readers: its registry of spans, counters and set-up phases, and
the window's idle gaps put down to the program's spans on the profiler's
timeline.  Where the program has no such module (a checkout from before
it) or recorded nothing, the readers get None."""
from __future__ import annotations

import heapq


def registry() -> dict | None:
    """``tracing.snapshot()`` of the program, or None."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    return snap if any(snap.values()) else None


def device_ms_per_batch(run, span: str) -> float | None:
    """Device milliseconds of span ``span`` (its CUDA events) per request
    of the traced window."""
    if run.trace is None or not run.searches:
        return None
    rec = (registry() or {}).get("spans", {}).get(span)
    if not rec or not rec["device_n"]:
        return None
    return 1e3 * rec["device_s"] / run.searches


def counter(run, name: str) -> int | None:
    """Counter ``name`` over the traced window."""
    if run.trace is None:
        return None
    return (registry() or {}).get("counters", {}).get(name)


def phase_s(run, prefix: str) -> float | None:
    """Seconds of every set-up phase named ``prefix...``, summed."""
    if run.trace is None:
        return None
    got = [p["s"] for n, p in (registry() or {}).get("phases", {}).items() if n.startswith(prefix)]
    return sum(got) if got else None


def idle_by_span(trace, prefix: str = "ecpfs.") -> dict:
    """Seconds of the window's idle gaps by the innermost host span named
    ``prefix...`` around each gap's midpoint (the span that started last
    among those that hold it); key None for gaps outside every such span."""
    spans = sorted((s, e, n) for n, s, e in trace.host if n.startswith(prefix))
    out: dict = {}
    open_: list = []  # (-start, end, name) of spans started before the midpoint
    j = 0
    for s, e in trace.gaps():  # in time order
        mid = (s + e) / 2
        while j < len(spans) and spans[j][0] <= mid:
            heapq.heappush(open_, (-spans[j][0], spans[j][1], spans[j][2]))
            j += 1
        while open_ and open_[0][1] < mid:  # ended: before every later midpoint too
            heapq.heappop(open_)
        name = open_[0][2] if open_ else None
        out[name] = out.get(name, 0.0) + (e - s)
    return out
