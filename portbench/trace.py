"""What a traced run reads from ``torch.profiler``: the window, every
device operation in it, and what the host was doing around the gaps."""
from __future__ import annotations

from dataclasses import dataclass, field

from torch.autograd import DeviceType

WINDOW = "portbench.window"


@dataclass
class Trace:
    """Intervals in seconds on the profiler's clock."""

    window: tuple[float, float]
    device: list[tuple[str, float, float]] = field(default_factory=list)  # clipped to the window
    host: list[tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals."""
        out: list[list[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_s(self, match: str = "") -> tuple[float, int]:
        """(summed seconds, count) of the device operations whose name
        holds ``match``."""
        hits = [e - s for name, s, e in self.device if match in name]
        return sum(hits), len(hits)

    def gaps(self) -> list[tuple[float, float]]:
        edges = [self.window[0]]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.window[1])
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    def host_at(self, t: float) -> str:
        """The outermost and innermost host spans around time ``t``."""
        around = sorted((e - s, name) for name, s, e in self.host if s <= t <= e and name != WINDOW)
        if not around:
            return "no host span"
        return around[-1][1] if len(around) == 1 else f"{around[-1][1]} > {around[0][1]}"

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict[str, float] = {}
        for name, s, e in self.device:
            by_op[name] = by_op.get(name, 0.0) + (e - s)
        ops = sorted(by_op.items(), key=lambda x: -x[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[self.host_at((s + e) / 2)[:200], e - s] for s, e in gaps]}


def from_profiler(prof) -> Trace:
    """The trace of a stopped ``torch.profiler.profile``, cut to the span
    named ``WINDOW``."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    device, host, window = [], [], None
    for ev in res.events():
        s, e = (ev.start_ns() - t0) / 1e9, (ev.end_ns() - t0) / 1e9
        if ev.device_type() != DeviceType.CPU and (
                getattr(ev, "is_user_annotation", lambda: False)() or ev.name().startswith("portbench.")):
            continue  # a host span's shadow on the device's timeline, not work
        if ev.device_type() == DeviceType.CPU:
            if ev.name() == WINDOW:
                window = (s, e)
            host.append((ev.name(), s, e))
        else:
            device.append((ev.name(), s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    lo, hi = window
    device = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
    return Trace(window, device, host)
