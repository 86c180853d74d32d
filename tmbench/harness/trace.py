"""The device's side of a traced window, from ``torch.profiler`` (CUPTI):
each operation that ran on the card with its name and interval, their
union (busy time), the gaps between, and the host span each gap fell in."""

from __future__ import annotations

from .spans import Spans


class Trace:
    """A profiler of the card's activity alone (the host's side is the
    benchmark's spans, which cost less than the profiler's CPU events),
    started before the window (its start-up is set-up) and stopped after
    it; ``ops(t0, t1)`` gives the device operations in [t0, t1) ns,
    clipped to it."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])       # a run on the CPU has no card

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def ops(self, t0: int, t1: int) -> list:
        """[(name, start ns, end ns)] of every device operation (kernels,
        copies, fills) that overlaps the window, clipped to it."""
        from torch.autograd import DeviceType
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = e.start_ns()
            b = a + e.duration_ns()
            if b <= t0 or a >= t1:
                continue
            out.append((e.name(), max(a, t0), min(b, t1)))
        return out


def busy(ops: list) -> list:
    """The union of the ops' intervals, as sorted disjoint (start, end)."""
    merged = []
    for _name, a, b in sorted(ops, key=lambda o: o[1]):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def gaps(intervals: list, t0: int, t1: int) -> list:
    """The idle stretches of [t0, t1) between ``busy`` intervals."""
    out, at = [], t0
    for a, b in intervals:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def host_at(spans: Spans, t: int) -> str:
    """The innermost recorded span around time ``t``, or "unspanned"
    where none is (the benchmark's own loop, or program work outside the
    spans)."""
    best, width = "unspanned", None
    for name, recs in spans.by_name.items():
        for a, b, _th in recs:
            if a <= t < b and (width is None or b - a < width):
                best, width = name, b - a
    return best


def breakdown(ops: list, idle: list, spans: Spans, top: int = 10) -> dict:
    """The device operations that took most time (seconds summed by
    name) and the longest idle gaps, each named by the host span it fell
    in."""
    by_name: dict = {}
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0) + (b - a)
    dev = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, t / 1e9] for n, t in dev],
            "idle_gaps": [[host_at(spans, (a + b) // 2), (b - a) / 1e9]
                          for a, b in longest]}
