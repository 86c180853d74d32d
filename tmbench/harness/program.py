"""What the program's own spans (``tokenmonster_tpu_torch.tracing``) say
of a traced window.  The program records them while the profiler that
traces the window runs; each span is (name, start, end, parent, call,
thread, n, id), on the clock of the window and of the device trace.  A
program without the recorder, or one that recorded nothing in the window
or dropped records there, gives None, and its metrics are left out."""

from __future__ import annotations

from .trace import busy, gaps


def spans(ctx):
    """The program's spans that start in the window, or None."""
    try:
        from tokenmonster_tpu_torch import tracing
    except ImportError:
        return None
    w0, w1 = ctx["window_ns"]
    lost = tracing.drops()
    if lost.count and lost.first < w1 and lost.last >= w0:
        return None
    return tracing.records(w0, w1) or None


def _named_ns(ctx, name: str):
    """The ns of every span ``name`` in the window, each clipped to its
    end; None where the window holds none."""
    recs = spans(ctx)
    if recs is None:
        return None
    w1 = ctx["window_ns"][1]
    got = [min(s.end, w1) - s.start for s in recs if s.name == name]
    return sum(got) if got else None


def ms_per_unit(ctx, name: str):
    """Mean wall milliseconds a unit of work (a request) spends in the
    spans ``name``."""
    ns = _named_ns(ctx, name)
    if ns is None or not ctx["units"]:
        return None
    return ns / 1e6 / ctx["units"]


def pct_of_window(ctx, name: str):
    """Share of the window, in %, spent in the spans ``name``."""
    ns = _named_ns(ctx, name)
    if ns is None:
        return None
    w0, w1 = ctx["window_ns"]
    return 100.0 * ns / (w1 - w0)


def holding_pct(ctx, name: str, child: str):
    """Share, in %, of the spans ``name`` that hold a span ``child``."""
    recs = spans(ctx)
    if recs is None:
        return None
    outer = {s.id for s in recs if s.name == name}
    if not outer:
        return None
    by_id = {s.id: s for s in recs}
    held = set()
    for s in recs:
        if s.name != child:
            continue
        up = s.parent
        while up is not None and up not in outer and up in by_id:
            up = by_id[up].parent
        if up in outer:
            held.add(up)
    return 100.0 * len(held) / len(outer)


def _overlap_ns(a: list, b: list) -> int:
    """The ns two sorted lists of disjoint (start, end) share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_outside_pct(ctx, name: str):
    """Share, in %, of the device's idle time in the window (the window
    less the union of the trace's device operations) during which no span
    ``name`` is open on any thread."""
    recs, ops = spans(ctx), ctx.get("ops")
    if recs is None or not ops:
        return None
    w0, w1 = ctx["window_ns"]
    idle = gaps(busy(ops), w0, w1)
    idle_ns = sum(b - a for a, b in idle)
    inside = busy([(s.name, s.start, min(s.end, w1))
                   for s in recs if s.name == name])
    if not idle_ns or not inside:
        return None
    return 100.0 * (idle_ns - _overlap_ns(idle, inside)) / idle_ns
