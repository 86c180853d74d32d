"""What the per-layer metrics read from a traced run's context: the
window (ns), the benchmark's spans, the device operations of the trace,
the staged dispatches, and counts of the work done."""

from __future__ import annotations

from ..frozen.work import bound, match_work
from .spans import total_ns
from .trace import busy


def window_ns(ctx) -> int:
    w0, w1 = ctx["window_ns"]
    return w1 - w0


def spans_ns(ctx, name: str) -> int:
    return total_ns(ctx["spans"].within(name, *ctx["window_ns"]))


def idle_pct(ctx):
    """Share of the window in which no operation ran on the device."""
    ops = ctx.get("ops")
    if not ops:
        return None
    covered = sum(b - a for a, b in busy(ops))
    return 100.0 * (1.0 - covered / window_ns(ctx))


class _Buf:
    """A dispatch buffer's size, as ``match_work`` reads it."""

    def __init__(self, n: int):
        self._n = n

    def numel(self) -> int:
        return self._n


def match_roofline_pct(ctx):
    """The least time of every staged dispatch's match work (its text,
    tables and words written, or its hashing), over the card time of the
    match kernels; none where the trace shows no match kernel."""
    kernel_ns = sum(b - a for name, a, b in ctx.get("ops") or ()
                    if "match_kernel" in name)
    if not kernel_ns or not ctx["dispatches"]:
        return None
    tabs = ctx["tables"]
    least_ms = sum(bound(*match_work(_Buf(size), n, tabs))[0]
                   for size, n in ctx["dispatches"])
    return 100.0 * least_ms * 1e6 / kernel_ns
