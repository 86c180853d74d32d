"""Spans the benchmark records around the calls into the program's layers
(the program records none of its own yet), and the patches that put them
there.  Times are ``time.time_ns()``: the clock of the profiler's trace,
so a span and a device operation line up."""

from __future__ import annotations

import functools
import threading
import time


class Spans:
    """Spans by name: lists of (start ns, end ns, thread id)."""

    def __init__(self):
        self.by_name: dict = {}
        self._patches: list = []

    def add(self, name: str, t0: int, t1: int) -> None:
        self.by_name.setdefault(name, []).append(
            (t0, t1, threading.get_ident()))

    def wrap(self, owner, attr: str, name: str, on_return=None) -> None:
        """Record a span ``name`` around each call of ``owner.attr`` (an
        instance's method or a class's function) until ``restore``;
        ``on_return(result, args)`` sees each call's result."""
        fn = getattr(owner, attr)
        spans = self

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.time_ns()
            try:
                out = fn(*args, **kwargs)
            finally:
                spans.add(name, t0, time.time_ns())
            if on_return is not None:
                on_return(out, args)
            return out

        self.patch(owner, attr, spanned)

    def patch(self, owner, attr: str, fn) -> None:
        """Put ``fn`` in ``owner.attr`` until ``restore``."""
        self._patches.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, fn)

    def restore(self) -> None:
        for owner, attr, old in reversed(self._patches):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._patches.clear()

    def within(self, name: str, t0: int, t1: int) -> list:
        """The spans ``name`` that start in [t0, t1), clipped to it."""
        return [(max(a, t0), min(b, t1), th)
                for a, b, th in self.by_name.get(name, ()) if t0 <= a < t1]


def total_ns(spans: list) -> int:
    return sum(b - a for a, b, _th in spans)

