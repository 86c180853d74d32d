"""The measured window of a trainer cell, closed on the loop's round
boundaries.

``RoundWindow`` is ``train_vocab``'s ``on_round`` hook.  The first round
is the warm-up: at its end (the first boundary) the window opens.  Every
later round runs inside it, whole, and the window closes at the first
boundary that is both at least ``seconds`` after it opened and at least
``min_rounds`` rounds in; the hook then stops the loop.  So the window
starts from the state the warm-up left, which the seed fixes, holds only
whole rounds, and counts every byte of every round it holds: the strips
of every candidate scored.  A round that reaches the loop's midway
(past which candidates score the whole corpus and the early rounds'
deletion rule no longer holds) raises."""

from __future__ import annotations

import time
from types import SimpleNamespace


class MidwayReached(RuntimeError):
    pass


def strip_bytes(r) -> int:
    """The bytes every candidate of round ``r`` scored."""
    return sum(len(d) for c in r.candidates for d in c.datasets)


def _slim(r):
    """Round ``r`` with what the checks after the window read of a middle
    round: each candidate's ids (``reverse``) and results, not its
    vocabulary, token list or strips."""
    return r._replace(candidates=[
        c._replace(vocab=SimpleNamespace(reverse=c.vocab.reverse),
                   datasets=None, tokens=None) for c in r.candidates])


class RoundWindow:
    """The hook; ``clock`` and ``clock_ns`` read the host's time (seconds,
    and ns on the profiler's clock); ``on_open()`` runs at the first
    boundary before the window's clock is read, ``on_close()`` at the
    last after it."""

    def __init__(self, seconds: float, min_rounds: int,
                 clock=time.perf_counter, clock_ns=time.time_ns,
                 on_open=None, on_close=None):
        self.seconds, self.min_rounds = seconds, min_rounds
        self.clock, self.clock_ns = clock, clock_ns
        self.on_open, self.on_close = on_open, on_close
        self.warm = None            # the warm-up round
        self.rounds = []            # the window's rounds, the middle slim
        self.ends = []              # each window round's end (clock)
        self.round_bytes = []       # each window round's strip bytes
        self.bytes = 0              # their sum
        self.t0 = self.t1 = None
        self.t0_ns = self.t1_ns = None

    @property
    def closed(self) -> bool:
        return self.t1 is not None

    def __call__(self, r) -> bool:
        if self.warm is None:
            self.warm = _slim(r)
            if self.on_open is not None:
                self.on_open()
            self.t0_ns, self.t0 = self.clock_ns(), self.clock()
            return False
        now, now_ns = self.clock(), self.clock_ns()
        if r.phase:
            raise MidwayReached(
                f"round {r.number} reached the loop's {r.phase} phase inside "
                "the window: the cell measures the early rounds")
        if len(self.rounds) > 1:
            self.rounds[-1] = _slim(self.rounds[-1])
        self.rounds.append(r)
        self.ends.append(now)
        self.round_bytes.append(strip_bytes(r))
        self.bytes += self.round_bytes[-1]
        if now - self.t0 >= self.seconds and len(self.rounds) >= \
                self.min_rounds:
            self.t1, self.t1_ns = now, now_ns
            if self.on_close is not None:
                self.on_close()
            return True
        return False
