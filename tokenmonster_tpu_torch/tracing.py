"""Spans of the tokenizer path and of the trainer, on the clock of
``torch.profiler``'s trace.

A span is one pass through a layer boundary of ``Vocab.tokenize`` or of
``train_vocab``'s loop: its name, start and end (``time.time_ns()``, the
clock of the profiler's device events, so a span and a kernel line up),
the span it opened inside, the call it belongs to, its thread and ``n``,
the work counted at that boundary.  The tokenizer's sites and what each
``n`` counts:

    tokenize   api.Vocab._tokenize_one (a call's root)       raw bytes
      nfd        the normalizer's pass (NFD, if set)         bytes in
        unicodedata  core.normalize._nfd's NFD call: the      bytes handed
                     text's runs of non-ASCII bytes, or the   to it
                     whole text (no span for ASCII)
      capcode    the capcode encoder                         bytes in
        runs       the native encoder's call: the bytes it    input bytes
                   copies 16 at a time between those that     copied as
                   need a decision (no span for the Python    runs
                   encoder)
      device     ops.scan.GpuTokenizer.tokenize              bytes in
        stage      plan, pinned buffer, host copy, upload    dispatches
        launch     graph load, replay (a capture too), clones groups
        wait       the host blocked on the card (a card only) bytes read
        rerun      the op-by-op rerun of a call that did not hold
                                                             repairs made
        expand     the host's delete expansion of the ids    ids out

The trainer's (``train/trainvocab.py``; a round's master thread and each
worker thread that scores a candidate open roots of their own):

    round      a round of train_vocab's loop (master's root)  candidates
      prune      the list work: the shuffle and candidate     tokens in
                 draw, then the prune and checkpoints         the pool
      select     the master's read of one candidate's result:
                 deletion votes, best tracking                votes
    candidate  _evaluate: one candidate (a worker's root;     strip bytes
               under round where the master scores it)
      build      the candidate vocabulary (scorer.build)      tokens
      mask       host masking (score_helpers.                  superset
                 candidate_host_state) and the upload of the  entries
                 candidate's tables
      score      parallel.score: the strips' batches, each    strips
                 staged (stage: dispatches) and replayed
                 (launch: one a batch), and the sums read back
        readback   the one read of a candidate's sums         bytes
      rescore    the strips whose first pass did not hold,    strips
                 scored again op by op                        rescored

A layer's self time is its span less its children's (normalization's
whole is ``nfd`` plus ``capcode``; a candidate's is ``build``, ``mask``,
``score`` and ``rescore`` with the host's work between them).  Operator's
use::

    from tokenmonster_tpu_torch import tracing
    with tracing.enable():
        vocab.tokenize(texts)
    spans = tracing.records()          # or records(t0_ns, t1_ns)
    tracing.clear()

Recording is on while some ``enable()`` holds it on, and while a
``torch.profiler`` session runs (every session, whatever its activities,
sets ``torch.autograd.profiler._is_profiler_enabled``), so a profiled
window gets the program's spans with no other switch.  The switch is read
when a call's root opens (``root``); the spans under it follow the root,
and a ``span`` opened outside any root (a scoring slot's thread of a
candidate split over several devices, a caller of ``score_strips``)
records nothing.  Off, a span site reads no
clock: a child reads one thread-local attribute, a root also the two
switches, and marks its thread while it is open.  Records stay in
memory, at most ``CAPACITY``; once it is full each further record is
dropped and counted (``drops()``) until ``clear()``.  On the host of an
NVIDIA H100 machine a span site cost about 0.5 us off and 2.3 us on,
about ten a request (PERF.md, section 5).
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

from torch.autograd import profiler as _profiler

if not hasattr(_profiler, "_is_profiler_enabled"):
    raise ImportError("torch.autograd.profiler has no _is_profiler_enabled, "
                      "which tracing reads to record under a profiler: "
                      "this torch is not one tracing supports")

CAPACITY = 1 << 20


class Span(NamedTuple):
    """One closed span: ``parent`` is the ``id`` of the span it opened
    inside (None for a root), ``call`` the ``id`` of its root."""
    name: str
    start: int
    end: int
    parent: int | None
    call: int
    thread: int
    n: int
    id: int


class Drops(NamedTuple):
    """Records dropped since the last ``clear()``, with the start (ns) of
    the first and of the last (None while none was)."""
    count: int
    first: int | None
    last: int | None


class _Local(threading.local):
    top = None      # the innermost open span of this thread, or _MUTED


_local = _Local()
_ids = itertools.count(1)
_lock = threading.Lock()
_held = 0           # enable()s in force
_records: list = []
_drops = Drops(0, None, None)


class _Open:
    """A span being recorded; ``n`` may be set before it closes."""
    __slots__ = ("name", "n", "id", "up", "call", "start")

    def __init__(self, name: str, n: int, up):
        self.name, self.n, self.up = name, n, up
        self.id = next(_ids)
        self.call = self.id if up is None else up.call

    def __enter__(self):
        _local.top = self
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.top = self.up
        _add(Span(self.name, self.start, end,
                  None if self.up is None else self.up.id, self.call,
                  threading.get_ident(), self.n, self.id))
        return False


class _Off:
    """A span that records nothing (``n`` takes and keeps no value)."""
    __slots__ = ()
    n = property(lambda self: 0, lambda self, value: None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Muted(_Off):
    """A root opened while recording is off: the spans under it record
    nothing, even if recording turns on before it closes."""
    __slots__ = ()

    def __enter__(self):
        _local.top = self
        return self

    def __exit__(self, *exc):
        _local.top = None
        return False


_OFF, _MUTED = _Off(), _Muted()


def root(name: str, n: int = 0):
    """A context manager for a call's root span ``name`` with work count
    ``n`` (settable on the value it yields until it closes): recorded if
    recording is on as it opens, with every span under it.  Opened inside
    another span, it is a span under that one."""
    if _local.top is not None:
        return span(name, n)
    if _held or _profiler._is_profiler_enabled:
        return _Open(name, n, None)
    return _MUTED


def span(name: str, n: int = 0):
    """As ``root``, for a span under the call open on this thread; with
    none open, or the call not recorded, it records nothing."""
    top = _local.top
    if top is None or top is _MUTED:
        return _OFF
    return _Open(name, n, top)


def _add(rec: Span) -> None:
    global _drops
    with _lock:
        if len(_records) < CAPACITY:
            _records.append(rec)
        else:
            _drops = Drops(_drops.count + 1, _drops.first or rec.start,
                           rec.start)


@contextmanager
def enable():
    """Record every call that starts while this holds (nests, and holds
    across threads)."""
    global _held
    with _lock:
        _held += 1
    try:
        yield
    finally:
        with _lock:
            _held -= 1


def records(t0_ns: int = 0, t1_ns: int | None = None) -> list:
    """The spans that start in [t0_ns, t1_ns), in the order they closed."""
    with _lock:
        got = list(_records)
    return [s for s in got
            if t0_ns <= s.start and (t1_ns is None or s.start < t1_ns)]


def drops() -> Drops:
    return _drops


def clear() -> None:
    """Empty the buffer and the drop count."""
    global _drops
    with _lock:
        _records.clear()
        _drops = Drops(0, None, None)
