"""The plain reference, run after the window in worker processes.

Normalization and the tokenizer loop are plain Python (the frozen copies
under ``reference/core``), about 8 and 10 microseconds a byte on one core,
so a long text is cut into pieces that run in parallel: normalization at
line ends (a line end leaves NFD and capcode in their starting state, so
the pieces' outputs concatenate to the whole's; other normalizations run
whole), the loop as ``scan``'s pieces spliced where two runs reach one
state.  Imports nothing of the program and no torch."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .core.normalize import Normalizer
from .core.vocab import Vocab, normalize_and_capcode
from .scan import Events, scan

SPLIT_NORM = {0, 1}          # normalizer flags whose output a line end splits
MARGIN = 4096                # bytes a piece's run goes past the next piece's
                             # start to meet that piece's run
PIECE = 256 << 10            # texts longer than this are cut into pieces

_VOCABS: dict = {}           # a worker's vocabulary, by its path


def vocab_of(path: str) -> Vocab:
    """The vocabulary file at ``path``, loaded once a worker."""
    if path not in _VOCABS:
        _VOCABS.clear()
        _VOCABS[path] = Vocab.load(path)
    return _VOCABS[path]


def _normalize(data: bytes, flag: int, capcode: int) -> bytes:
    return normalize_and_capcode(data, capcode, Normalizer(flag))


def _normalize_lines(lines: list, flag: int, capcode: int) -> list:
    normalizer = Normalizer(flag)
    return [normalize_and_capcode(x, capcode, normalizer) for x in lines]


def _scan(path: str, data: bytes, start: int, stop, greedy: bool) -> Events:
    return scan(vocab_of(path), data, start, stop, greedy)


def line_cuts(data: bytes, parts: int) -> list:
    """Up to ``parts`` + 1 cut positions of ``data``, each inner one just
    past a line end."""
    cuts = [0]
    for k in range(1, parts):
        at = data.find(b"\n", max(cuts[-1], len(data) * k // parts))
        if at < 0:
            break
        cuts.append(at + 1)
    return sorted(set(cuts + [len(data)]))


def splice(runs: list, starts: list):
    """The events of the whole text from runs of its pieces (run k from
    ``starts[k]`` through past ``starts[k + 1]`` + MARGIN): run k up to the
    first state it shares with run k + 1, then run k + 1.  None where two
    runs share no state within the margin."""
    out, keep_from = [], 0
    for k in range(len(runs) - 1):
        a, b, s = runs[k], runs[k + 1], starts[k + 1]
        states = {(s, 0): 0}
        for j in range(len(b)):
            p = int(b.pos[j])
            if p >= s + MARGIN:
                break
            states.setdefault((p, int(b.fd[j])), j + 1)
        met = None
        for t in range(int(np.searchsorted(a.pos, s)), len(a)):
            u = states.get((int(a.pos[t]), int(a.fd[t])))
            if u is not None:
                met = (t + 1, u)
                break
        if met is None:
            return None
        out.append(a.cut(keep_from, met[0]))
        keep_from = met[1]
    out.append(runs[-1].cut(keep_from))
    return Events.join(out)


class Reference:
    """The reference's worker processes (spawned, so the parent's card and
    threads stay out of them); ``workers`` 0 runs everything in this
    process.  Close it, or use it as a context manager."""

    def __init__(self, workers: int | None = None):
        if workers is None:
            workers = max(1, min(7, (os.cpu_count() or 2) - 1))
        self.workers = workers
        self._ex = (ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
            if workers else None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=True)
            self._ex = None

    def _map(self, fn, *columns):
        if self._ex is None:
            return [fn(*args) for args in zip(*columns)]
        return list(self._ex.map(fn, *columns))

    def normalize(self, texts: list, flag: int, capcode: int) -> list:
        """Each raw text normalized and capcoded; long ones in pieces."""
        jobs, owner = [], []
        for n, raw in enumerate(texts):
            parts = (max(1, len(raw) // PIECE) if flag in SPLIT_NORM
                     else 1)
            cuts = line_cuts(raw, parts)
            for a, b in zip(cuts, cuts[1:]):
                jobs.append(raw[a:b])
                owner.append(n)
        done = self._map(_normalize, jobs, [flag] * len(jobs),
                         [capcode] * len(jobs))
        out = [[] for _ in texts]
        for n, piece in zip(owner, done):
            out[n].append(piece)
        return [b"".join(p) for p in out]

    def normalize_each(self, items: list, flag: int, capcode: int) -> list:
        """Each of many short texts (lines) normalized and capcoded."""
        size = len(items) // (4 * max(1, self.workers)) + 1
        batches = [items[i:i + size] for i in range(0, len(items), size)]
        done = self._map(_normalize_lines, batches, [flag] * len(batches),
                         [capcode] * len(batches))
        return [x for batch in done for x in batch]

    def events(self, path: str, texts: list, greedy: bool = False) -> list:
        """The loop's events over each normalized text, by the vocabulary
        file at ``path``; long ones as pieces spliced, or whole where the
        pieces' runs do not meet."""
        jobs, plan = [], []
        for n, data in enumerate(texts):
            parts = max(1, min(len(data) // PIECE,
                               2 * max(1, self.workers)))
            starts = [len(data) * k // parts for k in range(parts)]
            stops = starts[1:] + [len(data)]
            plan.append((len(jobs), starts))
            for s, e in zip(starts, stops):
                jobs.append((data, s, e + MARGIN if e < len(data) else None))
        runs = self._map(_scan, [path] * len(jobs), [j[0] for j in jobs],
                         [j[1] for j in jobs], [j[2] for j in jobs],
                         [greedy] * len(jobs))
        out = []
        for n, (first, starts) in enumerate(plan):
            ev = splice(runs[first:first + len(starts)], starts)
            if ev is None:
                print(f"reference: pieces of text {n} did not meet; "
                      "scanned whole", flush=True)
                ev = self._map(_scan, [path], [texts[n]], [0], [None],
                               [greedy])[0]
            out.append(ev)
        return out
