"""The general generator of tokenizer traffic, and the texts it cuts.

A mix (``traffic/<name>.json``, kind "tokenize") gives ``texts`` texts
whose lengths run log-uniformly from ``min_bytes`` to ``max_bytes`` (the
quantile midpoints of the log-uniform law), each a span of the corpus
from an offset drawn from the seed, begun just past a line end and cut at
one, wrapping round.  Every seed gets the same lengths, so the same
amount of work, on text of its own; the seed also sets the order in which
one caller sends them, in a closed loop, again and again, and which calls
are checked."""

from __future__ import annotations

import random


def lengths(traffic: dict) -> list:
    """The mix's text lengths, shortest first."""
    n, lo, hi = traffic["texts"], traffic["min_bytes"], traffic["max_bytes"]
    return [round(lo * (hi / lo) ** ((k + 0.5) / n)) for k in range(n)]


def schedule(traffic: dict, corpus_len: int, seed: int) -> list:
    """[(offset, length)] in the order the caller sends them: the mix's
    lengths, each at an offset drawn from the seed, in a seeded order."""
    rng = random.Random(seed)
    texts = [(rng.randrange(corpus_len), n) for n in lengths(traffic)]
    rng.shuffle(texts)
    return texts


def cut(corpus: bytes, offset: int, length: int) -> bytes:
    """At least ``length`` bytes of ``corpus`` from the first line start at
    or after ``offset`` through a line end, wrapping round; ``length``
    must be below the corpus's size."""
    if not 0 < length < len(corpus):
        raise ValueError(f"a text of {length} bytes from a corpus of "
                         f"{len(corpus)}")
    at = corpus.find(b"\n", offset)
    start = 0 if at < 0 or at + 1 >= len(corpus) else at + 1
    need = start + length + 65536       # room to reach the next line end
    buf = corpus if need <= len(corpus) else corpus + corpus[:need]
    end = buf.find(b"\n", start + length - 1)
    end = start + length if end < 0 else end + 1
    return buf[start:end]
