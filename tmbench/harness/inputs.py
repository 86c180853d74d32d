"""The inputs a cell's set-up makes: the corpus (the frozen
``stdlib_text``) and the vocabulary file checked against its hash.  What
costs more than a few seconds to make is kept in ``.tmbench_cache/`` at
the checkout's root, a fixed directory keyed by what it was made from, so
only a checkout's first run makes it."""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

from ..frozen.corpus import stdlib_text
from .cells import ROOT

CACHE = os.path.join(ROOT, ".tmbench_cache")


def _key(*parts) -> str:
    return hashlib.sha256(json.dumps(parts).encode()).hexdigest()[:20]


def _stored(kind: str, key: str, suffix: str) -> str:
    d = os.path.join(CACHE, kind)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, key + suffix)


def _write(path: str, data: bytes) -> None:
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def sha256_file(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def vocab_file(config: dict) -> str:
    """The configuration's vocabulary, refused if it is not the file the
    configuration names by hash."""
    path = os.path.join(ROOT, config["vocab"])
    got = sha256_file(path)
    if got != config["vocab_sha256"]:
        raise ValueError(f"{config['vocab']} has sha256 {got}, not the "
                         f"configuration's {config['vocab_sha256']}")
    return path


class _LineTable:
    """Stands in for a vocabulary in ``stdlib_text``: its one-byte tokens,
    and each line's normalization looked up from ``table``; with no table
    every line passes and is noted."""

    def __init__(self, tokens, table=None):
        self.tokens = tokens
        self.table = table
        self.lines = []

    def normalize(self, line: bytes) -> bytes:
        if self.table is None:
            self.lines.append(line)
            return b""
        return self.table[line]


def corpus(config: dict, reference=None):
    """(text, lines dropped, seconds it took to make, from cache) of the
    configuration's ``corpus``: ``stdlib_text`` of ``min_bytes``, lines
    filtered by the vocabulary's one-byte tokens where ``filter`` is true
    (each line normalized by the plain reference, in its worker
    processes: ``reference``)."""
    c = config["corpus"]
    if not c["filter"]:
        t0 = time.perf_counter()
        text, dropped = stdlib_text(None, c["min_bytes"])
        return text, dropped, time.perf_counter() - t0, False
    path = vocab_file(config)
    key = _key(c, config["vocab_sha256"], sys.version,
               os.path.dirname(os.__file__))
    stored = _stored("corpus", key, ".bin")
    if os.path.exists(stored):
        with open(stored, "rb") as f:
            text = f.read()
        with open(stored + ".json") as f:
            return text, json.load(f)["dropped"], 0.0, True
    from ..reference.core.vocab import Vocab
    t0 = time.perf_counter()
    v = Vocab.load(path)
    probe = _LineTable(v.tokens)
    stdlib_text(probe, c["min_bytes"])
    lines = sorted(set(probe.lines))
    done = reference.normalize_each(lines, v.normalizer.flag,
                                    v.using_capcode)
    text, dropped = stdlib_text(_LineTable(v.tokens, dict(zip(lines, done))),
                                c["min_bytes"])
    seconds = time.perf_counter() - t0
    _write(stored + ".json", json.dumps({"dropped": dropped}).encode())
    _write(stored, text)
    return text, dropped, seconds, False

