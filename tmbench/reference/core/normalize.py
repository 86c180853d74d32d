"""The normalizations a vocabulary's flag byte states, frozen from
``tokenmonster_tpu_torch/core/normalize.py`` at commit 6d463e6b506c.

Only the pieces that the plain reference calls, each copied whole.
``tmbench/tests/test_tmbench_frozen.py`` holds each piece to its
source at that commit; the copy stays as it is when the source
changes."""

from __future__ import annotations

import unicodedata

import numpy as np

from ..utils.chartypes import MARK_MN, props_table


NFD = 1
LOWERCASE = 2
ACCENTS = 4
QUOTEMARKS = 8
COLLAPSE = 16
TRIM = 32
LEADING_SPACE = 64
UNIX_LINES = 128
_NAME_TO_FLAG = {
    "nfd": NFD,
    "lowercase": LOWERCASE,
    "accents": ACCENTS,
    "quotemarks": QUOTEMARKS,
    "collapse": COLLAPSE,
    "trim": TRIM,
    "leadingspace": LEADING_SPACE,
    "unixlines": UNIX_LINES,
}


def parse_flags(s: str) -> int:
    """Parse a normalization spec string like "lowercase collapse trim"."""
    if s is None:
        return 0
    flag = 0
    for raw in s.replace(",", " ").split():
        name = raw.strip().lower()
        if not name or name in ("none", "no", "false"):
            continue
        if name not in _NAME_TO_FLAG:
            raise ValueError(f"Unknown normalization: {raw!r}")
        flag |= _NAME_TO_FLAG[name]
    return flag


def _nfd(b: bytes) -> bytes:
    if not b:
        return b
    arr = np.frombuffer(b, dtype=np.uint8)
    if not (arr & 0x80).any():  # pure ASCII is NFD-invariant
        return b
    s = b.decode("utf-8", errors="surrogateescape")
    try:
        return unicodedata.normalize("NFD", s).encode("utf-8")
    except ValueError:
        # Lone surrogates (invalid UTF-8 input) cannot be normalised.
        return b


def _lowercase(b: bytes) -> bytes:
    s = b.decode("utf-8", errors="surrogateescape")
    return s.lower().encode("utf-8", errors="surrogateescape")


def _strip_accents(b: bytes) -> bytes:
    decomposed = _nfd(b)
    s = decomposed.decode("utf-8", errors="surrogateescape")
    props = props_table()
    out = [c for c in s if ord(c) >= 0xD800 and ord(c) < 0xE000
           or not (props[ord(c)] & MARK_MN)]
    return "".join(out).encode("utf-8", errors="surrogateescape")


def _unix_lines(b: bytes) -> bytes:
    if len(b) < 2:
        return b
    arr = np.frombuffer(b, dtype=np.uint8)
    drop = np.zeros(len(arr), dtype=bool)
    drop[:-1] = (arr[:-1] == 0x0D) & (arr[1:] == 0x0A)
    if not drop.any():
        return b
    return arr[~drop].tobytes()


def _collapse(b: bytes) -> bytes:
    """Remove spaces that are preceded by a space in the input."""
    arr = np.frombuffer(b, dtype=np.uint8)
    if len(arr) == 0:
        return b
    drop = np.zeros(len(arr), dtype=bool)
    drop[1:] = (arr[1:] == 32) & (arr[:-1] == 32)
    if not drop.any():
        return b
    return arr[~drop].tobytes()


def _quotemarks(b: bytes) -> bytes:
    """Replace curly quotes (U+2018/19 -> ' and U+201C/1D -> ") in place."""
    arr = np.frombuffer(b, dtype=np.uint8).copy()
    n = len(arr)
    if n < 3:
        return b
    tail = arr[2:]
    is_q = (tail == 152) | (tail == 153) | (tail == 156) | (tail == 157)
    ctx = (arr[1:-1] == 128) & (arr[:-2] == 226)
    hit = is_q & ctx
    if not hit.any():
        return b
    idx = np.nonzero(hit)[0] + 2
    arr[idx] = np.where(arr[idx] < 156, ord("'"), ord('"'))
    drop = np.zeros(n, dtype=bool)
    drop[idx - 1] = True
    drop[idx - 2] = True
    return arr[~drop].tobytes()


def _trim(b: bytes) -> bytes:
    i = 0
    n = len(b)
    while i < n and b[i] <= 32:
        i += 1
    j = n - 1
    while j >= i and b[j] <= 32:
        j -= 1
    return b[i:j + 1]


def _leading_space(b: bytes) -> bytes:
    if not b:
        return b
    if b[0] == 0x20:
        return b
    return b" " + b


def normalize(data: bytes, flag: int) -> bytes:
    """Apply the normalisations selected by ``flag`` (tokenmonster.cpp:428-475)."""
    b = bytes(data)
    if flag == 0:
        return b
    if flag == 1:
        return _nfd(b)
    if flag & UNIX_LINES:
        b = _unix_lines(b)
    if flag & COLLAPSE:
        b = _collapse(b)
    if flag & QUOTEMARKS:
        b = _quotemarks(b)
    if flag & TRIM:
        b = _trim(b)
    if flag & LEADING_SPACE:
        b = _leading_space(b)
    if flag & ACCENTS:
        b = _strip_accents(b)
        if flag & LOWERCASE:
            b = _lowercase(b)
        return b
    if flag & LOWERCASE:
        if flag & NFD:
            b = _nfd(b)
        return _lowercase(b)
    if flag & NFD:
        return _nfd(b)
    return b


class Normalizer:
    """Mirror of the Go norm.Normalizer (flag byte + helpers)."""

    __slots__ = ("flag",)

    def __init__(self, spec=0):
        if isinstance(spec, str):
            self.flag = parse_flags(spec)
        else:
            self.flag = int(spec)

    def normalize(self, data: bytes) -> bytes:
        return normalize(data, self.flag)
