"""Text normalisation passes.

Port of the reference ``norm`` package semantics, recovered from the faithful
C++ translation (tokenmonster-cpp/src/tokenmonster.cpp:190-475) and the flag
documentation (training/README.md:110-125, javascript/tokenmonster.js:205-237).

Flag bits:
  1   = NFD
  2   = lowercase
  4   = strip accents (drop Mn codepoints after NFD)
  8   = quotemarks (curly -> ASCII)
  16  = collapse multiple spaces (0x20 only)
  32  = trim whitespace (bytes <= 32) from both ends
  64  = add leading space if absent
  128 = unix lines (CRLF -> LF)

Pass ordering follows normalize_bytes (tokenmonster.cpp:428-475): unixlines /
collapse / quotemarks first, then trim / leading-space, then accents /
lowercase / NFD.  Flag value 1 exactly means "NFD only".
"""

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
_FLAG_TO_NAME = {v: k for k, v in _NAME_TO_FLAG.items()}


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


def flags_to_string(flag: int) -> str:
    names = [name for bit, name in sorted(_FLAG_TO_NAME.items()) if flag & bit]
    return " ".join(names) if names else "none"


def specified_lowercase(flag: int) -> bool:
    return bool(flag & LOWERCASE)


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

    def specified_lowercase(self) -> bool:
        return specified_lowercase(self.flag)

    def __str__(self) -> str:
        return flags_to_string(self.flag)
