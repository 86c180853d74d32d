"""Unicode character classes for capcode and the normalizer, frozen from
``tokenmonster_tpu_torch/utils/chartypes.py`` at commit 6d463e6b506c.

Only the pieces that the plain reference calls, each copied whole.
``tmbench/tests/test_tmbench_frozen.py`` holds each piece to its
source at that commit; the copy stays as it is when the source
changes."""

from __future__ import annotations

import os
import sys
import unicodedata

import numpy as np


MAX_CP = 0x110000
LETTER = 1 << 0      # L*
UPPER = 1 << 1       # Uppercase property
LOWER = 1 << 2       # Lowercase property
NUMBER = 1 << 3      # N*
DIGIT = 1 << 4       # Nd
MODIFIER = 1 << 5    # M*
WHITESPACE = 1 << 6  # White_Space property
MARK_MN = 1 << 7     # Mn only (used by strip-accents normalisation)
_CACHE = None
_WHITE_SPACE = (
    list(range(0x09, 0x0E)) + [0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B)) + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)


def _build() -> dict:
    props = np.zeros(MAX_CP, dtype=np.uint8)
    lower = np.arange(MAX_CP, dtype=np.uint32)
    upper = np.arange(MAX_CP, dtype=np.uint32)
    cat = unicodedata.category
    for cp in range(MAX_CP):
        c = chr(cp)
        k = cat(c)
        k0 = k[0]
        p = 0
        if k0 == "L":
            p |= LETTER
        elif k0 == "N":
            p |= NUMBER
            if k == "Nd":
                p |= DIGIT
        elif k0 == "M":
            p |= MODIFIER
            if k == "Mn":
                p |= MARK_MN
        if p or k0 in "SC":  # Other_Uppercase/Lowercase live in So/Nl etc.
            if c.isupper():
                p |= UPPER
            if c.islower():
                p |= LOWER
        if p & (UPPER | LOWER | LETTER):
            lo = c.lower()
            if len(lo) == 1:
                lower[cp] = ord(lo)
            up = c.upper()
            if len(up) == 1:
                upper[cp] = ord(up)
        props[cp] = p
    # Go uses the *simple* case mappings: U+0130 (I-dot) simple-lowercases to
    # plain 'i' whereas Python's full mapping produces "i" + U+0307.
    lower[0x130] = ord("i")
    props[_WHITE_SPACE] |= WHITESPACE
    return {"props": props, "lower": lower, "upper": upper}


def _load() -> dict:
    global _CACHE
    if _CACHE is not None:
        return _CACHE
    cache_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))), "build", "tokenmonster_tpu_torch", "chartypes")
    tag = "%s_py%d%d" % (unicodedata.unidata_version, *sys.version_info[:2])
    path = os.path.join(cache_dir, f"chartypes_{tag}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            _CACHE = {k: z[k] for k in ("props", "lower", "upper")}
            return _CACHE
    data = _build()
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez_compressed(tmp, **data)
        os.replace(tmp, path)
    except OSError:
        pass
    _CACHE = data
    return _CACHE


def props_table() -> np.ndarray:
    return _load()["props"]


def lower_table() -> np.ndarray:
    return _load()["lower"]


def is_letter(cp: int) -> bool:
    return bool(props_table()[cp] & LETTER)


def is_upper(cp: int) -> bool:
    return bool(props_table()[cp] & UPPER)


def is_lower(cp: int) -> bool:
    return bool(props_table()[cp] & LOWER)


def is_number(cp: int) -> bool:
    return bool(props_table()[cp] & NUMBER)


def is_modifier(cp: int) -> bool:
    return bool(props_table()[cp] & MODIFIER)


def to_lower(cp: int) -> int:
    return int(lower_table()[cp])
