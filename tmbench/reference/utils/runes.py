"""A token's runes (code points), frozen from
``tokenmonster_tpu_torch/utils/runes.py`` at commit 6d463e6b506c.

Only the pieces that the plain reference calls, each copied whole.
``tmbench/tests/test_tmbench_frozen_train.py`` holds each piece to its
source at that commit; the copy stays as it is when the source
changes."""

from __future__ import annotations


RUNE_ERROR = 0xFFFD
_MIN_HIGH_SURROGATE = 0xD800
_MAX_HIGH_SURROGATE = 0xDBFF
_MIN_LOW_SURROGATE = 0xDC00
_MAX_LOW_SURROGATE = 0xDFFF


def decode_utf8(b, i: int = 0):
    """Decode one UTF-8 rune at offset ``i``. Returns (codepoint, size).

    Matches Go utf8.DecodeRune: rejects overlongs, surrogates and >U+10FFFF,
    returning (U+FFFD, 1); returns (U+FFFD, 0) at end of input.
    """
    n = len(b)
    if i >= n:
        return RUNE_ERROR, 0
    b0 = b[i]
    if b0 < 0x80:
        return b0, 1
    if b0 < 0xC2:
        return RUNE_ERROR, 1
    if b0 < 0xE0:
        if i + 1 >= n or (b[i + 1] & 0xC0) != 0x80:
            return RUNE_ERROR, 1
        return ((b0 & 0x1F) << 6) | (b[i + 1] & 0x3F), 2
    if b0 < 0xF0:
        if i + 2 >= n or (b[i + 1] & 0xC0) != 0x80 or (b[i + 2] & 0xC0) != 0x80:
            return RUNE_ERROR, 1
        if b0 == 0xE0 and b[i + 1] < 0xA0:
            return RUNE_ERROR, 1
        if b0 == 0xED and b[i + 1] >= 0xA0:
            return RUNE_ERROR, 1
        return ((b0 & 0x0F) << 12) | ((b[i + 1] & 0x3F) << 6) | (b[i + 2] & 0x3F), 3
    if b0 < 0xF5:
        if (i + 3 >= n or (b[i + 1] & 0xC0) != 0x80
                or (b[i + 2] & 0xC0) != 0x80 or (b[i + 3] & 0xC0) != 0x80):
            return RUNE_ERROR, 1
        if b0 == 0xF0 and b[i + 1] < 0x90:
            return RUNE_ERROR, 1
        if b0 == 0xF4 and b[i + 1] >= 0x90:
            return RUNE_ERROR, 1
        return (((b0 & 0x07) << 18) | ((b[i + 1] & 0x3F) << 12)
                | ((b[i + 2] & 0x3F) << 6) | (b[i + 3] & 0x3F)), 4
    return RUNE_ERROR, 1


def decode_last_utf8(b):
    """Decode the last rune in ``b``. Matches Go utf8.DecodeLastRune."""
    n = len(b)
    if n == 0:
        return RUNE_ERROR, 0
    start = n - 1
    if b[start] < 0x80:
        return b[start], 1
    lim = max(0, n - 4)
    while start >= lim and (b[start] & 0xC0) == 0x80:
        start -= 1
    if start < 0 or (b[start] & 0xC0) == 0x80:
        return RUNE_ERROR, 1
    r, size = decode_utf8(b, start)
    if start + size != n:
        return RUNE_ERROR, 1
    return r, size


def decode_utf16(b, i: int = 0):
    """Decode one UTF-16LE rune at byte offset ``i``.

    Matches go/tokenmonster.go:376-395: returns (U+FFFD, 0) on truncation or
    an unpaired surrogate.
    """
    n = len(b)
    if i + 2 > n:
        return RUNE_ERROR, 0
    u = b[i] | (b[i + 1] << 8)
    if _MIN_HIGH_SURROGATE <= u <= _MAX_HIGH_SURROGATE:
        if i + 4 > n:
            return RUNE_ERROR, 0
        u2 = b[i + 2] | (b[i + 3] << 8)
        if not (_MIN_LOW_SURROGATE <= u2 <= _MAX_LOW_SURROGATE):
            return RUNE_ERROR, 0
        return 0x10000 + (((u - 0xD800) << 10) | (u2 - 0xDC00)), 4
    return u, 2


def decode_last_utf16(b):
    """Matches go/tokenmonster.go:401-429 decodeLastRune for charset 2."""
    n = len(b)
    if n < 2:
        return RUNE_ERROR, 0
    u = b[n - 2] | (b[n - 1] << 8)
    if _MIN_LOW_SURROGATE <= u <= _MAX_LOW_SURROGATE:
        if n < 4:
            return RUNE_ERROR, 0
        u2 = b[n - 4] | (b[n - 3] << 8)
        if not (_MIN_HIGH_SURROGATE <= u2 <= _MAX_HIGH_SURROGATE):
            return RUNE_ERROR, 0
        return 0x10000 + (((u2 - 0xD800) << 10) | (u - 0xDC00)), 4
    return u, 2


def decode_rune(b, charset: int, i: int = 0):
    """Charset-aware decode. charset: 0/1 = UTF-8 (also raw bytes), 2 = UTF-16LE."""
    if charset == 2:
        return decode_utf16(b, i)
    return decode_utf8(b, i)


def decode_last_rune(b, charset: int) -> int:
    if charset == 2:
        return decode_last_utf16(b)[0]
    return decode_last_utf8(b)[0]
