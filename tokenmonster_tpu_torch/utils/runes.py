"""Rune (codepoint) decoding helpers matching the reference semantics.

Reference: go/tokenmonster.go:371-430 (decodeRune / decodeLastRune) and Go's
``unicode/utf8`` package behaviour for invalid sequences: an invalid or
truncated sequence decodes to U+FFFD with size 1 (size 0 on empty input).
"""

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


def incomplete_utf8_bytes(b) -> int:
    """Number of trailing bytes forming an incomplete UTF-8 sequence.

    Reference: go/tokenmonster.go:149-191 (including its quirk of returning
    ``seqLen - (bytesLen - seqStart)`` for a truncated sequence).
    """
    n = len(b)
    if n == 0:
        return 0
    if (b[n - 1] & 0x80) == 0:
        return 0
    seq_start = n - 1
    while seq_start >= 0 and (b[seq_start] & 0xC0) == 0x80:
        seq_start -= 1
    if seq_start == -1:
        return n
    first = b[seq_start]
    if (first & 0x80) == 0:
        seq_len = 1
    elif (first & 0xE0) == 0xC0:
        seq_len = 2
    elif (first & 0xF0) == 0xE0:
        seq_len = 3
    elif (first & 0xF8) == 0xF0:
        seq_len = 4
    else:
        return n - seq_start
    if n - seq_start < seq_len:
        return seq_len - (n - seq_start)
    if seq_len == 1 and (b[seq_start] & 0xC0) != 0:
        return n
    return 0


def incomplete_utf16_bytes(b) -> int:
    """Reference: go/tokenmonster.go:193-219."""
    n = len(b)
    if n == 0:
        return 0
    if n % 2 != 0:
        if n >= 3:
            last_three = b[n - 3] | (b[n - 2] << 8)
            if _MIN_HIGH_SURROGATE <= last_three <= _MAX_HIGH_SURROGATE:
                return 3
        return 1
    last_two = b[n - 2] | (b[n - 1] << 8)
    if _MIN_HIGH_SURROGATE <= last_two <= _MAX_HIGH_SURROGATE:
        return 2
    first_two = b[0] | (b[1] << 8)
    if _MIN_LOW_SURROGATE <= first_two <= _MAX_LOW_SURROGATE:
        return 2
    return 0
