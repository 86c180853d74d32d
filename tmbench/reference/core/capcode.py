"""Capcode's encoders, levels 2 and 1, frozen from
``tokenmonster_tpu_torch/core/capcode.py`` at commit 6d463e6b506c.

Only the pieces that the plain reference calls, each copied whole (the
native route taken out: the reference is plain Python).
``tmbench/tests/test_tmbench_frozen.py`` holds each piece to its
source at that commit; the copy stays as it is when the source
changes."""

from __future__ import annotations

from ..utils.chartypes import (
    is_letter, is_lower, is_modifier, is_number, is_upper, to_lower,
)


C_CHAR = "C"
C_WORD = "W"
C_DELETE = "D"
CHARACTER_TOKEN = ord(C_CHAR)
WORD_TOKEN = ord(C_WORD)
DELETE_TOKEN = ord(C_DELETE)
NO_CAPCODE_DELETE_TOKEN = 0x7F
_APOS = "'"
_APOS2 = "’"


def _is_letter_c(c: str) -> bool:
    return is_letter(ord(c))


def _is_upper_c(c: str) -> bool:
    return is_upper(ord(c))


def _is_lower_c(c: str) -> bool:
    return is_lower(ord(c))


def _is_number_c(c: str) -> bool:
    return is_number(ord(c))


def _is_modifier_c(c: str) -> bool:
    return is_modifier(ord(c))


def encode(data: bytes) -> bytes:
    """Capcode level-2 encode. Port of javascript/tokenmonster.js:900-1005."""
    text = data.decode("utf-8", errors="surrogateescape")
    buf: list[str] = []
    goback_pos = 0
    word_token_pos = 0
    rlast = "."
    rlast2 = "."
    in_word = False
    multi_letter = False

    for r in text:
        if in_word:
            if _is_upper_c(r):
                if not (_is_letter_c(rlast) or rlast == _APOS or rlast == _APOS2
                        or _is_modifier_c(rlast)):
                    buf.append(C_DELETE)
                    buf.append(" ")
                multi_letter = True
                buf.append(chr(to_lower(ord(r))))
            else:
                if _is_lower_c(r):
                    in_word = False
                    buf[word_token_pos] = C_CHAR
                    if multi_letter:
                        # Retroactively split a run of uppercase letters that
                        # turned out to end in lowercase: every lowercased
                        # letter in the run gets its own "DC " prefix.
                        i2 = goback_pos
                        while i2 < len(buf):
                            if (buf[i2] == C_DELETE and i2 + 1 < len(buf)
                                    and buf[i2 + 1] == " "):
                                if i2 + 2 < len(buf) and _is_lower_c(buf[i2 + 2]):
                                    buf.insert(i2 + 2, " ")
                                    buf[i2] = C_DELETE
                                    buf[i2 + 1] = C_CHAR
                                    i2 += 1
                                i2 += 3
                            else:
                                if _is_lower_c(buf[i2]):
                                    buf.insert(i2, " ")
                                    buf.insert(i2, C_CHAR)
                                    buf.insert(i2, C_DELETE)
                                    i2 += 4
                                else:
                                    i2 += 1
                    if not (_is_letter_c(rlast) or rlast == _APOS or rlast == _APOS2
                            or _is_modifier_c(rlast)):
                        buf.append(C_DELETE)
                        buf.append(" ")
                else:
                    if _is_number_c(r):
                        if not _is_number_c(rlast):
                            buf.append(C_DELETE)
                            buf.append(" ")
                    elif not (r == _APOS or r == _APOS2 or _is_modifier_c(r)):
                        in_word = False
                buf.append(r)
        else:
            if _is_lower_c(r):
                if not (rlast == " " or _is_letter_c(rlast)
                        or (_is_letter_c(rlast2) and (rlast == _APOS or rlast == _APOS2))
                        or _is_modifier_c(rlast)):
                    buf.append(C_DELETE)
                    buf.append(" ")
                buf.append(r)
            elif _is_upper_c(r):
                if rlast == " ":
                    word_token_pos = len(buf) - 1
                    buf[word_token_pos] = C_WORD
                    buf.append(" ")
                else:
                    buf.append(C_DELETE)
                    word_token_pos = len(buf)
                    buf.append(C_WORD)
                    buf.append(" ")
                buf.append(chr(to_lower(ord(r))))
                goback_pos = len(buf)
                multi_letter = False
                in_word = True
            elif _is_number_c(r):
                if not (rlast == " " or _is_number_c(rlast)):
                    buf.append(C_DELETE)
                    buf.append(" ")
                buf.append(r)
            else:
                buf.append(r)
        rlast2 = rlast
        rlast = r

    return "".join(buf).encode("utf-8", errors="surrogateescape")


def no_capcode_encode(data: bytes) -> bytes:
    """Capcode level-1 encode: insert ``0x7F + ' '`` before words/numbers
    that begin without a preceding space, with no case transformation.

    Mirrors the non-case rules of :func:`encode` with 0x7F as delete token.
    """
    text = data.decode("utf-8", errors="surrogateescape")
    out: list[str] = []
    rlast = "."
    rlast2 = "."
    marker = chr(NO_CAPCODE_DELETE_TOKEN)
    for r in text:
        if _is_letter_c(r):
            if not (rlast == " " or _is_letter_c(rlast)
                    or (_is_letter_c(rlast2) and (rlast == _APOS or rlast == _APOS2))
                    or _is_modifier_c(rlast)):
                out.append(marker)
                out.append(" ")
            out.append(r)
        elif _is_number_c(r):
            if not (rlast == " " or _is_number_c(rlast)):
                out.append(marker)
                out.append(" ")
            out.append(r)
        else:
            out.append(r)
        rlast2 = rlast
        rlast = r
    return "".join(out).encode("utf-8", errors="surrogateescape")
