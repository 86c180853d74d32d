"""Capcode: lossless re-encoding of uppercase letters with marker characters.

Port of the reference capcode codec. The complete in-repo reference
implementation is javascript/tokenmonster.js:872-1065 (``capcode_encode`` and
``CapcodeDecoder``); the Go library consumes the external
``alasdairforsythe/capcode`` package with identical semantics
(go/tokenmonster.go:233-240).

Marker characters (capcode level 2):
  'C' — uppercase the next character
  'W' — uppercase until the end of the current word
  'D' — delete the next character (used to glue " word" tokens mid-text)

Capcode level 1 ("noCapcode") uses a single marker byte 0x7F as the delete
token and applies no case transformation; its encoder inserts ``0x7F + ' '``
before words that do not begin with a space so that space-prefixed word
tokens can always be used (go/tokenmonster.go:367-369, getalltokens.go:302).

All functions operate on ``bytes`` (UTF-8).
"""

from __future__ import annotations

from ..utils.chartypes import (
    is_letter, is_lower, is_modifier, is_number, is_upper, to_lower, to_upper,
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
    """Capcode level-2 encode. Port of javascript/tokenmonster.js:900-1005.

    Routes through the native encoder (tm_capcode_encode — byte-exact vs
    this Python port, tests/test_capcode_native.py) when available: the
    Python loop costs ~5 us/byte and dominated getalltokens' profile."""
    try:
        from .. import native
        out = native.native_capcode_encode(data)
        if out is not None:
            return out
    except Exception:
        pass
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
    try:
        from .. import native
        out_n = native.native_nocapcode_encode(data)
        if out_n is not None:
            return out_n
    except Exception:
        pass
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


class Decoder:
    """Streaming capcode decoder; state persists across chunks.

    Port of javascript/tokenmonster.js:1007-1065 (level 2) plus the level-1
    variant. Feed complete UTF-8 chunks (the caller holds back incomplete
    rune tails; see core.decoder).
    """

    def __init__(self):
        self.in_word = False
        self.in_char = False
        self.delete = False
        self.ignore = False

    def _native(self, data: bytes, fn_name: str):
        """Run the native stateful decode loop (tm_capcode_decode /
        tm_nocapcode_decode) with this decoder's carried state; returns None
        when the native library is unavailable."""
        try:
            import numpy as np

            from .. import native
            fn = getattr(native, fn_name)
        except Exception:
            return None
        state = np.array([self.in_word, self.in_char, self.delete,
                          self.ignore], np.uint8)
        out = fn(data, state)
        if out is None:
            return None
        self.in_word, self.in_char, self.delete, self.ignore = (
            bool(state[0]), bool(state[1]), bool(state[2]), bool(state[3]))
        return out

    def decode(self, data: bytes) -> bytes:
        out_n = self._native(data, "native_capcode_decode")
        if out_n is not None:
            return out_n
        out: list[str] = []
        for r in data.decode("utf-8", errors="surrogateescape"):
            # Marker characters do not clear `ignore` (the JS switch
            # `continue`s past the trailing `ignore = false`).
            if r == C_CHAR:
                self.in_char = True
                self.in_word = False
                continue
            if r == C_WORD:
                self.in_word = True
                self.in_char = False
                self.ignore = True
                continue
            if r == C_DELETE:
                self.delete = True
                continue
            if r == " ":
                if self.delete:
                    self.delete = False
                else:
                    out.append(" ")
                    if not self.ignore:
                        self.in_word = False
            else:
                if self.delete:
                    self.delete = False
                elif self.in_char:
                    self.in_char = False
                    out.append(chr(to_upper(ord(r))))
                elif self.in_word:
                    if _is_lower_c(r) or _is_upper_c(r):
                        out.append(chr(to_upper(ord(r))))
                    else:
                        out.append(r)
                        if not (_is_number_c(r) or r == _APOS or r == _APOS2
                                or _is_modifier_c(r)):
                            self.in_word = False
                else:
                    out.append(r)
            self.ignore = False
        return "".join(out).encode("utf-8", errors="surrogateescape")

    def no_capcode_decode(self, data: bytes) -> bytes:
        out_n = self._native(data, "native_nocapcode_decode")
        if out_n is not None:
            return out_n
        out: list[str] = []
        marker = chr(NO_CAPCODE_DELETE_TOKEN)
        for r in data.decode("utf-8", errors="surrogateescape"):
            if r == marker:
                self.delete = True
                continue
            if self.delete:
                self.delete = False
                continue
            out.append(r)
        return "".join(out).encode("utf-8", errors="surrogateescape")


def decode(data: bytes) -> bytes:
    return Decoder().decode(data)


def no_capcode_decode(data: bytes) -> bytes:
    return Decoder().no_capcode_decode(data)
