"""A token's flags, word count and ungreedy alternatives, frozen from
``tokenmonster_tpu_torch/core/tokenmeta.py`` at commit 6d463e6b506c: the
classification pass of go/tokenmonster.go:3486-3788, which builds every
vocabulary, a trainer's candidates among them.

Only the pieces that the plain reference calls, each copied whole.
``tmbench/tests/test_tmbench_frozen_train.py`` holds each piece to its
source at that commit; the copy stays as it is when the source
changes."""

from __future__ import annotations

from ..utils import chartypes as ct
from ..utils.runes import decode_last_rune, decode_rune
from .capcode import CHARACTER_TOKEN, NO_CAPCODE_DELETE_TOKEN, WORD_TOKEN
from .tokenmeta import DOES_NOT_EXIST


_UNGREEDY_SUFFIXES = (b"'s", "’s".encode("utf-8"))


def is_letter_tm(r: int, using_capcode: int) -> bool:
    """go/tokenmonster.go:359-361: letters plus combining marks; capcode 2
    treats the marker letters C/W/D as non-letters."""
    if r < 0:
        return False
    p = ct.props_table()[r]
    if (p & ct.LETTER) and (using_capcode != 2 or r not in (67, 87, 68)):
        return True
    return bool(p & ct.MODIFIER)


def is_alphanum_tm(r: int, using_capcode: int) -> bool:
    if r < 0:
        return False
    p = ct.props_table()[r]
    if (p & ct.LETTER) and (using_capcode != 2 or r not in (67, 87, 68)):
        return True
    return bool(p & (ct.NUMBER | ct.MODIFIER))


def is_capcode_tm(r: int, using_capcode: int) -> bool:
    return ((using_capcode == 1 and r == NO_CAPCODE_DELETE_TOKEN)
            or (using_capcode == 2 and r in (67, 87, 68)))


def _is_number(r: int) -> bool:
    return r >= 0 and bool(ct.props_table()[r] & ct.NUMBER)


def _is_space(r: int) -> bool:
    return r >= 0 and bool(ct.props_table()[r] & ct.WHITESPACE)


def has_suffix_pos(token: bytes, charset: int, using_capcode: int) -> int:
    """go/tokenmonster.go:287-299: position of an "'s" style suffix."""
    for suffix in _UNGREEDY_SUFFIXES:
        if token.endswith(suffix) and len(suffix) < len(token):
            r = decode_last_rune(token[:len(token) - len(suffix)], charset)
            if is_letter_tm(r, using_capcode):
                return len(token) - len(suffix)
    return -1


def classify_token(token: bytes, charset: int, using_capcode: int):
    """Returns (flag, nwords, min_alt_size, begin_bucket).

    begin_bucket is the beginByte histogram column for this token's first
    byte: 0=space, 1=letter, 2=number, 3=other (go/tokenmonster.go:3521-3542).
    """
    flag = 0
    nwords = 0
    min_alt_size = 1
    r, n = decode_rune(token, charset)
    r2, n2 = decode_rune(token, charset, n)

    if r == 0x20:
        flag = 4
        bucket = 0
        if is_alphanum_tm(r2, using_capcode):
            nwords += 1
            min_alt_size = 2
    elif is_letter_tm(r, using_capcode):
        flag = 2
        bucket = 1
    elif is_capcode_tm(r, using_capcode):
        if r == CHARACTER_TOKEN or r == WORD_TOKEN:
            flag = 4  # counts as a space
        flag |= 16
        bucket = 3
    elif _is_number(r):
        bucket = 2
    else:
        bucket = 3

    only_letter_space = False
    only_number_space = False
    only_punc = False
    if len(token) == 1:
        only_punc = True
    else:
        if (r == 0x20 or is_letter_tm(r, using_capcode)) and is_letter_tm(r2, using_capcode):
            only_letter_space = True
        elif (r == 0x20 or _is_number(r)) and _is_number(r2):
            only_number_space = True
        elif not is_alphanum_tm(r, using_capcode) and not is_alphanum_tm(r2, using_capcode):
            only_punc = True
        i = n + n2
        while i < len(token):
            r = r2
            r2, n2 = decode_rune(token, charset, i)
            if n2 <= 0:
                break
            if r == 0x20 and is_alphanum_tm(r2, using_capcode):
                nwords += 1
            if is_letter_tm(r2, using_capcode):
                only_punc = False
                only_number_space = False
            elif _is_number(r2):
                only_punc = False
                only_letter_space = False
            elif r2 != 0x20:
                only_letter_space = False
                only_number_space = False
            i += n2

    last = decode_last_rune(token, charset)
    if min_alt_size == 2 and is_letter_tm(last, using_capcode) and only_letter_space:
        if nwords == 1:
            flag |= 32
    if min_alt_size == 2 and nwords <= 1:
        min_alt_size = 1
    if is_capcode_tm(last, using_capcode):
        flag |= 8
    if is_letter_tm(last, using_capcode):
        flag |= 1
    if only_letter_space or only_number_space or only_punc:
        flag |= 128
    return flag, nwords, min_alt_size, bucket


def compute_alternatives(token: bytes, dictionary, charset: int,
                         using_capcode: int, min_alt_size: int):
    """Select the two preferred strict-prefix alternatives for ``token``.

    Port of go/tokenmonster.go:3595-3764. Returns
    (index1, length1, index2, length2) with DOES_NOT_EXIST for absent slots
    and alt1 guaranteed to be the better one.
    """
    index1 = DOES_NOT_EXIST
    index2 = DOES_NOT_EXIST
    length1 = 0
    length2 = 0
    priority1 = 0
    priority2 = 0
    hassuffix = has_suffix_pos(token, charset, using_capcode)

    def place(index, length, priority):
        nonlocal index1, index2, length1, length2, priority1, priority2
        if priority1 < priority2 or (priority1 == priority2 and length1 <= length2):
            if priority1 < priority:
                index1 = index
                length1 = length
                priority1 = priority
        else:
            if priority2 < priority:
                index2 = index
                length2 = length
                priority2 = priority

    for length in range(len(token) - 1, min_alt_size - 1, -1):
        subword = token[:length]
        idx, found = dictionary.find(subword)
        if not found:
            continue

        # space + letter/number boundary => priority 10
        if length <= len(token) - 2 and token[length] == 0x20:
            r, _ = decode_rune(token, charset, length + 1)
            if is_letter_tm(r, using_capcode) or _is_number(r):
                place(idx, length, 10)
                continue

        r = decode_last_rune(subword, charset)
        r2, _ = decode_rune(token, charset, length)

        if using_capcode == 0:
            if (((not is_letter_tm(r, 0) and r != 0x5F)
                 and (is_letter_tm(r2, 0) or r2 == 0x5F))
                    or (not _is_number(r) and _is_number(r2))):
                place(idx, length, 9)
                continue

        if (((is_letter_tm(r, using_capcode) or r == 0x5F)
             and (not is_letter_tm(r2, using_capcode) and r2 != 0x5F))
                or (_is_number(r) and not _is_number(r2))):
            place(idx, length, 9)
            continue
        if _is_space(r) and not _is_space(r2):
            place(idx, length, 7)
            continue
        if not _is_space(r) and _is_space(r2):
            place(idx, length, 8)
            continue
        if is_capcode_tm(r2, using_capcode):
            place(idx, length, 9)
            continue

        if length == hassuffix:
            place(idx, length, 8)
            break

        place(idx, length, 1)

    if length1 == 0 and length2 > 0:
        raise AssertionError("alternative sanity check failed")

    # Make sure the first alternative is the better one (go :3761-3764).
    if length2 > 0 and (priority2 > priority1
                        or (priority2 == priority1 and length2 > length1)):
        index1, index2 = index2, index1
        length1, length2 = length2, length1
    return index1, length1, index2, length2
