"""Candidate token shape filters: clean / balanced / consistent / strict.

Line-by-line ports of training/getalltokens.go:462-1105.  Each filter
receives a raw substring whose final rune is lookahead context; it returns
(token, ok) where token is the substring with the last rune removed.

All predicates follow the getalltokens variants (getalltokens.go:297-312):
isLetter/isAlphaNum include combining marks and exclude C/W/D at capcode 2.
"""

from __future__ import annotations

from ..utils import chartypes as ct
from ..utils.runes import decode_last_utf8, decode_utf8

APOS = 0x27
APOS2 = 0x2019

DELIMITER_PAIRS = {
    "(": ")", "[": "]", "{": "}", "'": "'", '"': '"', "‘": "’", "“": "”",
    "«": "»", "‹": "›", "‛": "’", "`": "`", "„": "”", "″": "″", "〝": "〞",
    "「": "」", "『": "』", "｢": "｣", "〈": "〉", "《": "》", "‟": "”",
    "❛": "❜", "❝": "❞", "❮": "❯", "〔": "〕", "⸨": "⸩",
}
_DELIMS = set(ord(c) for pair in DELIMITER_PAIRS.items() for c in pair)
_DELIMS2 = _DELIMS | {ord("<"), ord(">")}
_PAIRS = {ord(k): ord(v) for k, v in DELIMITER_PAIRS.items()}


class Ctx:
    """Charset/capcode context for the filters."""

    def __init__(self, charset: int, using_capcode: int, words_per_token: int = 0):
        self.charset = charset
        self.capcode = using_capcode
        self.words_per_token = words_per_token

    # --- rune helpers (getalltokens.go:297-329) ---

    def decode(self, b, i=0):
        return decode_utf8(b, i) if self.charset != 2 else (0xFFFD, 0)

    def decode_last(self, b):
        return decode_last_utf8(b)

    def is_letter(self, r):
        p = ct.props_table()[r] if r >= 0 else 0
        if (p & ct.LETTER) and (self.capcode != 2 or r not in (67, 87, 68)):
            return True
        return bool(p & ct.MODIFIER)

    def is_alphanum(self, r):
        p = ct.props_table()[r] if r >= 0 else 0
        if (p & ct.LETTER) and (self.capcode != 2 or r not in (67, 87, 68)):
            return True
        return bool(p & (ct.NUMBER | ct.MODIFIER))

    def is_number(self, r):
        return r >= 0 and bool(ct.props_table()[r] & ct.NUMBER)

    def is_space(self, r):
        return r >= 0 and bool(ct.props_table()[r] & ct.WHITESPACE)

    def is_capcode(self, r):
        return ((self.capcode == 1 and r == 0x7F)
                or (self.capcode == 2 and r in (67, 87, 68)))

    def is_other(self, r):
        return not self.is_alphanum(r)

    @staticmethod
    def is_delim(r):
        return r in _DELIMS

    @staticmethod
    def is_delim2(r):
        return r in _DELIMS2

    # --- shared helpers (getalltokens.go:395-459) ---

    def strip_last_punc(self, tok: bytes) -> bytes:
        rlast, nlast = self.decode_last(tok)
        if self.is_other(rlast):
            if self.is_space(rlast) or self.is_delim(rlast) or self.is_capcode(rlast):
                return tok
            return tok[:len(tok) - nlast]
        return tok

    def strip_open_close(self, tok: bytes, r, n):
        if len(tok) <= n:
            return tok, False
        if r == 0x20:
            r, nx = self.decode(tok, 1)
            n += nx
            if len(tok) <= n:
                return tok, False
        closer = _PAIRS.get(r)
        if closer is None:
            return tok, False
        last, n2 = self.decode_last(tok)
        if last == closer and len(tok) - n2 >= n:
            return tok[n:len(tok) - n2], True
        return tok, False


def filter_clean(ctx: Ctx, tok: bytes):
    """getalltokens.go:462-537."""
    rnext, nnext = ctx.decode_last(tok)
    tok = tok[:len(tok) - nnext]
    if len(tok) < 2:
        return tok, False
    trimmed = tok

    removed = False
    for n in range(len(tok) - 1, 0, -1):
        if tok[n] not in (0x0A, 0x0D):
            tok = tok[:n + 1]
            break
        removed = True

    n_space = n_newlines = space_runs = space_char = 0
    has_alpha = has_capcode = exists = last_space = False
    double_space = other = first_space = False
    r = -1
    i = 0
    while i < len(tok):
        r, n = ctx.decode(tok, i)
        if n <= 0:
            break
        if ctx.is_letter(r) or ctx.is_number(r):
            exists = True
            has_alpha = True
            last_space = False
        elif ctx.is_capcode(r):
            has_capcode = True
        elif ctx.is_delim(r):
            exists = True
            last_space = False
        elif ctx.is_space(r):
            if i == 0:
                first_space = True
                if r == 0x20:
                    space_char = 1
            elif i == 1:
                space_char = 0
            n_space += 1
            if r in (0x0A, 0x0D, 0x09):
                n_newlines += 1
            if last_space:
                double_space = True
                if has_alpha and n_space != n_newlines:
                    return trimmed, False
            else:
                space_runs += 1
            last_space = True
        else:
            other = True
            last_space = False
        i += n
    space_runs -= space_char
    n_space -= space_char
    if double_space and (exists or (other and space_runs > 1)):
        if ((r == 0x20 and other and not removed)
                or (not last_space and not first_space and n_space > 3)
                or (not (n_space == n_newlines and space_runs <= 1)
                    and not (n_space >= len(tok) - 1
                             and (not last_space or not first_space)))):
            return trimmed, False
    if ctx.capcode != 0 and ((has_alpha or has_capcode or exists
                              or (other and ctx.is_alphanum(rnext)))
                             and r == 0x20 and not removed):
        return trimmed, False
    return trimmed, True


def filter_balanced(ctx: Ctx, tok: bytes):
    """getalltokens.go:540-632."""
    rnext, nnext = ctx.decode_last(tok)
    tok = tok[:len(tok) - nnext]
    if len(tok) < 2:
        return tok, False

    n_space = n_newlines = space_runs = 0
    has_alpha = has_capcode = exists = last_space = False
    double_space = other = first_space = has_letter = space_char = False
    r = -1
    i = 0
    while i < len(tok):
        r, n = ctx.decode(tok, i)
        if n <= 0:
            break
        if ctx.is_letter(r):
            exists = True
            has_alpha = True
            last_space = False
            has_letter = True
        elif ctx.is_number(r):
            exists = True
            has_alpha = True
            last_space = False
        elif ctx.is_capcode(r):
            has_capcode = True
        elif ctx.is_delim(r):
            exists = True
            last_space = False
        elif ctx.is_space(r):
            if i == 0:
                first_space = True
                if r == 0x20:
                    space_char = True
            elif i == 1:
                space_char = False
            n_space += 1
            if r in (0x0A, 0x0D, 0x09):
                n_newlines += 1
            if last_space:
                double_space = True
                if has_alpha:
                    return tok, False
            else:
                space_runs += 1
            last_space = True
        else:
            other = True
            last_space = False
        i += n
    if space_char:
        first_space = False
        space_runs -= 1
        n_space -= 1
    if r in (0x0A, 0x0D):
        space_runs -= 1
    if double_space and (exists or (other and space_runs > 1)):
        if (has_alpha or (r == 0x20 and other)
                or (exists and (n_space > 5
                                or (n_space > 3 and n_space != n_newlines)))
                or (not (n_space == n_newlines and space_runs <= 1)
                    and not (n_space >= len(tok) - 1
                             and (not last_space or not first_space)))):
            return tok, False
    if has_alpha and ctx.capcode == 2 and ctx.is_capcode(r):
        if len(tok) < 3:
            return tok, False
        if not ((tok[-2] in (0x2E, 0x2D))
                or ((tok[-2] == 68 or tok[-2] == 127)
                    and tok[-3] in (0x2E, 0x2D))):
            return tok, False
    if ctx.capcode != 0 and (has_alpha or has_capcode) and ctx.is_space(r):
        return tok, False
    if ctx.capcode != 0 and (other or exists) and r == 0x20:
        return tok, False
    if has_letter and ctx.is_letter(rnext) and (
            n_space >= 2 or (space_char and n_space >= 1)
            or ((n_space == 1 or (n_space == 0 and space_char))
                and tok[0] != 0x20)):
        return tok, False
    return tok, True


def _words_per_token_exceeded(ctx: Ctx, tok: bytes, n1: int) -> bool:
    if ctx.words_per_token <= 0:
        return False
    in_space = True
    n_sp = 0
    i = n1
    while i < len(tok):
        r3, n3 = ctx.decode(tok, i)
        if n3 <= 0:
            break
        if ctx.is_space(r3):
            if not in_space:
                in_space = True
                n_sp += 1
                if n_sp >= ctx.words_per_token:
                    return True
        else:
            in_space = False
        i += n3
    return False


def filter_consistent(ctx: Ctx, tok: bytes):
    """getalltokens.go:636-905."""
    rnext, nnext = ctx.decode_last(tok)
    tok = tok[:len(tok) - nnext]
    trimmed = tok
    if len(tok) < 2:
        return trimmed, False

    r1, n1 = ctx.decode(tok)
    if len(tok) > n1:
        if _words_per_token_exceeded(ctx, tok, n1):
            return trimmed, False
        r2, n2 = ctx.decode(tok, n1)
    else:
        return trimmed, True  # single multi-byte character

    tok, open_close_stripped = ctx.strip_open_close(tok, r1, n1)
    if open_close_stripped:
        if len(tok) == 0:
            return trimmed, True
        r1, n1 = ctx.decode(tok)
        if len(tok) > n1:
            r2, n2 = ctx.decode(tok, n1)
        else:
            return trimmed, True

    # allow capcode marker beginnings
    if ctx.is_capcode(r1) and (ctx.is_capcode(r2) or r2 == 0x20):
        if r2 == 0x20:
            tok = tok[1:]
            r1, n1 = 0x20, 1
        else:
            tok = tok[2:]
            r1, n1 = ctx.decode(tok)
        if len(tok) > n1:
            r2, n2 = ctx.decode(tok, n1)
        else:
            return trimmed, True

    # " letter..." words
    if r1 == 0x20 and ctx.is_letter(r2):
        apos = space = has_space = False
        hyphenok = 0
        tok = ctx.strip_last_punc(tok)
        r3 = -1
        i = n1 + n2
        while i < len(tok):
            r3, n3 = ctx.decode(tok, i)
            if n3 <= 0:
                break
            if ctx.is_letter(r3) or ctx.is_number(r3):
                space = apos = False
                hyphenok = 0
            elif r3 == 0x20:
                if space:
                    return trimmed, False
                space = True
                apos = False
                has_space = True
                hyphenok = 0
            elif r3 in (APOS, APOS2):
                if apos:
                    return trimmed, False
                apos = True
                space = False
            else:
                space = apos = False
                if r3 in (0x2D, 0x2E, 0x5F):
                    if hyphenok == 0:
                        hyphenok = 1
                    else:
                        return trimmed, False
                elif ctx.is_capcode(r3):
                    if hyphenok == 1:
                        hyphenok = 2
                    elif hyphenok == 2:
                        hyphenok = 3
                else:
                    return trimmed, False
            i += n3
        if i <= n1 + n2:
            r3 = r2
        if r3 in (0x20, 0x2E, 0x2D) or (ctx.is_capcode(r3) and hyphenok <= 1):
            return trimmed, False
        if ctx.is_letter(rnext) and has_space:
            return trimmed, False
        return trimmed, True

    # " number..."
    if r1 == 0x20 and ctx.is_number(r2):
        tok = ctx.strip_last_punc(tok)
        i = n1 + n2
        while i < len(tok):
            r3, n3 = ctx.decode(tok, i)
            if n3 <= 0 or not ctx.is_number(r3):
                return trimmed, False
            i += n3
        return trimmed, True

    if ctx.is_number(r1):
        if not ctx.is_number(r2):
            return trimmed, False
        tok = ctx.strip_last_punc(tok)
        i = n1 + n2
        while i < len(tok):
            r3, n3 = ctx.decode(tok, i)
            if n3 <= 0 or not ctx.is_number(r3):
                return trimmed, False
            i += n3
        return trimmed, True

    if ctx.is_letter(r1) and not ctx.is_letter(r2):
        return trimmed, False
    if ((r1 in (APOS, APOS2) and ctx.is_letter(r2)) or ctx.is_letter(r1)):
        tok = ctx.strip_last_punc(tok)
        i = n1 + n2
        while i < len(tok):
            r3, n3 = ctx.decode(tok, i)
            if n3 <= 0 or not ctx.is_letter(r3):
                return trimmed, False
            i += n3
        return trimmed, True

    num_delim = num_capcode = num_space = num_newline = num_other = 0
    spaces_run = max_spaces_run = n_space_runs = 0
    last_space = gt = False
    delim = -1
    delim_pos = 0
    r3 = -1
    i = 0
    while i < len(tok):
        r3, n3 = ctx.decode(tok, i)
        if n3 <= 0:
            break
        if ctx.is_alphanum(r3):
            return trimmed, False
        elif ctx.is_delim2(r3):
            num_delim += 1
            delim = r3
            delim_pos = i
            last_space = False
        elif ctx.is_capcode(r3):
            num_capcode += 1
        elif ctx.is_space(r3):
            num_space += 1
            if r3 in (0x0A, 0x0D, 0x09):
                num_newline += 1
            if last_space:
                spaces_run += 1
            else:
                if spaces_run > max_spaces_run:
                    max_spaces_run = spaces_run
                n_space_runs += 1
                spaces_run = 1
                last_space = True
        else:
            num_other += 1
            last_space = False
            if gt and r3 == 0x3C:
                return trimmed, False
            if r3 == 0x3E:
                gt = True
        i += n3
    if spaces_run > max_spaces_run:
        max_spaces_run = spaces_run
    if r3 == 0x20 and (num_other > 0 or num_capcode > 0 or num_delim > 0):
        return trimmed, False
    if ctx.is_capcode(r3):
        if (len(tok) == 2 or (len(tok) <= 4 and num_capcode == 2)
                or (num_other == 0 and num_delim == 0)):
            return trimmed, True
    if (max_spaces_run > 1
            and (num_delim != 0 or num_capcode != 0 or num_other != 0)
            and ((num_space != num_newline or (num_other + num_delim) > 3)
                 or n_space_runs > 1)):
        return trimmed, False
    if num_delim > 1 or (num_delim > 0 and open_close_stripped):
        return trimmed, False
    other_and_space = num_other + num_space + num_capcode
    if num_delim == 1:
        if delim in (0x28, 0x5B, 0x7B):      # ( [ {
            for i2 in range(delim_pos):
                if tok[i2] not in (0x2C, 0x2E, 0x20, 0x0D, 0x0A):
                    return trimmed, False
        elif delim in (0x29, 0x5D, 0x7D):    # ) ] }
            for i2 in range(delim_pos + 1, len(tok)):
                if tok[i2] not in (0x2C, 0x2E, 0x20, 0x0D, 0x0A):
                    return trimmed, False
        if ctx.is_delim(r1):
            if len(tok) <= 3 and num_space <= 1:
                return trimmed, True
        else:
            if (other_and_space <= 1
                    or (len(tok) == 3 and (r1 == 0x20 or r2 == 0x20))
                    or r1 == 0x09):
                return trimmed, True
        return trimmed, False
    return trimmed, True


def filter_strict(ctx: Ctx, tok: bytes):
    """getalltokens.go:906-1105."""
    rnext, nnext = ctx.decode_last(tok)
    tok = tok[:len(tok) - nnext]
    trimmed = tok
    if len(tok) < 2:
        return trimmed, False

    r1, n1 = ctx.decode(tok)
    if len(tok) > n1:
        if _words_per_token_exceeded(ctx, tok, n1):
            return trimmed, False
        r2, n2 = ctx.decode(tok, n1)
    else:
        return trimmed, True

    if r1 == 0x20 and ctx.is_letter(r2):
        apos = space = has_space = False
        r3 = -1
        i = n1 + n2
        while i < len(tok):
            r3, n3 = ctx.decode(tok, i)
            if n3 <= 0:
                break
            if ctx.is_letter(r3):
                space = apos = False
            elif r3 == 0x20:
                if space:
                    return trimmed, False
                has_space = True
                space = True
                apos = False
            elif r3 in (APOS, APOS2):
                if apos:
                    return trimmed, False
                apos = True
                space = False
            else:
                return trimmed, False
            i += n3
        if i <= n1 + n2:
            r3 = r2
        if r3 == 0x20:
            return trimmed, False
        if ctx.is_letter(rnext) and has_space:
            return trimmed, False
        return trimmed, True

    if r1 == 0x20 and ctx.is_number(r2):
        i = n1 + n2
        while i < len(tok):
            r3, n3 = ctx.decode(tok, i)
            if n3 <= 0 or not ctx.is_number(r3):
                return trimmed, False
            i += n3
        return trimmed, True

    if ctx.is_number(r1):
        if not ctx.is_number(r2):
            return trimmed, False
        i = n1 + n2
        while i < len(tok):
            r3, n3 = ctx.decode(tok, i)
            if n3 <= 0 or not ctx.is_number(r3):
                return trimmed, False
            i += n3
        return trimmed, True

    if ctx.is_letter(r1) and not ctx.is_letter(r2):
        return trimmed, False
    if ((r1 in (APOS, APOS2) and ctx.is_letter(r2)) or ctx.is_letter(r1)):
        i = n1 + n2
        while i < len(tok):
            r3, n3 = ctx.decode(tok, i)
            if n3 <= 0 or not ctx.is_letter(r3):
                return trimmed, False
            i += n3
        return trimmed, True

    if len(tok) == 2:
        if (r1, r2) in ((0x28, 0x29), (0x5B, 0x5D), (0x7B, 0x7D),
                        (0x22, 0x22), (0x27, 0x27)):
            return trimmed, True
        if (r1 == 0x2C or r2 == 0x2C or r1 == 0x2E) and not ctx.is_space(r2):
            return trimmed, True

    num_delim = num_capcode = num_space = num_newline = num_other = 0
    spaces_run = max_spaces_run = n_space_runs = 0
    last_space = gt = False
    r3 = -1
    i = 0
    while i < len(tok):
        r3, n3 = ctx.decode(tok, i)
        if n3 <= 0:
            break
        if ctx.is_alphanum(r3):
            return trimmed, False
        elif ctx.is_delim(r3):
            num_delim += 1
            last_space = False
        elif ctx.is_capcode(r3):
            num_capcode += 1
        elif ctx.is_space(r3):
            num_space += 1
            if r3 in (0x0A, 0x0D):
                num_newline += 1
            if last_space:
                spaces_run += 1
            else:
                if spaces_run > max_spaces_run:
                    max_spaces_run = spaces_run
                n_space_runs += 1
                spaces_run = 1
                last_space = True
        else:
            num_other += 1
            last_space = False
            if gt and r3 == 0x3C:
                return trimmed, False
            if r3 == 0x3E:
                gt = True
        i += n3
    if spaces_run > max_spaces_run:
        max_spaces_run = spaces_run

    if ctx.is_capcode(r3) and (len(tok) == 2
                               or (len(tok) == 3 and num_capcode == 2)):
        return trimmed, True
    if num_space != len(tok) and r3 == 0x20:
        return trimmed, False
    if (max_spaces_run > 1
            and (num_delim != 0 or num_capcode != 0 or num_other != 0)
            and ((num_space != num_newline or num_other > 1 or n_space_runs > 1)
                 or (r3 not in (0x0A, 0x0D) and not ctx.is_capcode(r3)))):
        return trimmed, False
    other_and_space = num_other + num_space + num_capcode
    if num_delim > 1:
        return trimmed, False
    if num_delim == 1:
        if (other_and_space == 0
                or (other_and_space - num_capcode == 1 and r1 == 0x20)):
            return trimmed, True
        if other_and_space == 1 and ctx.is_space(r1) and r1 != 0x09:
            return trimmed, True
        return trimmed, False
    return trimmed, True


FILTERS = {1: filter_clean, 2: filter_balanced, 3: filter_consistent,
           4: filter_strict}
