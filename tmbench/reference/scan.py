"""The plain reference's tokenizer loop, resumable and recorded.

Derived from the frozen ``core/tokenizer.py`` (the exact 6-branch ungreedy
loop of go/tokenmonster.go): the same branches, scores and tie order, run
from a start position over the whole text (so lookahead past a piece's end
sees the real bytes) until the first decision at or past ``stop``.  Each
decision is recorded as an event: the position after it, its forward-delete
flag, the ids it emitted (none, one, or a token and the delete token) and
whether it skipped a missing byte.  The state after a decision is (position,
forward-delete flag): the match the next decision starts from is a function
of that state and the text, so two runs that reach one state emit the same
events from there on.  ``pieces`` uses that to run a long text as pieces in
parallel and splice them where they meet.  The tests hold ``scan`` over a
whole text equal to the frozen ``tokenize``."""

from __future__ import annotations

import numpy as np

from .core.tokenmeta import DOES_NOT_EXIST

NEG_INF = -1000000


class Events:
    """Decisions as arrays: pos (int64), fd (int8), ntok (int8), miss
    (int8), id0 and id1 (int64, -1 where not emitted)."""

    __slots__ = ("pos", "fd", "ntok", "miss", "id0", "id1")

    def __init__(self, pos, fd, ntok, miss, id0, id1):
        self.pos = np.asarray(pos, np.int64)
        self.fd = np.asarray(fd, np.int8)
        self.ntok = np.asarray(ntok, np.int8)
        self.miss = np.asarray(miss, np.int8)
        self.id0 = np.asarray(id0, np.int64)
        self.id1 = np.asarray(id1, np.int64)

    def __len__(self):
        return len(self.pos)

    def cut(self, a: int, b: int | None = None) -> "Events":
        return Events(*(getattr(self, k)[a:b] for k in self.__slots__))

    @staticmethod
    def join(parts) -> "Events":
        return Events(*(np.concatenate([getattr(p, k) for p in parts])
                        for k in Events.__slots__))


def scan(vocab, data: bytes, start: int = 0, stop: int | None = None,
         greedy: bool = False):
    """Events of the loop over normalized ``data`` from position ``start``
    (forward delete 0) through the first decision at or past ``stop``
    (default: the end).  ``greedy`` takes the longest match at every step
    and evaluates no branch: the control, which breaks the configuration's
    guarantee of the exact ungreedy tokenization."""
    pos_l, fd_l, ntok_l, miss_l, id0_l, id1_l = [], [], [], [], [], []
    len_data = len(data)
    stop = len_data if stop is None else min(stop, len_data)
    if len_data == 0:
        return Events(pos_l, fd_l, ntok_l, miss_l, id0_l, id1_l)

    dictionary = vocab.dictionary
    flag_a = vocab.flag
    nwords_a = vocab.nwords
    index1_a = vocab.index1
    index2_a = vocab.index2
    len1_a = vocab.len1
    len2_a = vocab.len2
    id_a = vocab.id
    id1_a = vocab.id1
    id2_a = vocab.id2
    begin_byte = vocab.begin_byte
    max_len = vocab.max_token_length
    delete_token = vocab.delete_token
    unk_token = vocab.unk_token
    has_delete = delete_token != DOES_NOT_EXIST
    has_unk = unk_token != DOES_NOT_EXIST

    lilbuf_offset = 2 if vocab.charset == 2 else 1
    max_len_with_space = max_len - lilbuf_offset
    lilbuf_prefix = b" \x00"[:lilbuf_offset]

    data = bytes(data) + b"\x00"
    ls = dictionary.longest_substring

    def emit(i, fd, ntok, miss, a, b):
        pos_l.append(i)
        fd_l.append(fd)
        ntok_l.append(ntok)
        miss_l.append(miss)
        id0_l.append(a)
        id1_l.append(b)

    i = start
    forward_delete = 0
    while i < stop:
        index, length, found = ls(data, i, min(len_data - i, max_len))
        if not found:
            i += 1
            forward_delete = 0
            emit(i, 0, 1 if has_unk else 0, 1,
                 unk_token if has_unk else -1, -1)
            continue

        while True:  # checkpoint loop
            orig_flag = flag_a[index]
            i1 = i + length

            if not greedy and i1 < len_data and ((orig_flag & 32) == 0 or begin_byte[data[i1]] != 12):
                score1 = score2 = score3 = NEG_INF
                score1b = score2b = score3b = NEG_INF
                max_score = NEG_INF
                index1b = index2b = index3b = 0
                length1b = length2b = length3b = 0
                index2_ = index3_ = 0
                length2_ = length3_ = 0

                index1_, length1_, found1 = ls(data, i1, min(len_data - i1, max_len))

                if found1:
                    nwords = int(nwords_a[index]) - forward_delete
                    sflag = int(flag_a[index1_])
                    snw = int(nwords_a[index1_])
                    next_byte = int(begin_byte[data[i1 + length1_]])
                    of = int(orig_flag)
                    score1 = ((length + length1_
                               + (of >> 7) + (sflag >> 7)
                               + max(0, nwords - 1) + max(0, snw - 1)
                               + ((sflag >> 2) & 1)
                               + ((next_byte >> 2) & 1)
                               + (nwords + snw + (next_byte >> 3)) * 100)
                              - ((of & 1 & (sflag >> 1)) * 103
                                 + (((of >> 3) & 1 & (sflag >> 4)) * 100)
                                 + (sflag & 1 & next_byte) * 3))
                    max_score = score1

                    if has_delete and (sflag & 2) != 0 and next_byte == 1 and snw == 0:
                        l1b = min(len_data - i1, max_len_with_space)
                        lil = lilbuf_prefix + data[i1:i1 + l1b]
                        index1b, length1b, _f = ls(lil, 0, l1b + lilbuf_offset)
                        if length1b > length1_ + 1:
                            length1b -= lilbuf_offset
                            sflag = int(flag_a[index1b])
                            snw = int(nwords_a[index1b])
                            next_byte = int(begin_byte[data[i1 + length1b]])
                            score1b = ((length + length1b
                                        + (of >> 7) + (sflag >> 7)
                                        + max(0, nwords - 1) + max(0, snw - 1)
                                        + ((next_byte >> 2) & 1)
                                        + (nwords + snw + (next_byte >> 3)) * 100)
                                       - ((of & 1) * 103
                                          + (((of >> 3) & 1 & (sflag >> 4)) * 100)
                                          + (sflag & 1 & next_byte) * 3
                                          + 1))
                            max_score = max(max_score, score1b)

                if index1_a[index] != DOES_NOT_EXIST:
                    alt_index = int(index1_a[index])
                    alt_len = int(len1_a[index])
                    i2 = i + alt_len - forward_delete
                    index2_, length2_, found2 = ls(data, i2, min(len_data - i2, max_len))

                    if found2:
                        fflag = int(flag_a[alt_index])
                        nwords = int(nwords_a[alt_index]) - forward_delete
                        sflag = int(flag_a[index2_])
                        snw = int(nwords_a[index2_])
                        next_byte = int(begin_byte[data[i2 + length2_]])
                        branch_length = alt_len + length2_ - forward_delete
                        score2 = ((branch_length
                                   + (fflag >> 7) + (sflag >> 7)
                                   + max(0, nwords - 1) + max(0, snw - 1)
                                   + ((sflag >> 2) & 1)
                                   + ((next_byte >> 2) & 1)
                                   + (nwords + snw + (next_byte >> 3)) * 100)
                                  - ((fflag & 1 & (sflag >> 1)) * 103
                                     + (((fflag >> 3) & 1 & (sflag >> 4)) * 100)
                                     + (sflag & 1 & next_byte) * 3
                                     + (100 if branch_length < length else 0)
                                     + (10000 if branch_length == length else 0)))
                        max_score = max(max_score, score2)

                        if has_delete and (sflag & 2) != 0 and next_byte == 1 and snw == 0:
                            l2b = min(len_data - i2, max_len_with_space)
                            lil = lilbuf_prefix + data[i2:i2 + l2b]
                            index2b, length2b, _f = ls(lil, 0, l2b + lilbuf_offset)
                            if length2b > length2_ + 1:
                                length2b -= lilbuf_offset
                                sflag = int(flag_a[index2b])
                                snw = int(nwords_a[index2b])
                                branch_length = alt_len + length2b - forward_delete
                                next_byte = int(begin_byte[data[i2 + length2b]])
                                score2b = ((branch_length
                                            + (fflag >> 7) + (sflag >> 7)
                                            + max(0, nwords - 1) + max(0, snw - 1)
                                            + ((next_byte >> 2) & 1)
                                            + (nwords + snw + (next_byte >> 3)) * 100)
                                           - ((fflag & 1) * 103
                                              + (((fflag >> 3) & 1 & (sflag >> 4)) * 100)
                                              + (sflag & 1 & next_byte) * 3
                                              + 1
                                              + (100 if branch_length < length else 0)
                                              + (10000 if branch_length == length else 0)))
                                max_score = max(max_score, score2b)

                    if index2_a[index] != DOES_NOT_EXIST:
                        alt2_index = int(index2_a[index])
                        alt2_len = int(len2_a[index])
                        i3 = i + alt2_len - forward_delete
                        index3_, length3_, found3 = ls(data, i3, min(len_data - i3, max_len))

                        if found3:
                            fflag = int(flag_a[alt2_index])
                            nwords = int(nwords_a[alt2_index]) - forward_delete
                            sflag = int(flag_a[index3_])
                            snw = int(nwords_a[index3_])
                            next_byte = int(begin_byte[data[i3 + length3_]])
                            branch_length = alt2_len + length3_ - forward_delete
                            score3 = ((branch_length
                                       + (fflag >> 7) + (sflag >> 7)
                                       + max(0, nwords - 1) + max(0, snw - 1)
                                       + ((sflag >> 2) & 1)
                                       + ((next_byte >> 2) & 1)
                                       + (nwords + snw + (next_byte >> 3)) * 100)
                                      - ((fflag & 1 & (sflag >> 1)) * 103
                                         + (((fflag >> 3) & 1 & (sflag >> 4)) * 100)
                                         + (sflag & 1 & next_byte) * 3
                                         + (100 if branch_length < length else 0)
                                         + (10000 if branch_length == length else 0)))
                            max_score = max(max_score, score3)

                            if has_delete and (sflag & 2) != 0 and next_byte == 1 and snw == 0:
                                l3b = min(len_data - i3, max_len_with_space)
                                lil = lilbuf_prefix + data[i3:i3 + l3b]
                                index3b, length3b, _f = ls(lil, 0, l3b + lilbuf_offset)
                                if length3b > length3_ + 1:
                                    length3b -= lilbuf_offset
                                    sflag = int(flag_a[index3b])
                                    snw = int(nwords_a[index3b])
                                    branch_length = alt2_len + length3b - forward_delete
                                    next_byte = int(begin_byte[data[i3 + length3b]])
                                    score3b = ((branch_length
                                                + (fflag >> 7) + (sflag >> 7)
                                                + max(0, nwords - 1) + max(0, snw - 1)
                                                + ((next_byte >> 2) & 1)
                                                + (nwords + snw + (next_byte >> 3)) * 100)
                                               - ((fflag & 1) * 103
                                                  + (((fflag >> 3) & 1 & (sflag >> 4)) * 100)
                                                  + (sflag & 1 & next_byte) * 3
                                                  + 1
                                                  + (100 if branch_length < length else 0)
                                                  + (10000 if branch_length == length else 0)))
                                    max_score = max(max_score, score3b)

                # Winner selection, tie order matching the Go switch
                if max_score == NEG_INF:
                    pass  # fall through to the skip path below
                elif max_score == score1:
                    tok = int(id_a[index])
                    i += length
                    length = length1_
                    index = index1_
                    forward_delete = 0
                    emit(i, 0, 1, 0, tok, -1)
                    if i >= stop:
                        break
                    continue
                elif max_score == score2:
                    tok = int(id1_a[index])
                    i += int(len1_a[index]) - forward_delete
                    length = length2_
                    index = index2_
                    forward_delete = 0
                    emit(i, 0, 1, 0, tok, -1)
                    if i >= stop:
                        break
                    continue
                elif max_score == score3:
                    tok = int(id2_a[index])
                    i += int(len2_a[index]) - forward_delete
                    length = length3_
                    index = index3_
                    forward_delete = 0
                    emit(i, 0, 1, 0, tok, -1)
                    if i >= stop:
                        break
                    continue
                elif max_score == score1b:
                    tok = int(id_a[index])
                    i += length
                    length = length1b
                    index = index1b
                    forward_delete = 1
                    emit(i, 1, 2, 0, tok, delete_token)
                    if i >= stop:
                        break
                    continue
                elif max_score == score2b:
                    tok = int(id1_a[index])
                    i += int(len1_a[index]) - forward_delete
                    length = length2b
                    index = index2b
                    forward_delete = 1
                    emit(i, 1, 2, 0, tok, delete_token)
                    if i >= stop:
                        break
                    continue
                elif max_score == score3b:
                    tok = int(id2_a[index])
                    i += int(len2_a[index]) - forward_delete
                    length = length3b
                    index = index3b
                    forward_delete = 1
                    emit(i, 1, 2, 0, tok, delete_token)
                    if i >= stop:
                        break
                    continue

            # Skipped branch evaluation (fast path / no lookahead found)
            tok = int(id_a[index])
            i += length
            forward_delete = 0
            emit(i, 0, 1, 0, tok, -1)
            break

    return Events(pos_l, fd_l, ntok_l, miss_l, id0_l, id1_l)


def ids_of(ev: Events) -> np.ndarray:
    """The id stream of ``ev``, as the tokenizer returns it (u32)."""
    both = np.stack([ev.id0, ev.id1], 1)
    keep = np.stack([ev.ntok >= 1, ev.ntok == 2], 1)
    return both[keep].astype(np.uint32)

