"""Host reference tokenizer: the exact 6-branch ungreedy loop.

This is the semantic oracle for the TPU kernels — a direct port of
go/tokenmonster.go:1017-1279 (``tokenize``) with the exact score formula
(:1075-1084) and branch tie-breaking order (score1 > score2 > score3 >
score1b > score2b > score3b, matching the Go ``switch maxScore``).

The fast paths live elsewhere: the C++ native module (native/) for host
serving, and the Pallas kernel (ops/) for TPU.  Both are validated against
this implementation token-for-token.
"""

from __future__ import annotations

import numpy as np

from .tokenmeta import DOES_NOT_EXIST

NEG_INF = -1000000


def tokenize(vocab, data: bytes, emit_offsets: bool = False):
    """Tokenize normalized+capcoded bytes. Returns (ids, missing).

    With ``emit_offsets`` also returns, per emitted token, the byte offset at
    which the *next* match begins together with the forwardDelete flag —
    the automaton state used for chunk-parallel reconciliation.
    """
    tokens: list[int] = []
    offsets: list[tuple[int, int]] = []
    missing = 0
    if len(data) == 0:
        return (np.zeros(0, np.uint32), 0) if not emit_offsets else (
            np.zeros(0, np.uint32), 0, offsets)

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

    lilbuf_offset = 2 if vocab.charset == 2 else 1
    max_len_with_space = max_len - lilbuf_offset
    lilbuf_prefix = b" \x00"[:lilbuf_offset]

    len_data = len(data)
    # one lookahead byte beyond the end (go :1039-1046)
    data = bytes(data) + b"\x00"

    ls = dictionary.longest_substring

    i = 0
    forward_delete = 0
    while i < len_data:
        index, length, found = ls(data, i, min(len_data - i, max_len))
        if not found:
            if unk_token != DOES_NOT_EXIST:
                tokens.append(unk_token)
            i += 1
            missing += 1
            forward_delete = 0
            continue

        while True:  # checkpoint loop
            orig_flag = flag_a[index]
            i1 = i + length

            if i1 < len_data and ((orig_flag & 32) == 0 or begin_byte[data[i1]] != 12):
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

                # Winner selection, tie order matching the Go switch (:1217-1262)
                if max_score == NEG_INF:
                    pass  # fall through to the skip path below
                elif max_score == score1:
                    tokens.append(int(id_a[index]))
                    i += length
                    length = length1_
                    index = index1_
                    forward_delete = 0
                    if emit_offsets:
                        offsets.append((i, 0))
                    continue
                elif max_score == score2:
                    tokens.append(int(id1_a[index]))
                    i += int(len1_a[index]) - forward_delete
                    length = length2_
                    index = index2_
                    forward_delete = 0
                    if emit_offsets:
                        offsets.append((i, 0))
                    continue
                elif max_score == score3:
                    tokens.append(int(id2_a[index]))
                    i += int(len2_a[index]) - forward_delete
                    length = length3_
                    index = index3_
                    forward_delete = 0
                    if emit_offsets:
                        offsets.append((i, 0))
                    continue
                elif max_score == score1b:
                    tokens.append(int(id_a[index]))
                    tokens.append(delete_token)
                    i += length
                    length = length1b
                    index = index1b
                    forward_delete = 1
                    if emit_offsets:
                        offsets.append((i, 1))
                    continue
                elif max_score == score2b:
                    tokens.append(int(id1_a[index]))
                    tokens.append(delete_token)
                    i += int(len1_a[index]) - forward_delete
                    length = length2b
                    index = index2b
                    forward_delete = 1
                    if emit_offsets:
                        offsets.append((i, 1))
                    continue
                elif max_score == score3b:
                    tokens.append(int(id2_a[index]))
                    tokens.append(delete_token)
                    i += int(len2_a[index]) - forward_delete
                    length = length3b
                    index = index3b
                    forward_delete = 1
                    if emit_offsets:
                        offsets.append((i, 1))
                    continue

            # Skipped branch evaluation (fast path / no lookahead found)
            tokens.append(int(id_a[index]))
            i += length
            forward_delete = 0
            if emit_offsets:
                offsets.append((i, 0))
            break

    ids = np.asarray(tokens, dtype=np.uint32)
    if emit_offsets:
        return ids, missing, offsets
    return ids, missing


def tokenize_count(vocab, data: bytes):
    ids, missing = tokenize(vocab, data)
    return len(ids), missing


def serialize_tokens(ids, encoding_length: int) -> bytes:
    ids = np.asarray(ids, dtype=np.uint32)
    if encoding_length == 2:
        return ids.astype("<u2").tobytes()
    if encoding_length == 3:
        b4 = ids.astype("<u4").tobytes()
        arr = np.frombuffer(b4, np.uint8).reshape(-1, 4)
        return arr[:, :3].tobytes()
    if encoding_length == 4:
        return ids.astype("<u4").tobytes()
    raise ValueError("Invalid encoding length")


def deserialize_tokens(data: bytes, encoding_length: int) -> np.ndarray:
    if encoding_length == 2:
        n = len(data) // 2
        return np.frombuffer(data[:n * 2], "<u2").astype(np.uint32)
    if encoding_length == 3:
        n = len(data) // 3
        arr = np.frombuffer(data[:n * 3], np.uint8).reshape(-1, 3).astype(np.uint32)
        return arr[:, 0] | (arr[:, 1] << 8) | (arr[:, 2] << 16)
    if encoding_length == 4:
        n = len(data) // 4
        return np.frombuffer(data[:n * 4], "<u4").astype(np.uint32)
    raise ValueError("Invalid encoding length")
