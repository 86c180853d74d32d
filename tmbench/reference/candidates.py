"""A trainer candidate's vocabulary and score by the plain reference.

The candidate is the vocabulary the program built for it, written as a
``.vocab`` file and read by the frozen loader (``core/vocab.py``), as a
tokenizer cell reads its vocabulary file.  ``vocab_faults`` holds that
file to the token list the candidate was drawn as: every token, id,
flag, word count, ungreedy alternative and begin-byte class as
PrivateGenerateVocab makes them (go/tokenmonster.go:3363-3788), the
classification by the frozen pass (``core/classify.py``).  Each strip the
candidate scored is run through the frozen ungreedy loop (``scan.py``)
on its own, from its first byte, and the events are counted as
trainvocab.go counts them (:1105-1160): a decision that emits a token
adds the bytes it consumed to that token's score (the delete token,
emitted after it, adds 1), every decision adds its tokens to the count
(a missing byte counts one), and a missing byte's value joins the
missing set.  Imports nothing of the program and no torch."""

from __future__ import annotations

import numpy as np

from .core.capcode import DELETE_TOKEN, NO_CAPCODE_DELETE_TOKEN
from .core.classify import classify_token, compute_alternatives, \
    is_alphanum_tm
from .core.dictionary import MAX_KEY_LEN, sort_key
from .core.tokenmeta import DOES_NOT_EXIST
from .core.vocab import Vocab
from .utils.runes import decode_rune


class _Keys:
    """A sorted key set's ``find``, as ``compute_alternatives`` calls it."""

    def __init__(self, keys: list):
        self.index = {k: i for i, k in enumerate(keys)}

    def find(self, key: bytes):
        i = self.index.get(key)
        return (0, False) if i is None else (i, True)


def expected(tokens: list, specials: frozenset, charset: int,
             capcode: int) -> dict:
    """The vocabulary a candidate drawn as ``tokens`` (singles, tokens
    and specials, encoded) is built as, ids reset: ``reverse`` (the
    tokens by id: the list less a token that holds a special, sorted by
    length, then bytes), ``keys`` (those and, with capcode, each one that
    begins with a letter or number again behind the delete marker and a
    space, same id, score -1), and by key ``id``, ``score``, ``flag``,
    ``nwords``, ``index1``, ``index2``; ``begin_byte`` (the class most
    non-special keys that begin with a byte have, where more than two
    do) and ``delete_token``."""
    special = [t for t in tokens if t in specials]
    regular = {t for t in tokens if t not in specials
               and 0 < len(t) <= MAX_KEY_LEN
               and not any(s in t for s in special)}
    reverse = sorted(regular | set(special), key=sort_key)
    ids = {t: i for i, t in enumerate(reverse)}
    score = dict.fromkeys(reverse, 0.0)
    special_keys = set(special)
    marker = bytes([NO_CAPCODE_DELETE_TOKEN if capcode == 1
                    else DELETE_TOKEN]) + b" "
    for t in reverse:
        if capcode and is_alphanum_tm(decode_rune(t, charset)[0], capcode):
            d = marker + t
            if t in special_keys:
                special_keys.add(d)
            if len(d) <= MAX_KEY_LEN:
                ids[d], score[d] = ids[t], -1.0
    keys = sorted(ids, key=sort_key)
    found = _Keys(keys)
    n = len(keys)
    flag, nwords = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
    index1 = np.full(n, DOES_NOT_EXIST, np.uint32)
    index2 = np.full(n, DOES_NOT_EXIST, np.uint32)
    counts = np.zeros((256, 4), np.int64)
    for i, t in enumerate(keys):
        if t in special_keys:
            flag[i] = 64
            continue
        flag[i], nwords[i], least, bucket = classify_token(t, charset,
                                                           capcode)
        counts[t[0], bucket] += 1
        index1[i], _l1, index2[i], _l2 = compute_alternatives(
            t, found, charset, capcode, least)
    begin = np.zeros(256, np.uint8)
    for b in range(256):
        c = counts[b]
        for bucket, value in ((1, 1), (0, 4 + 8), (3, 2 + 8)):
            if c[bucket] > 2 and all(c[bucket] > c[o] for o in range(4)
                                     if o != bucket):
                begin[b] = value
    delete = (bytes([DELETE_TOKEN]) if capcode == 2 else
              bytes([NO_CAPCODE_DELETE_TOKEN]) if capcode == 1 else None)
    return {"reverse": reverse, "keys": keys,
            "id": np.array([ids[t] for t in keys], np.uint32),
            "score": np.array([score[t] for t in keys], np.float32),
            "flag": flag, "nwords": nwords, "index1": index1,
            "index2": index2, "begin_byte": begin,
            "delete_token": ids.get(delete, DOES_NOT_EXIST)}


def vocab_faults(vocab_path: str, tokens: list, specials: frozenset,
                 header: dict) -> int:
    """How far the ``.vocab`` at ``vocab_path`` is from the vocabulary
    ``expected`` of ``tokens``: one for each key of either that the other
    lacks or places elsewhere, and each id more or fewer, each key whose
    id, score, flag, word count or alternatives differ, each begin-byte class, a wrong
    delete token and each header field (``header``: capcode, charset,
    normalization) that differs."""
    v = Vocab.load(vocab_path)
    want = expected(tokens, specials, header["charset"],
                    header["using_capcode"])
    # ids are held by key below: the loader points an id a delete-marked
    # key shares at that key, so ``reverse`` is compared by length alone
    off = abs(len(v.reverse) - len(want["reverse"]))
    if v.tokens != want["keys"]:
        off += len(set(v.tokens) ^ set(want["keys"])) + sum(
            a != b for a, b in zip(v.tokens, want["keys"]))
    else:
        bad = np.zeros(len(v.tokens), bool)
        for name in ("id", "score", "flag", "nwords", "index1", "index2"):
            bad |= getattr(v, name) != want[name]
        off += int(bad.sum())
    off += int((v.begin_byte != want["begin_byte"]).sum())
    off += int(v.delete_token != want["delete_token"])
    got = {"using_capcode": v.using_capcode, "charset": v.charset,
           "norm_flag": v.normalizer.flag}
    return off + sum(got[k] != header[k] for k in got)


def count(events, data: bytes, n_ids: int):
    """(scores int64 [n_ids], tokens in text, missing byte values) of one
    strip's events."""
    scores = np.zeros(n_ids, np.int64)
    prev = np.concatenate([[0], events.pos[:-1]])
    took = (events.miss == 0) & (events.ntok >= 1)
    np.add.at(scores, events.id0[took], (events.pos - prev)[took])
    np.add.at(scores, events.id1[took & (events.ntok == 2)], 1)
    tokens = int(np.where(events.miss != 0, 1, events.ntok).sum())
    missing = {data[int(p) - 1] for p in events.pos[events.miss != 0]}
    return scores, tokens, missing


def score(reference, vocab_path: str, strips: list, greedy: bool = False):
    """(scores by id, tokens in text, missing byte values) of the
    candidate at ``vocab_path`` over ``strips`` (normalized bytes), each
    strip's loop run in ``reference``'s worker processes; ``greedy`` runs
    the control's loop instead."""
    n_ids = len(Vocab.load(vocab_path).reverse)
    strips = [s for s in strips if len(s)]
    scores = np.zeros(n_ids, np.int64)
    tokens, missing = 0, set()
    for ev, data in zip(reference.events(vocab_path, strips, greedy),
                        strips):
        s, t, m = count(ev, data, n_ids)
        scores += s
        tokens += t
        missing |= m
    return scores, tokens, missing
