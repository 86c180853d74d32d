"""A vocabulary file's loader and its normalize-and-capcode, frozen from
``tokenmonster_tpu_torch/core/vocab.py`` at commit 6d463e6b506c.

Only the pieces that the plain reference calls, each copied whole.
``tmbench/tests/test_tmbench_frozen.py`` holds each piece to its
source at that commit; the copy stays as it is when the source
changes."""

from __future__ import annotations

import numpy as np

from . import capcode as cc
from .binio import Reader
from .dictionary import Dictionary
from .normalize import Normalizer
from .tokenmeta import DOES_NOT_EXIST


MAX_TOKEN_LEN = 40


def apply_capcode(data: bytes, using_capcode: int) -> bytes:
    if using_capcode == 2:
        return cc.encode(data)
    if using_capcode == 1:
        return cc.no_capcode_encode(data)
    return data


def normalize_and_capcode(data: bytes, using_capcode: int,
                          normalizer: Normalizer) -> bytes:
    """go/tokenmonster.go:242-253."""
    return apply_capcode(normalizer.normalize(data), using_capcode)


class Vocab:
    """A TokenMonster-compatible vocabulary with TPU-friendly array storage."""

    def __init__(self):
        self.dictionary = Dictionary()
        self.tokens: list[bytes] = []          # dictionary order
        self.flag = np.zeros(0, np.uint8)
        self.nwords = np.zeros(0, np.uint8)
        self.index1 = np.zeros(0, np.uint32)
        self.index2 = np.zeros(0, np.uint32)
        self.len1 = np.zeros(0, np.int32)
        self.len2 = np.zeros(0, np.int32)
        self.id = np.zeros(0, np.uint32)
        self.id1 = np.zeros(0, np.uint32)
        self.id2 = np.zeros(0, np.uint32)
        self.score = np.zeros(0, np.float32)
        self.reverse: list[bytes | None] = []
        self.deleted: list[tuple[bytes, int, float]] = []
        self.begin_byte = np.zeros(256, np.uint8)
        self.vocab_size = 0
        self.max_token_length = 0
        self.delete_token = DOES_NOT_EXIST
        self.unk_token = DOES_NOT_EXIST
        self.using_capcode = 0
        self.charset = 0
        self.level = 0
        self.reserve = 0
        self.normalizer = Normalizer(0)

    def normalize(self, data: bytes) -> bytes:
        return normalize_and_capcode(data, self.using_capcode, self.normalizer)

    @classmethod
    def load(cls, path) -> "Vocab":
        r = Reader.from_file(path)
        return cls._load_reader(r)

    @classmethod
    def _load_reader(cls, r: Reader) -> "Vocab":
        v = cls()
        v.using_capcode = r.read_byte()
        v.charset = r.read_byte()
        v.normalizer = Normalizer(r.read_byte())
        v.level = r.read_byte()
        v.reserve = r.read_byte()
        r.read_byte(); r.read_byte(); r.read_byte()
        if v.charset > 2 or v.using_capcode > 2:
            raise ValueError("Not a valid TokenMonster vocabulary.")
        v.unk_token = r.read_uint24()
        v.vocab_size = r.read_uint24()
        n_reverse = r.read_uint24()
        n_info = r.read_uint24()
        v.delete_token = r.read_uint24()
        v.max_token_length = r.read_byte()

        v.tokens = []
        v.flag = np.zeros(n_info, np.uint8)
        v.nwords = np.zeros(n_info, np.uint8)
        v.index1 = np.zeros(n_info, np.uint32)
        v.index2 = np.zeros(n_info, np.uint32)
        v.len1 = np.zeros(n_info, np.int32)
        v.len2 = np.zeros(n_info, np.int32)
        v.id = np.zeros(n_info, np.uint32)
        v.id1 = np.zeros(n_info, np.uint32)
        v.id2 = np.zeros(n_info, np.uint32)
        v.score = np.zeros(n_info, np.float32)
        v.reverse = [None] * n_reverse

        for i in range(n_info):
            key = r.read_bytes8()
            if len(key) > MAX_TOKEN_LEN:
                raise ValueError("Not a valid TokenMonster vocabulary.")
            v.tokens.append(key)
            v.dictionary.add(key)
            v.flag[i] = r.read_byte()
            v.nwords[i] = r.read_byte()
            idx1 = r.read_uint24()
            v.index1[i] = idx1
            if idx1 != DOES_NOT_EXIST:
                v.len1[i] = len(v.tokens[idx1])
                v.id1[i] = v.id[idx1]
            idx2 = r.read_uint24()
            v.index2[i] = idx2
            if idx2 != DOES_NOT_EXIST:
                v.len2[i] = len(v.tokens[idx2])
                v.id2[i] = v.id[idx2]
            v.id[i] = r.read_uint24()
            v.score[i] = r.read_float32()
            v.reverse[v.id[i]] = key
        for i in range(256):
            v.begin_byte[i] = r.read_byte()
        n_deleted = r.read_uint24()
        for _ in range(n_deleted):
            tok = r.read_bytes8()
            did = r.read_uint24()
            dscore = r.read_float32()
            v.deleted.append((tok, did, dscore))
        if not r.eof():
            raise ValueError("Not a valid TokenMonster vocabulary.")
        v.dictionary.build()
        # The file is written in dictionary order; verify (cpp :1352-1357).
        for i, t in enumerate(v.tokens):
            if v.dictionary.index[t] != i:
                raise ValueError("Vocabulary file is not in canonical order.")
        return v
