"""Streaming decoder: buffers incomplete UTF-8/16 tails and capcode state.

Port of go/tokenmonster.go:445-747 (Decoder).
"""

from __future__ import annotations

import numpy as np

from ..utils.runes import incomplete_utf8_bytes, incomplete_utf16_bytes
from . import capcode as cc
from .tokenizer import deserialize_tokens


class StreamDecoder:
    def __init__(self, vocab):
        self.vocab = vocab
        self.remainder = b""
        self.capcode_decoder = cc.Decoder()

    def flush(self) -> bytes:
        data = self.remainder
        self.remainder = b""
        return data

    def decode(self, tokens) -> bytes:
        vocab = self.vocab
        if vocab.charset == 0:
            return vocab._decode_raw(tokens)
        data = self.remainder + vocab._decode_raw(tokens)
        if vocab.charset == 1:
            cut = len(data) - incomplete_utf8_bytes(data)
        else:
            cut = len(data) - incomplete_utf16_bytes(data)
        self.remainder = data[cut:]
        data = data[:cut]
        if vocab.using_capcode == 2:
            data = self.capcode_decoder.decode(data)
        elif vocab.using_capcode == 1:
            data = self.capcode_decoder.no_capcode_decode(data)
        return data

    def decode_serialized(self, b: bytes, encoding_length: int = 0) -> bytes:
        vocab = self.vocab
        if encoding_length <= 1:
            encoding_length = 2 if len(vocab.reverse) <= 65536 else 3
        return self.decode(deserialize_tokens(b, encoding_length))

    def deserialize(self, data: bytes, encoding_length: int = 0) -> np.ndarray:
        return self.vocab.deserialize(data, encoding_length)
