"""The reader of a vocabulary file's binary fields, frozen from
``tokenmonster_tpu_torch/core/binio.py`` at commit 6d463e6b506c.

Only the pieces that the plain reference calls, each copied whole.
``tmbench/tests/test_tmbench_frozen.py`` holds each piece to its
source at that commit; the copy stays as it is when the source
changes."""

from __future__ import annotations

import struct


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.at = 0

    @classmethod
    def from_file(cls, path) -> "Reader":
        with open(path, "rb") as f:
            return cls(f.read())

    def _require(self, n: int):
        if self.at + n > len(self.data):
            raise EOFError("truncated stream")

    def read_byte(self) -> int:
        self._require(1)
        v = self.data[self.at]
        self.at += 1
        return v

    def read_uint24(self) -> int:
        self._require(3)
        d, a = self.data, self.at
        self.at += 3
        return d[a] | (d[a + 1] << 8) | (d[a + 2] << 16)

    def read_float32(self) -> float:
        self._require(4)
        v = struct.unpack_from("<f", self.data, self.at)[0]
        self.at += 4
        return v

    def read_bytes(self, n: int) -> bytes:
        self._require(n)
        v = self.data[self.at:self.at + n]
        self.at += n
        return v

    def read_bytes8(self) -> bytes:
        return self.read_bytes(self.read_byte())

    def eof(self) -> bool:
        return self.at == len(self.data)
