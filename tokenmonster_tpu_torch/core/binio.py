"""Little-endian binary reader/writer matching the AlasdairF/Custom format.

Recovered from the C++ Reader (tokenmonster-cpp/src/tokenmonster.cpp:131-188)
and the Go call sites (go/tokenmonster.go Save/Load, trainvocab.go:412-451).
``.vocab`` files are raw; ``.tok`` files are zlib-compressed streams of the
same primitives (custom.NewZlibReader/Writer).
"""

from __future__ import annotations

import struct
import zlib


class Reader:
    __slots__ = ("data", "at")

    def __init__(self, data: bytes):
        self.data = data
        self.at = 0

    @classmethod
    def from_file(cls, path) -> "Reader":
        with open(path, "rb") as f:
            return cls(f.read())

    @classmethod
    def from_zlib_file(cls, path) -> "Reader":
        with open(path, "rb") as f:
            return cls(zlib.decompress(f.read()))

    def _require(self, n: int):
        if self.at + n > len(self.data):
            raise EOFError("truncated stream")

    def read_byte(self) -> int:
        self._require(1)
        v = self.data[self.at]
        self.at += 1
        return v

    def read_uint16(self) -> int:
        self._require(2)
        d, a = self.data, self.at
        self.at += 2
        return d[a] | (d[a + 1] << 8)

    def read_uint24(self) -> int:
        self._require(3)
        d, a = self.data, self.at
        self.at += 3
        return d[a] | (d[a + 1] << 8) | (d[a + 2] << 16)

    def read_uint32(self) -> int:
        self._require(4)
        v = struct.unpack_from("<I", self.data, self.at)[0]
        self.at += 4
        return v

    def read_uint64(self) -> int:
        self._require(8)
        v = struct.unpack_from("<Q", self.data, self.at)[0]
        self.at += 8
        return v

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


class Writer:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts = bytearray()

    def write_byte(self, v: int):
        self.parts.append(v & 0xFF)

    def write_uint16(self, v: int):
        self.parts += struct.pack("<H", v & 0xFFFF)

    def write_uint24(self, v: int):
        v &= 0xFFFFFF
        self.parts += bytes((v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF))

    def write_uint32(self, v: int):
        self.parts += struct.pack("<I", v & 0xFFFFFFFF)

    def write_uint64(self, v: int):
        self.parts += struct.pack("<Q", v)

    def write_float32(self, v: float):
        self.parts += struct.pack("<f", v)

    def write_bytes(self, b: bytes):
        self.parts += b

    def write_bytes8(self, b: bytes):
        if len(b) > 255:
            raise ValueError("bytes8 length > 255")
        self.parts.append(len(b))
        self.parts += b

    def getvalue(self) -> bytes:
        return bytes(self.parts)

    def to_file(self, path):
        with open(path, "wb") as f:
            f.write(self.parts)

    def to_zlib_file(self, path, level: int = 6):
        with open(path, "wb") as f:
            f.write(zlib.compress(bytes(self.parts), level))
