"""Host-side longest-prefix dictionary with pansearch-compatible index order.

The reference's ``pansearch.Fast`` assigns indices in ascending (length,
lexicographic) order: keys are bucketed by exact byte length 1..40 and each
bucket is sorted by its big-endian packed value (tokenmonster-cpp/src/
tokenmonster.cpp:607-697).  The ``.vocab`` file format depends on this order
(alt indices always reference earlier records; go/tokenmonster.go:2636).

This host implementation keeps the exact ordering contract but uses a plain
hash map + per-first-byte length masks for lookup.  The TPU path uses the
reversed-key match automaton built in ops/automaton.py instead.
"""

from __future__ import annotations

import numpy as np

MAX_KEY_LEN = 40


def sort_key(token: bytes):
    return (len(token), token)


class Dictionary:
    """Sorted key set with ``find`` and ``longest_substring``."""

    __slots__ = ("keys", "index", "max_len", "_len_masks", "_built")

    def __init__(self):
        self.keys: list[bytes] = []
        self.index: dict[bytes, int] = {}
        self.max_len = 0
        # per first byte, a bitmask of key lengths present (bit L => length L)
        self._len_masks = np.zeros(256, dtype=np.uint64)
        self._built = False

    def add(self, key: bytes):
        if self._built:
            raise RuntimeError("Dictionary already built")
        if not (0 < len(key) <= MAX_KEY_LEN):
            raise ValueError(f"key length {len(key)} out of range 1..40")
        if key not in self.index:
            self.index[key] = -1
            self.keys.append(bytes(key))

    def build(self):
        self.keys.sort(key=sort_key)
        for i, k in enumerate(self.keys):
            self.index[k] = i
            self._len_masks[k[0]] |= np.uint64(1 << len(k))
            if len(k) > self.max_len:
                self.max_len = len(k)
        self._built = True

    def __len__(self):
        return len(self.keys)

    def longest_length(self) -> int:
        return self.max_len

    def find(self, key: bytes):
        idx = self.index.get(bytes(key), -1)
        if idx < 0:
            return 0, False
        return idx, True

    def __contains__(self, key: bytes) -> bool:
        return bytes(key) in self.index

    def longest_substring(self, data, start: int = 0, limit: int | None = None):
        """Longest key that is a prefix of data[start:start+limit].

        Returns (index, length, found) like pansearch.Fast.LongestSubstring.
        """
        n = len(data)
        maxl = n - start
        if limit is not None and limit < maxl:
            maxl = limit
        if maxl <= 0:
            return 0, 0, False
        if maxl > self.max_len:
            maxl = self.max_len
        if maxl <= 0:
            return 0, 0, False
        mask = int(self._len_masks[data[start]])
        mask &= (1 << (maxl + 1)) - 1
        get = self.index.get
        while mask:
            ln = mask.bit_length() - 1  # longest candidate length remaining
            idx = get(bytes(data[start:start + ln]), -1)
            if idx >= 0:
                return idx, ln, True
            mask &= (1 << ln) - 1
        return 0, 0, False
