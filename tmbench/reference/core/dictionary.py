"""The sorted key set and its longest-substring search, frozen from
``tokenmonster_tpu_torch/core/dictionary.py`` at commit 6d463e6b506c.

Only the pieces that the plain reference calls, each copied whole.
``tmbench/tests/test_tmbench_frozen.py`` holds each piece to its
source at that commit; the copy stays as it is when the source
changes."""

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
