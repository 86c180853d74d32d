"""FNV-1a 64 over a u32 id stream, frozen from ``chip_smoke.py`` at commit
6d463e6b506c (``fnv1a64``, copied whole)."""

import numpy as np


def fnv1a64(ids) -> int:
    """FNV-1a over the little-endian u32 id stream."""
    h = 0xCBF29CE484222325
    for b in np.asarray(ids, np.uint32).astype("<u4").tobytes():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h
