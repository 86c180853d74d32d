"""Device-assisted bounded suffix sort for getalltokens.

Port of ``tokenmonster_tpu/ops/device_sort.py`` (XLA there, no Pallas
kernel) as PyTorch ops.  The counting engine orders every position of a
micro-chunk by its ``width``-byte window (train/getalltokens.py::
SortedWindows); equal prefixes of any length are then contiguous, and the
first differing byte between neighbours in that order gives each length's
runs.  Each window is packed into big-endian 32-bit words, so unsigned
word order is byte order, and the words are sorted least significant
first (LSD) by stable single-key sorts that carry the permutation:
stability is what makes the passes compose into lexicographic order.
``torch.sort(stable=True)`` is the counterpart of the JAX package's
``jax.lax.sort(is_stable=True)``; on a CUDA card it is a radix sort.

Keys are int32 with the sign bit flipped (``word - 2^31``), so signed
order is the words' unsigned order, and the XOR of two keys is the XOR of
their words.  The windows and their padding are the JAX function's, so
the same stable passes give the same order: ties (windows equal over all
their words) keep position order.  Against the host sort
(``native_sorted_windows``) ties may order differently, but the counting
walk reads only run structure (``first_diff >= length`` is "same run"),
so counts and the ``.tok`` file are identical.

Memory, at getalltokens' default 100 MB chunk in 5 micro-chunks: about 20
M positions, ``width`` 41 gives 11 words of 4 B each, 0.9 GB of keys, plus
per pass the int64 order and permutation (0.3 GB) and ``torch.sort``'s
sorted copy and its own temporaries: about 1.5 GB on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .scan import check_device


def _words(pad: torch.Tensor, n: int, w32: int) -> torch.Tensor:
    """(w32, n) int32 keys: word j of position p is the big-endian u32 of
    bytes p+4j .. p+4j+3, less 2^31."""
    p = pad.to(torch.int64)
    keys = torch.empty((w32, n), dtype=torch.int32, device=pad.device)
    for j in range(w32):
        w = ((p[4 * j:4 * j + n] << 24) | (p[4 * j + 1:4 * j + 1 + n] << 16)
             | (p[4 * j + 2:4 * j + 2 + n] << 8) | p[4 * j + 3:4 * j + 3 + n])
        keys[j] = (w - (1 << 31)).to(torch.int32)
    return keys


def _first_diff(keys: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """uint8 [n-1]: the first byte at which window ``order[k+1]`` differs
    from window ``order[k]``, as ``min(4 * word + byte in word, 255)``;
    windows equal over every word give ``4 * w32 + 3``."""
    w32, n = keys.shape
    fw = torch.full((n - 1,), w32, dtype=torch.int32, device=keys.device)
    xw = torch.zeros(n - 1, dtype=torch.int32, device=keys.device)
    for j in range(w32 - 1, -1, -1):
        sw = keys[j].index_select(0, order)
        x = sw[1:] ^ sw[:-1]
        neq = x != 0
        fw = torch.where(neq, j, fw)
        xw = torch.where(neq, x, xw)
    inword = torch.where(
        (xw >> 24) & 0xFF != 0, 0,
        torch.where((xw >> 16) & 0xFF != 0, 1,
                    torch.where((xw >> 8) & 0xFF != 0, 2, 3)))
    return torch.clamp(4 * fw + inword, max=255).to(torch.uint8)


def device_sorted_windows(data: np.ndarray, n: int, width: int,
                          device="cuda"):
    """(order uint32[n], first_diff uint8[n-1]), as ``native_sorted_windows``
    returns them, sorted on ``device`` ("cuda": the default card; "cpu"
    runs the same torch ops on the host).  ``data``: uint8 with the bytes
    of positions 0..n-1 and their windows.  Raises where the device cannot
    sort: no host fallback."""
    device = check_device(device)
    if n < 1:
        raise ValueError(f"no window to sort (n={n})")
    w32 = -(-width // 4)
    pad = np.zeros(n + 4 * w32 + 4, np.uint8)
    m = min(len(data), n + width)
    pad[:m] = data[:m]
    keys = _words(torch.from_numpy(pad).to(device), n, w32)
    order = torch.arange(n, dtype=torch.int64, device=device)
    for j in range(w32 - 1, -1, -1):
        key = keys[j] if j == w32 - 1 else keys[j].index_select(0, order)
        _sorted, perm = torch.sort(key, stable=True)
        order = order.index_select(0, perm)
    first_diff = (_first_diff(keys, order) if n > 1
                  else torch.zeros(0, dtype=torch.uint8, device=device))
    order = order.to(torch.int32).cpu().numpy().view(np.uint32)
    return order, first_diff.cpu().numpy()
