"""The finishing of a tokenized text on its device, and the host side of
its download.

Port of ``tokenmonster_tpu/ops/scan.py::TpuTokenizer._meta_concat_fns``
and of the expansion in its ``tokenize_staged``.  On the device, with no
host sync (so it is captured with the dispatch chain, ``ops/scan.py``):
each dispatch's scalars (kept-record count, missing count, sync, junction
and done flags) go into one int32 array, read by the host in one copy;
each dispatch's compacted token words land at the running offset of the
counts before it; each word is resolved to the id it emits
(``decide.resolve_words``) and narrowed to the fewest bytes that hold
every id of the vocabulary: two (``int16`` holding the u16 id) where it
has at most 65,536 ids, else three (24-bit little-endian bytes).  The
delete-follows markers (bit S + 2 of a word) travel as a bitmask, eight
words a byte, and the host inserts the delete token after each marked
id (``host_ids``), as the JAX package does with ``np.insert``.
"""

from __future__ import annotations

import numpy as np
import torch

from .decide import resolve_words
from .tables import del_bit

# rows of ``meta``: per dispatch, the kept words it compacted, its missing
# bytes, whether it synced (every kept record emits), whether every owned
# junction found a shared state, whether every lane finished its window
META_ROWS = ("count", "missing", "sync", "junction", "done")
NARROW_IDS = 65536    # id spaces up to this size download as u16


def meta(outs) -> torch.Tensor:
    """The (5, k) int32 scalars (``META_ROWS``) of k dispatches' outputs
    (out, count, missing, sync_ok, junction_ok, done), on their device."""
    return torch.stack([torch.stack([o[1], o[2], o[3].long(), o[4].long(),
                                     o[5].long()]) for o in outs],
                       1).to(torch.int32)


def concat(words: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``words`` (k, cap) int32, dispatch i's first ``counts[i]`` valid,
    as one int32 [k * cap] array: dispatch i's words at the running offset
    of the counts before it, zero from the total on.  A gather over the
    output, so the offsets stay on the device."""
    k, cap = words.shape
    ends = counts.long().cumsum(0)
    x = torch.arange(k * cap, device=words.device)
    d = torch.searchsorted(ends, x, right=True).clamp(max=k - 1)
    src = (d * cap + x - (ends - counts.long())[d]).clamp(0, k * cap - 1)
    return torch.where(x < ends[-1], words.reshape(-1)[src], 0)


def narrow(ids: torch.Tensor, wide: bool) -> torch.Tensor:
    """int64 ids in their download form: int16 holding the u16 id, or
    (``wide``: more than ``NARROW_IDS`` ids) three little-endian bytes
    an id, uint8 [3 * len]."""
    if not wide:
        return (((ids + 32768) & 0xFFFF) - 32768).to(torch.int16)
    return torch.stack([ids & 0xFF, (ids >> 8) & 0xFF, (ids >> 16) & 0xFF],
                       1).reshape(-1).to(torch.uint8)


def delete_bits(words: torch.Tensor, w3_shift: int) -> torch.Tensor:
    """The delete markers of int32 words (length a multiple of 8), eight a
    byte, least significant bit first: uint8 [len / 8]."""
    bits = ((words.long() & del_bit(w3_shift)) != 0).reshape(-1, 8).long()
    weights = 1 << torch.arange(8, device=words.device)
    return (bits * weights).sum(1).to(torch.uint8)


def finish(outs, tabs, wide: bool):
    """The device finishing of k dispatches' outputs on ``tabs``: (meta
    (5, k) int32, narrowed ids of the concatenated words, their delete
    bitmask or None without a delete token).  Entries past the total are
    padding: the host reads as many as the counts say."""
    m = meta(outs)
    words = concat(torch.stack([o[0] for o in outs]), m[0])
    ids = narrow(resolve_words(words, tabs), wide)
    bits = delete_bits(words, tabs.w3_shift) if tabs.has_delete else None
    return m, ids, bits


def host_ids(ids: np.ndarray, bits: np.ndarray | None, total: int,
             delete_token: int) -> np.ndarray:
    """u32 ids from a download of ``total`` narrowed ids (``narrow``'s
    form) and their delete bitmask: the delete token inserted after each
    marked id."""
    if ids.dtype == np.int16:
        out = ids[:total].view(np.uint16).astype(np.uint32)
    else:
        p = ids[:3 * total].reshape(-1, 3).astype(np.uint32)
        out = p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16)
    if bits is None:
        return out
    marked = np.nonzero(np.unpackbits(bits, bitorder="little")[:total])[0]
    if marked.size == 0:
        return out
    return np.insert(out, marked + 1, np.uint32(delete_token & 0xFFFFFF))
