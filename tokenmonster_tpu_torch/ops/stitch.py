"""Junction sync search and dense compaction of the lane record streams.

Port of ``tokenmonster_tpu/ops/stitch.py::stitched_keep`` and
``ops/pallas_stitch.py::device_stitch_compact`` as PyTorch ops (they were
XLA in the JAX package), and of ``ops/pallas_stitch.py::
make_compact_kernel``: the kernel is ``compact_kernel`` in
``csrc/tm_kernels.cu`` (per-thread body ``tmk::compact_at``), the plain
version ``compact_plain``.

The automaton state at every emission is (position, forwardDelete), so a
state shared by neighbouring lanes is an exact splice point
(go/tokenmonster.go:1048-1277).  Dispatches chain through one bridge lane:
the last lane of a dispatch is re-scanned as the next one's lane 0, and the
number of its records to skip (``start_next``) flows on as a device tensor.
"""

from __future__ import annotations

import torch

from . import _build

SYNC_PROBE = 16   # first records of the right lane probed for a shared state
_REC_FD, _REC_TOK, _REC_DEL, _REC_MISS = 1, 2, 4, 8


def stitched_keep(recs: torch.Tensor, start0, last_lane: int, final: bool):
    """Junction sync search and keep ranges over a (T, L) record grid.

    ``start0``: records to skip at the head of lane 0 (int or 0-dim
    tensor); ``last_lane``: last owned lane; ``final``: the last dispatch of
    a text, whose last owned lane keeps its whole tail.  Returns (flags,
    keep, start_next, sync_ok, start_rec, end_rec), end_rec -1 for lanes
    past ``last_lane``."""
    T, L = recs.shape
    dev = recs.device
    r = recs.long()
    flags = r & 0xF
    valid = flags != 0
    state = ((r >> 4) << 1) | (r & _REC_FD)
    n_valid = valid.sum(dim=0)
    lane_ids = torch.arange(L, device=dev)
    start0 = torch.as_tensor(start0, dtype=torch.int64, device=dev).reshape(1)
    if L > 1:
        k = min(SYNC_PROBE, T)
        sa, va = state[:, :-1], valid[:, :-1]
        sb, vb = state[:k, 1:], valid[:k, 1:]
        hit = ((sa[:, None, :] == sb[None, :, :])
               & va[:, None, :] & vb[None, :, :])            # (T, K, L-1)
        hit_k = hit.any(dim=0)                               # (K, L-1)
        sync_exists = hit_k.any(dim=0)
        kstar = hit_k.to(torch.int8).argmax(dim=0)           # first k hit
        hit_at_k = hit.gather(1, kstar[None, None, :].expand(T, 1, L - 1))
        tstar = hit_at_k[:, 0, :].to(torch.int8).argmax(dim=0)
        end_rec = torch.cat([tstar, torch.zeros(1, dtype=torch.int64,
                                                device=dev)])
        start_rec = torch.cat([start0, kstar + 1])
        need = lane_ids[:-1] < (last_lane if final else last_lane + 1)
        sync_ok = (sync_exists | ~need).all()
        start_next = kstar[L - 2] + 1
    else:
        end_rec = torch.zeros(1, dtype=torch.int64, device=dev)
        start_rec = start0
        sync_ok = torch.ones((), dtype=torch.bool, device=dev)
        start_next = torch.zeros((), dtype=torch.int64, device=dev)
    if final:
        end_rec = torch.where(lane_ids == last_lane, n_valid - 1, end_rec)
    t_idx = torch.arange(T, device=dev)[:, None]
    keep = (valid & (t_idx >= start_rec[None, :]) & (t_idx <= end_rec[None, :])
            & (lane_ids[None, :] <= last_lane))
    end_m = torch.where(lane_ids <= last_lane, end_rec, -1)
    return flags, keep, start_next, sync_ok, start_rec, end_m


def compact_plain(recs: torch.Tensor, toks: torch.Tensor, s: torch.Tensor,
                  e: torch.Tensor, q: torch.Tensor, out_len: int):
    """PyTorch version of the compact kernel: out[q_l + j] = toks[j, l] |
    DEL_BIT if record (j, l) emits a delete, for j in [s_l, min(e_l, T-1)];
    zero elsewhere.  int32 [out_len]."""
    T, L = recs.shape
    dev = recs.device
    j = torch.arange(T, device=dev)[:, None]
    slot = q.long()[None, :] + j
    keep = ((j >= s.long()[None, :]) & (j <= e.long()[None, :])
            & (slot >= 0) & (slot < out_len))
    words = toks.long() | (((recs.long() >> 2) & 1) << 22)
    out = torch.zeros(out_len, dtype=torch.int64, device=dev)
    out[slot.T[keep.T]] = words.T[keep.T]
    return out.to(torch.int32)


def compact(recs: torch.Tensor, toks: torch.Tensor, s: torch.Tensor,
            e: torch.Tensor, q: torch.Tensor, out_len: int):
    """Dense token words of the kept records: the CUDA kernel for CUDA
    tensors, the plain version for CPU ones.  ``recs``/``toks``: int32
    (T, L); ``s``/``e``/``q``: per-lane first and last kept record and the
    output slot of record 0."""
    T, L = recs.shape
    if recs.device.type == "cpu":
        return compact_plain(recs, toks, s, e, q, out_len)
    dev = recs.device
    _build.check(recs, "recs", torch.int32, dev)
    _build.check(toks, "toks", torch.int32, dev, (T, L))
    for name, v in (("s", s), ("e", e), ("q", q)):
        _build.check(v, name, torch.int32, dev, (L,))
    out = torch.zeros(out_len, dtype=torch.int32, device=dev)
    args = _build.CompactArgs(
        recs=recs.data_ptr(), toks=toks.data_ptr(), s=s.data_ptr(),
        e=e.data_ptr(), q=q.data_ptr(), out=out.data_ptr(), out_len=out_len,
        T=T, L=L)
    _build.launch("compact", args, dev)
    return out


def device_stitch_compact(recs: torch.Tensor, toks: torch.Tensor, start0,
                          last_lane: int, final: bool, out_cap: int):
    """Stitch and compact one dispatch, on its device with no host sync.
    Returns (out int32 [out_cap], count, missing, start_next, sync_ok,
    junction_ok) as 0-dim tensors.  junction_ok is False when an owned
    junction found no shared state; sync_ok is False then too, and when a
    kept record emits nothing (a missing byte in a vocabulary without an
    unk token)."""
    T, L = recs.shape
    flags, keep, start_next, sync_ok, start_rec, end_rec = stitched_keep(
        recs, start0, last_lane, final)
    emits = (flags & (_REC_TOK | _REC_DEL)) != 0
    fast_ok = ~(keep & ~emits).any()
    counts = keep.sum(dim=0)
    missing = (((flags & _REC_MISS) != 0) & keep).sum()
    ends = counts.cumsum(0)
    offs = ends - counts
    q = offs - start_rec
    out = compact(recs, toks, start_rec.to(torch.int32),
                  end_rec.clamp(max=T - 1).to(torch.int32),
                  q.to(torch.int32), out_cap)
    return out, ends[-1], missing, start_next, sync_ok & fast_ok, sync_ok
