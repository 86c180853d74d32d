"""Junction sync search over the lane record streams, then their dense
compaction (tokenizer) or chars-covered scores (trainer).

Port of ``tokenmonster_tpu/ops/stitch.py::stitched_keep`` and
``device_stitch_score`` (the trainer's epilogue) and of
``ops/pallas_stitch.py::device_stitch_compact`` as PyTorch ops (they were
XLA in the JAX package), and of ``ops/pallas_stitch.py::
make_compact_kernel``: the kernel is ``compact_kernel`` in
``csrc/tm_kernels.cu`` (per-thread code ``tmk::compact_word``,
``compact_put``, ``compact_mark``, ``compact_zero4``), the plain
version ``compact_plain``.

The automaton state at every emission is (position, forwardDelete), so a
state shared by neighbouring lanes is an exact splice point
(go/tokenmonster.go:1048-1277).  Dispatches chain through one bridge lane:
the last lane of a dispatch is re-scanned as the next one's lane 0, and the
number of its records to skip (``start_next``) flows on as a device tensor.
Where a junction's splice does not hold, ``restart_point`` says where a
lane of the text's own chain can take over (the trainer's repair,
``parallel/score.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .tables import W3_SHIFT, check_w3_shift, del_bit

_REC_FD, _REC_TOK, _REC_DEL, _REC_MISS = 1, 2, 4, 8
_NO_STATE = 1 << 62   # above every (position, fd) state


def _junctions(recs: torch.Tensor, start0, last_lane, final):
    """The splice of every junction j (lanes j and j+1) of a (T, L) record
    grid: (kstar, tstar, holds), each (L-1,).  The right lane's first
    record whose state the left lane also reached is its record kstar and
    the left lane's record tstar.  ``holds`` is True where the splice holds
    or the junction is not owned.  ``last_lane`` and ``final`` as
    ``stitched_keep`` takes them."""
    T, L = recs.shape
    dev = recs.device
    r = recs.long()
    valid = (r & 0xF) != 0
    # (position, fd) with fd 1 ordered first: the one step that keeps its
    # position goes from fd 1 to fd 0, so a lane's states still rise
    state = ((r >> 4) << 1) | (~r & _REC_FD)
    # a lane's states rise strictly and its valid records come first, so
    # each left lane is a sorted row to binary-search
    left = torch.where(valid[:, :-1], state[:, :-1], _NO_STATE).T
    right = state[:, 1:].T.contiguous()                      # (L-1, T)
    at = torch.searchsorted(left.contiguous(), right).clamp(max=T - 1)
    hit = (left.gather(1, at) == right) & valid[:, 1:].T
    sync_exists = hit.any(dim=1)
    kstar = hit.to(torch.int8).argmax(dim=1)                 # first hit
    tstar = torch.where(sync_exists, at.gather(1, kstar[:, None])[:, 0], 0)
    # owned junctions: up to the last owned lane's, which a final
    # dispatch does not own (its last lane keeps its whole tail)
    need = torch.arange(L - 1, device=dev) < last_lane + 1 - final
    # a splice holds only where the left lane already follows the text's
    # chain, at or after its own splice record; with chunks longer than
    # the overlap plus a token that always holds
    joined = torch.cat([start0 - 1, kstar[:-1]])
    holds = (sync_exists & (tstar >= joined)) | ~need
    return kstar, tstar, holds


def stitched_keep(recs: torch.Tensor, start0, last_lane, final):
    """Junction sync search and keep ranges over a (T, L) record grid.

    At each junction the right lane's first record whose state the left
    lane also reached is the splice: the right lane keeps the records after
    it, the left lane those up to its own record of that state.  Every
    record of the right lane is searched, so the splice is found wherever
    it lies within the left lane's overlap (the JAX package probes only
    the right lane's first 16 records, a bound of its TPU layout).

    ``start0``: records to skip at the head of lane 0; ``last_lane``: last
    owned lane; ``final``: 1 for the last dispatch of a text, whose last
    owned lane keeps its whole tail, else 0.  Each an int or a 0-dim
    integer tensor on the grid's device (a dispatch's device scalars, read
    by tensor arithmetic only, so the work is the same for every text).
    Returns (flags, keep, start_next, sync_ok, start_rec, end_rec), end_rec
    -1 for lanes past ``last_lane``."""
    T, L = recs.shape
    dev = recs.device
    flags = recs.long() & 0xF
    valid = flags != 0
    n_valid = valid.sum(dim=0)
    lane_ids = torch.arange(L, device=dev)
    start0 = torch.as_tensor(start0, dtype=torch.int64, device=dev).reshape(1)
    if L > 1:
        kstar, tstar, holds = _junctions(recs, start0, last_lane, final)
        end_rec = torch.cat([tstar, torch.zeros(1, dtype=torch.int64,
                                                device=dev)])
        start_rec = torch.cat([start0, kstar + 1])
        sync_ok = holds.all()
        start_next = kstar[L - 2] + 1
    else:
        end_rec = torch.zeros(1, dtype=torch.int64, device=dev)
        start_rec = start0
        sync_ok = torch.ones((), dtype=torch.bool, device=dev)
        start_next = torch.zeros((), dtype=torch.int64, device=dev)
    end_rec = torch.where((lane_ids == last_lane) & (final != 0),
                          n_valid - 1, end_rec)
    t_idx = torch.arange(T, device=dev)[:, None]
    keep = (valid & (t_idx >= start_rec[None, :]) & (t_idx <= end_rec[None, :])
            & (lane_ids[None, :] <= last_lane))
    end_m = torch.where(lane_ids <= last_lane, end_rec, -1)
    return flags, keep, start_next, sync_ok, start_rec, end_m


def restart_point(recs: torch.Tensor, start0, last_lane: int, final: int):
    """Where the text's chain can be followed on at the first owned
    junction j (lanes j and j+1) of a (T, L) record grid whose splice does
    not hold: (g, at, j), lane g the last lane up to j that holds a record
    with fd 0, other than its last record, at or after its splice with
    lane g-1, and ``at`` the position of its last such record.  Every lane
    up to j follows the chain from its splice, so a lane started at ``at``
    with fd 0 follows the chain from there (the state is the whole
    automaton state), and its first record is lane g's next one.  A lane
    shorter than the overlap it scans past its chunk may join the chain
    only at its last record; then an earlier lane holds the restart.  None
    when every splice holds.  Reads back to the host."""
    T, L = recs.shape
    if L < 2:
        return None
    start0 = torch.as_tensor(start0, dtype=torch.int64,
                             device=recs.device).reshape(1)
    kstar, _tstar, holds = _junctions(recs, start0, last_lane, final)
    bad = torch.nonzero(~holds)
    if bad.numel() == 0:
        return None
    bad_g = int(bad[0, 0])
    cols = recs[:, :bad_g + 1].long().cpu().numpy()
    joined = np.concatenate([[int(start0[0]) - 1],
                             kstar[:bad_g].cpu().numpy()])
    t = np.arange(T)
    for g in range(bad_g, -1, -1):
        col = cols[:, g]
        ok = (((col & 0xF) != 0) & ((col & _REC_FD) == 0)
              & (t >= joined[g]) & (t < int(((col & 0xF) != 0).sum()) - 1))
        if ok.any():
            return g, int(col[t[ok][-1]] >> 4), bad_g
    raise RuntimeError(f"lanes 0-{bad_g} hold no record with fd 0 past their "
                       "splices to restart the chain from: a fault of the "
                       "follow kernel")


def compact_plain(recs: torch.Tensor, toks: torch.Tensor, s: torch.Tensor,
                  e: torch.Tensor, q: torch.Tensor, out_len: int,
                  w3_shift: int = W3_SHIFT):
    """PyTorch version of the compact kernel: out[q_l + j] = toks[j, l] |
    ``del_bit(w3_shift)`` if record (j, l) emits a delete, for j in [s_l,
    min(e_l, T-1)]; zero elsewhere.  int32 [out_len]."""
    T, L = recs.shape
    dev = recs.device
    j = torch.arange(T, device=dev)[:, None]
    slot = q.long()[None, :] + j
    keep = ((j >= s.long()[None, :]) & (j <= e.long()[None, :])
            & (slot >= 0) & (slot < out_len))
    words = toks.long() | (((recs.long() >> 2) & 1) * del_bit(w3_shift))
    out = torch.zeros(out_len, dtype=torch.int64, device=dev)
    out[slot.T[keep.T]] = words.T[keep.T]
    return out.to(torch.int32)


def compact(recs: torch.Tensor, toks: torch.Tensor, s: torch.Tensor,
            e: torch.Tensor, q: torch.Tensor, out_len: int,
            w3_shift: int = W3_SHIFT):
    """Dense token words of the kept records: the CUDA kernel for CUDA
    tensors, the plain version for CPU ones.  ``recs``/``toks``: int32
    (T, L); ``s``/``e``/``q``: per-lane first and last kept record and the
    output slot of record 0; ``w3_shift``: the tables' S, which puts the
    delete marker above the token words' w3 bits.  The kernel writes
    every word of the output, the zeros too."""
    T, L = recs.shape
    check_w3_shift(w3_shift)
    if recs.device.type == "cpu":
        return compact_plain(recs, toks, s, e, q, out_len, w3_shift)
    dev = recs.device
    _build.check(recs, "recs", torch.int32, dev)
    _build.check(toks, "toks", torch.int32, dev, (T, L))
    for name, v in (("s", s), ("e", e), ("q", q)):
        _build.check(v, name, torch.int32, dev, (L,))
    out = torch.empty(out_len, dtype=torch.int32, device=dev)
    args = _build.CompactArgs(
        recs=recs.data_ptr(), toks=toks.data_ptr(), s=s.data_ptr(),
        e=e.data_ptr(), q=q.data_ptr(), out=out.data_ptr(), out_len=out_len,
        T=T, L=L, w3_shift=w3_shift)
    _build.launch("compact", args, dev)
    return out


def device_stitch_compact(recs: torch.Tensor, toks: torch.Tensor, start0,
                          last_lane, final, out_cap: int,
                          w3_shift: int = W3_SHIFT):
    """Stitch and compact one dispatch, on its device with no host sync;
    ``start0``, ``last_lane`` and ``final`` as ``stitched_keep`` takes
    them.  Returns (out int32 [out_cap], count, missing, start_next,
    sync_ok, junction_ok) as 0-dim tensors.  junction_ok is False when an
    owned junction found no shared state; sync_ok is False then too, and
    when a kept record emits nothing (a missing byte in a vocabulary
    without an unk token)."""
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
                  q.to(torch.int32), out_cap, w3_shift)
    return out, ends[-1], missing, start_next, sync_ok & fast_ok, sync_ok


def device_stitch_score(recs: torch.Tensor, emit: torch.Tensor,
                        text: torch.Tensor, start0, last_lane, final,
                        n_ids: int, chunk: int, delete_token: int = 0):
    """Trainer epilogue of one dispatch: chars-covered scores over the
    spliced record stream, on its device with no host sync.  Port of
    ``tokenmonster_tpu/ops/stitch.py::device_stitch_score`` (XLA there),
    term by term: a kept record's token id gains the bytes it advanced
    (a within-lane diff: the skipped sync record shares its state with the
    left lane's splice record), the delete id gains 1 per delete emission,
    a missing byte counts as one token and marks the byte before the
    advance.

    ``emit``: int32 (T, L) candidate id of each record; ``text``: the
    dispatch buffer the record positions index.  Returns (scores int64
    [n_ids], n_tokens, miss_mask int64 [256], start_next, sync_ok); ids
    outside [0, n_ids) are dropped, as scatters in JAX drop them."""
    flags, keep, start_next, sync_ok, _s, _e = stitched_keep(
        recs, start0, last_lane, final)
    T, L = recs.shape
    dev = recs.device
    pos = recs.long() >> 4
    starts = torch.arange(L, device=dev) * chunk
    prev = torch.cat([starts[None, :], pos[:-1]], dim=0)
    covered = pos - prev

    miss = ((flags & _REC_MISS) != 0) & keep
    has_tok = ((flags & _REC_TOK) != 0) & keep & ~miss
    has_del = ((flags & _REC_DEL) != 0) & keep
    n_del = has_del.sum()
    n_tokens = has_tok.sum() + n_del + miss.sum()

    ids = emit.long() & 0xFFFFFFFF
    ids = torch.where(has_tok & (ids < n_ids), ids, n_ids).reshape(-1)
    scores = torch.zeros(n_ids + 1, dtype=torch.int64, device=dev)
    scores.index_add_(0, ids, torch.where(has_tok, covered, 0).reshape(-1))
    if 0 <= delete_token < n_ids:
        scores[delete_token] += n_del
    mb_pos = prev.clamp(0, text.numel() - 1)
    mb = torch.where(miss, text[mb_pos].long(), 256).reshape(-1)
    miss_mask = torch.zeros(257, dtype=torch.int64, device=dev)
    miss_mask.index_add_(0, mb, miss.reshape(-1).long())
    return scores[:n_ids], n_tokens, miss_mask[:256], start_next, sync_ok
