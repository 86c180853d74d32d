"""The trainer's exact candidate scorer, on one device or several.

Port of ``tokenmonster_tpu/parallel/score.py::make_pallas_score_step``:
each corpus strip goes through ``GpuTokenizer``'s planning, staging and
dispatch chain (match, decide and follow on the candidate's tables, with
``start_next`` carried on the device), whose epilogue here is
``device_stitch_score``: chars-covered scores per candidate id over the
spliced record stream, the token count and the missing-byte mask, as the
native contiguous scorer (``tm_tokenize_score``) counts them.  Scores,
counts and masks accumulate on the device across strips and are read back
once per candidate.  Missing bytes are scored on the device.  The
candidate's tables are its ``CandidateTables`` on a superset's match
tables (REMAP mode: the match words are mapped to candidate indices
before decide), or, where no superset fits it, the full ``DeviceTables``
of its own placement, held by a ``GpuTokenizer`` of the candidate (the
JAX package's exact scorer on the candidate's own tables,
``make_exact_score_step``).

A strip that overflows the fast record window is scored again on the full
window; a full-window overflow is a kernel fault and raises.  A junction
whose lanes share no state (chains that stay out of phase past the
overlap, as in long runs of one repeated unit) is repaired on the device
(``GpuTokenizer.run_repaired``), where the JAX package sends the strip to
the native scorer: the text's own chain is followed on from the last lane
that holds it (``stitch.restart_point``) by one lane of its own, which is
cut into columns that replace the lanes after it, and the strip is scored
again.  Each repair lane spans twice the lanes of the one before, so a
run of m failed junctions takes about log2(m) repairs.

Several scoring slots (``score_slots``; the JAX package's ``shard_map``
over a mesh and ``psum``) split a candidate's strips: whole strips in the
JAX layout where there are at least as many strips as slots, else each
strip's dispatches in contiguous shares, one a slot.  A share that starts
inside a strip first runs the dispatch before it unscored: the record
skip that dispatch hands on depends only on its last two lanes, so the
share starts where a run of the whole strip would.  Each slot scores its
share on a thread and, on a card, a stream of its own; slots may span
processes (``parallel/multihost.py``), whose sums are all-reduced.  A
strip some share of which did not hold is scored again, whole, by the
slot that holds its first share.  Integer sums are associative, so the
result is bit-exact against one device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops.scan import GpuTokenizer
from ..ops.stitch import device_stitch_score
from . import multihost


def score_epilogue(tabs, n_ids: int, chunk: int):
    """The dispatch epilogue that scores ``tabs``'s candidate (its
    ``CandidateTables`` or its own ``DeviceTables``): token words
    resolve to candidate ids through the candidate-sized ``ids3`` (one
    gather per record slot, as ``make_pallas_score_step`` does; slots that
    emit nothing are masked in ``device_stitch_score``), then the scores
    of the dispatch."""
    ids3 = tabs.ids3.long().reshape(-1) & 0xFFFFFFFF
    S = tabs.w3_shift

    def epilogue(recs, toks, buf, start0, last_lane, final):
        t = toks.long()
        idx = t & ((1 << S) - 1)
        w3 = (t >> S) & 3
        emit = ids3[(idx * 3 + w3.clamp(max=2)).clamp(0, ids3.numel() - 1)]
        scores, n_tok, miss_mask, start_next, sync_ok = device_stitch_score(
            recs, emit, buf, start0, last_lane, final, n_ids, chunk,
            tabs.delete_token)
        return start_next, (scores, n_tok, miss_mask, sync_ok)
    return epilogue


def _sum_outs(outs):
    """The sums of a strip's dispatches ``outs``, as device tensors:
    (scores, n_tokens, miss_mask, flags), flags (dispatches, 2) their
    (done, sync)."""
    scores = torch.stack([o[0] for o in outs]).sum(0)
    n_tok = torch.stack([o[1] for o in outs]).sum()
    miss_mask = torch.stack([o[2] for o in outs]).sum(0)
    flags = torch.stack([torch.stack([o[4].bool(), o[3]]) for o in outs])
    return scores, n_tok, miss_mask, flags


def _repair(tk: GpuTokenizer, staged, data: bytes, tabs, epilogue, flags,
            grids):
    """Score one strip whose first pass (fast window, ``flags`` and
    ``grids`` as ``GpuTokenizer.run_recorded`` gave them) did not hold,
    through ``GpuTokenizer.run_repaired``: on the full window where a lane
    overflowed, with repair lanes where a splice did not hold.  Returns
    (scores, n_tokens, miss_mask) as numpy and the repairs made."""
    outs, _full, repairs = tk.run_repaired(
        staged, data, tabs, epilogue,
        lambda outs: _sum_outs(outs)[3].cpu().numpy(), flags, grids)
    s, nt, mm, _flags = _sum_outs(outs)
    return s.cpu().numpy(), int(nt), mm.cpu().numpy(), repairs


def score_strips(tk: GpuTokenizer, tabs, datasets, n_ids: int):
    """Score every strip of ``datasets`` with ``tabs``'s candidate, every
    byte on the device: ``tabs`` is its ``CandidateTables`` on ``tk``'s
    superset tables, or ``tk.tables`` where ``tk`` is a tokenizer of the
    candidate itself.

    Returns (scores int64 [n_ids], n_tokens, miss_mask int64 [256],
    repairs): totals over the strips, and the junction repairs made."""
    dev = tk.device
    epilogue = score_epilogue(tabs, n_ids, tk.chunk)
    acc_s = torch.zeros(n_ids, dtype=torch.int64, device=dev)
    acc_t = torch.zeros(1, dtype=torch.int64, device=dev)
    acc_m = torch.zeros(256, dtype=torch.int64, device=dev)
    strips, all_flags = [], []
    for data in datasets:
        if len(data) == 0:
            continue
        staged = tk.stage(data)
        outs, grids = tk.run_recorded(staged, False, tabs, epilogue, {})
        s, nt, mm, flags = _sum_outs(outs)
        ok = flags.all()
        acc_s += torch.where(ok, s, 0)
        acc_t += torch.where(ok, nt, 0)
        acc_m += torch.where(ok, mm, 0)
        strips.append((data, staged, flags, grids))
        all_flags.append(flags.all(0))
    if not strips:
        return np.zeros(n_ids, np.int64), 0, np.zeros(256, np.int64), 0
    host = torch.cat([acc_s, acc_t, acc_m,
                      torch.stack(all_flags).reshape(-1).long()]).cpu().numpy()
    scores, n_tokens = host[:n_ids].copy(), int(host[n_ids])
    miss_mask = host[n_ids + 1:n_ids + 257].copy()
    repairs = 0
    for (data, staged, flags, grids), (done, sync) in zip(
            strips, host[n_ids + 257:].reshape(-1, 2)):
        if done and sync:
            continue
        s, nt, mm, r = _repair(tk, staged, data, tabs, epilogue,
                               flags.cpu().numpy(), grids)
        scores += s
        n_tokens += nt
        miss_mask += mm
        repairs += r
    return scores, n_tokens, miss_mask, repairs


class Slot:
    """One scoring slot on ``device``, with a thread and, on a card, a
    stream of its own; ``tokenizer``: the prepared superset's tokenizer
    on that device, None until one is armed."""

    def __init__(self, device: torch.device):
        self.tokenizer = None
        self.device = device
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._thread = ThreadPoolExecutor(max_workers=1)

    def run(self, fn, *args):
        """A future of ``fn(*args)`` on this slot's thread, device and
        stream."""
        return self._thread.submit(self._call, fn, args)

    def _call(self, fn, args):
        if self.stream is None:
            return fn(*args)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            return fn(*args)


def plan_pieces(n_dispatches: list, n_slots: int) -> list:
    """Each slot's share of a candidate's strips, given each strip's
    dispatch count: per slot a list of (strip, first dispatch, stop
    dispatch).  With at least as many strips as slots, whole strips as the
    JAX trainer lays them out (``tokenmonster_tpu/train/trainvocab.py``,
    ``_score_tpu_pallas``: in each group of ``n_slots * batch`` strips,
    strip i on slot ``i // batch``, ``batch`` 16 where strips outnumber
    slots, else 1); with fewer, each strip's dispatches cut into
    ``n_slots`` contiguous ranges, the k-th on slot k."""
    pieces = [[] for _ in range(n_slots)]
    if len(n_dispatches) >= n_slots:
        batch = 16 if len(n_dispatches) > n_slots else 1
        for i, d in enumerate(n_dispatches):
            pieces[(i % (n_slots * batch)) // batch].append((i, 0, d))
        return pieces
    for i, d in enumerate(n_dispatches):
        for k in range(n_slots):
            first, stop = d * k // n_slots, d * (k + 1) // n_slots
            if first < stop:
                pieces[k].append((i, first, stop))
    return pieces


def _score_piece(tk: GpuTokenizer, tabs, epilogue, data: bytes, first: int,
                 stop: int):
    """Enqueue dispatches [first, stop) of a strip: ``_sum_outs`` of
    them.  Where ``first`` > 0 the dispatch before it runs too,
    unscored, for the record skip it hands on."""
    warm = 1 if first > 0 else 0
    staged = tk.stage(data, first - warm, stop)
    return _sum_outs(tk._run_staged(staged, False, tabs, epilogue,
                                    {})[warm:])


def _slot_share(tk: GpuTokenizer, tabs, datasets, pieces, n_dispatches,
                n_ids: int):
    """One slot's share of a candidate on ``tabs`` (on the slot's device),
    on its thread: the sums of its whole strips (repaired where needed)
    and of each share of a split strip, with whether that share held.
    Returns ((scores, n_tokens, miss_mask, repairs), [(strip, scores,
    n_tokens, miss_mask, ok)])."""
    epilogue = score_epilogue(tabs, n_ids, tk.chunk)
    split, whole = [], []
    for i, first, stop in pieces:
        if first == 0 and stop == n_dispatches[i]:
            whole.append(datasets[i])
        else:
            s, nt, mm, flags = _score_piece(tk, tabs, epilogue, datasets[i],
                                            first, stop)
            split.append((i, torch.cat([s, nt.reshape(1), mm,
                                        flags.all().reshape(1).long()])))
    sums = score_strips(tk, tabs, whole, n_ids)
    parts = []
    for i, t in split:
        h = t.cpu().numpy()
        parts.append((i, h[:n_ids], int(h[n_ids]),
                      h[n_ids + 1:n_ids + 257], bool(h[-1])))
    return sums, parts


def score_slots(slots: list, arm, datasets, n_ids: int, rank: int = 0,
                world: int = 1):
    """Score every strip of ``datasets`` with a candidate over the scoring
    ``slots`` of this process and, in a run of ``world`` processes, every
    other rank's.  ``arm(slot)``, run on each slot's thread and stream,
    puts the candidate's tables on the slot's device and returns (the
    tokenizer that plans, stages and chains there, the tables): the slot's
    superset tokenizer and the candidate's ``CandidateTables``, or a
    tokenizer of the candidate and its own tables.  Every rank must call
    it with the same strips and tokenizers of the same chunk.  Returns
    ``score_strips``'s (scores, n_tokens, miss_mask, repairs), the first
    three over every rank, the repairs this process made."""
    n_local = len(slots)
    armed = [f.result() for f in [slot.run(arm, slot) for slot in slots]]
    tk0 = armed[0][0]
    n_disp = [len(tk0._plan(len(d))[1]) if len(d) else 0 for d in datasets]
    plan = plan_pieces(n_disp, n_local * world)
    mine = plan[rank * n_local:(rank + 1) * n_local]
    shares = [f.result() for f in
              [slot.run(_slot_share, tk, tabs, datasets, pieces, n_disp,
                        n_ids)
               for slot, (tk, tabs), pieces in zip(slots, armed, mine)]]
    scores = np.zeros(n_ids, np.int64)
    miss_mask = np.zeros(256, np.int64)
    n_tokens, repairs = 0, 0
    for (s, nt, mm, r), _parts in shares:
        scores += s
        n_tokens += nt
        miss_mask += mm
        repairs += r
    parts = [p for share in shares for p in share[1]]

    def with_parts(keep):
        out = [scores.copy(), n_tokens, miss_mask.copy()]
        for i, s, nt, mm, _ok in parts:
            if keep(i):
                out[0] += s
                out[1] += nt
                out[2] += mm
        return out

    s, nt, mm, ok_all = multihost.reduce_step(
        *with_parts(lambda i: True), all(p[4] for p in parts))
    if ok_all:
        return s, nt, mm, repairs
    # a share of a split strip did not hold: score those strips again,
    # whole, where their first share is
    split_ids = sorted({i for pieces in plan for i, first, stop in pieces
                        if not (first == 0 and stop == n_disp[i])})
    failed = np.zeros(len(split_ids), np.int64)
    for i, _s, _nt, _mm, ok in parts:
        failed[split_ids.index(i)] += not ok
    failed = multihost.all_reduce_sum(failed)
    bad = {i for i, f in zip(split_ids, failed) if f}
    out = with_parts(lambda i: i not in bad)
    for k, pieces in enumerate(mine):
        for i, first, _stop in pieces:
            if i in bad and first == 0:
                s, nt, mm, r = slots[k].run(
                    score_strips, *armed[k], [datasets[i]], n_ids).result()
                out[0] += s
                out[1] += nt
                out[2] += mm
                repairs += r
    s, nt, mm, _ok = multihost.reduce_step(*out)
    return s, nt, mm, repairs
