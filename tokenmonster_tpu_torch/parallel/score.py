"""The trainer's exact candidate scorer, on one device or several.

Port of ``tokenmonster_tpu/parallel/score.py::make_pallas_score_step``
and of the way the JAX trainer calls it (``_score_tpu_pallas``): a
candidate's strips go to the device in batches of ``BATCH`` (16) strips
a call, fewer strips in the power of two that holds them
(``batch_size``; ``GpuTokenizer.stage_batch``: one pinned staging, one
copy), each
strip through ``GpuTokenizer``'s dispatch chain (match, decide and follow
on the candidate's tables, ``start_next`` carried on the device) with
the epilogue ``device_stitch_score``: chars-covered scores per candidate
id over the spliced record stream, the token count and the missing-byte
mask, as the native contiguous scorer (``tm_tokenize_score``) counts
them.  A batch's sums, over the strips that held, add up on the device
across batches and are read back once per candidate.

On a card each batch is one replay of a CUDA graph captured once per
(lanes, dispatches, batch, candidate bucket, ids) key on the scoring
tokenizer (``_run_captured``), the counterpart of the JAX package's one
jitted step per geometry: the candidate's tables have shapes fixed by
its superset and its bucket (``ops/tables.py::CandidateTables``; scores
at ``ids_cap``, cut to the candidate's ids on the host), and whatever
differs from one candidate to the next, its unk and delete ids among
them, is read on the device, so the graph takes them as static inputs,
copied in before a replay where another candidate's are loaded.  Two
threads may score on one tokenizer: each holds the graph's lock from
loading its inputs through reading its outputs.  On the CPU the same
batch runs op by op (``_run_eager``), as it does on a card where a
caller asks for it.

The candidate's tables are its ``CandidateTables`` on a superset's match
tables (REMAP mode: the match words are mapped to candidate indices
before decide), or, where no superset fits it, the full ``DeviceTables``
of its own placement, held by a ``GpuTokenizer`` of the candidate (the
JAX package's exact scorer on the candidate's own tables,
``make_exact_score_step``), whose shapes change with every candidate:
those strips run op by op (``score_strips``), as do a split strip's
shares and every repair, each counted by cause (``EAGER_CAUSES``).

A strip that overflows the fast record window is scored again on the full
window; a full-window overflow is a kernel fault and raises.  A junction
whose lanes share no state (chains that stay out of phase past the
overlap, as in long runs of one repeated unit) is repaired on the device
(``GpuTokenizer.run_repaired``), where the JAX package sends the strip to
the native scorer: the text's own chain is followed on from the last lane
that holds it (``stitch.restart_point``, on the record grids the first
pass kept) by one lane of its own, which is cut into columns that replace
the lanes after it, and the strip is scored again, alone, op by op.  Each
repair lane spans twice the lanes of the one before, so a run of m
failed junctions takes about log2(m) repairs.

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

import copy
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import tracing
from ..ops.scan import Batch, GpuTokenizer, _recording
from ..ops.stitch import device_stitch_score
from ..ops.tables import PER_CANDIDATE
from . import multihost

BATCH = 16          # strips a device call where strips outnumber slots (the
                    # JAX trainer's ``batch``)
# What is scored op by op on a card, counted: a candidate on its own
# tables (a call), a split strip's share, a strip scored again behind a
# first pass or a share that did not hold
EAGER_CAUSES = ("own_tables", "split_share", "repair")


def ids_cap(n_ids: int) -> int:
    """The length of a superset's candidates' scores on the device: the
    power of two of at least ``max(n_ids, 256)`` (the JAX trainer's
    ``n_ids_cap``)."""
    cap = 256
    while cap < n_ids:
        cap <<= 1
    return cap


def batch_size(n_strips: int) -> int:
    """Rows of each device call for a candidate of ``n_strips`` strips:
    ``BATCH``, the JAX trainer's batch (its last partial batch padded with
    empty rows), or, for fewer strips, the power of two that holds them,
    so that a caller of one strip (the full text) or a few pads no empty
    rows and replays a graph of its own size."""
    rows = 1
    while rows < min(n_strips, BATCH):
        rows <<= 1
    return rows


def score_epilogue(tabs, n_ids: int, chunk: int):
    """The dispatch epilogue that scores ``tabs``'s candidate (its
    ``CandidateTables`` or its own ``DeviceTables``): token words
    resolve to candidate ids through the candidate-sized ``ids3`` (one
    gather per record slot, as ``make_pallas_score_step`` does; slots that
    emit nothing are masked in ``device_stitch_score``), then the scores
    of the dispatch, ``n_ids`` long; the delete id is read on the device
    (``tabs.literals``)."""
    ids3 = tabs.ids3.long().reshape(-1) & 0xFFFFFFFF
    S = tabs.w3_shift
    delete_token = tabs.literals[2]

    def epilogue(recs, toks, buf, start0, last_lane, final):
        t = toks.long()
        idx = t & ((1 << S) - 1)
        w3 = (t >> S) & 3
        emit = ids3[(idx * 3 + w3.clamp(max=2)).clamp(0, ids3.numel() - 1)]
        scores, n_tok, miss_mask, start_next, sync_ok = device_stitch_score(
            recs, emit, buf, start0, last_lane, final, n_ids, chunk,
            delete_token)
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
            grids, acc):
    """Score one strip whose first pass (fast window, ``flags`` and
    ``grids`` as ``GpuTokenizer.run_recorded`` gave them) did not hold,
    through ``GpuTokenizer.run_repaired``: on the full window where a lane
    overflowed, with repair lanes where a splice did not hold.  Its
    (scores, n_tokens, miss_mask) are added on the device to ``acc``, which
    the caller reads once (``_read_sums``) after its last strip; returns
    the repairs made."""
    outs, _full, repairs = tk.run_repaired(
        staged, data, tabs, epilogue,
        lambda outs: torch.stack([torch.stack([o[4].bool(), o[3]])
                                  for o in outs]).cpu().numpy(),
        flags, grids)
    for a, v in zip(acc, _sum_outs(outs)):
        a += v
    return repairs


def _read_sums(acc, n_ids: int):
    """Device sums ``acc`` [scores, n_tokens, miss_mask] in one read-back:
    (scores int64 [n_ids], n_tokens, miss_mask int64 [256]) on the host."""
    host = torch.cat([acc[0][:n_ids], acc[1].reshape(1), acc[2]]
                     ).cpu().numpy()
    return host[:n_ids], int(host[n_ids]), host[n_ids + 1:]


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
    with tracing.span("score", sum(1 for d in datasets if len(d))):
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
        with tracing.span("readback") as sp:
            host = torch.cat([acc_s, acc_t, acc_m,
                              torch.stack(all_flags).reshape(-1).long()]
                             ).cpu().numpy()
            sp.n = host.nbytes
    scores, n_tokens = host[:n_ids].copy(), int(host[n_ids])
    miss_mask = host[n_ids + 1:n_ids + 257].copy()
    repairs = again = 0
    with tracing.span("rescore") as sp:
        acc = [acc_s.zero_(), acc_t.zero_(), acc_m.zero_()]
        for (data, staged, flags, grids), (done, sync) in zip(
                strips, host[n_ids + 257:].reshape(-1, 2)):
            if done and sync:
                continue
            repairs += _repair(tk, staged, data, tabs, epilogue,
                               flags.cpu().numpy(), grids, acc)
            again += 1
        sp.n = again
        if again:
            s, nt, mm = _read_sums(acc, n_ids)
            scores += s
            n_tokens += nt
            miss_mask += mm
    return scores, n_tokens, miss_mask, repairs


def _batch_sums(tk: GpuTokenizer, tabs, text, scalars, lanes: int,
                n_ids: int):
    """One batch's score chain on ``tabs``, enqueued with no host sync:
    every strip's dispatches (``text`` (batch, k, N), ``scalars``
    (batch, k, 3)) through the chain and the score epilogue.  Returns the
    batch's (scores int64 [n_ids], n_tokens, miss_mask int64 [256]) over
    the strips that held, per dispatch (batch, k, 2) bool (done, sync),
    and the record grids ``restart_point`` reads: recs (batch, k, T, L)
    and their record skips (batch, k)."""
    B, k = text.shape[:2]
    epilogue = score_epilogue(tabs, n_ids, tk.chunk)
    zero = torch.zeros((), dtype=torch.int64, device=text.device)
    scores = torch.zeros(n_ids, dtype=torch.int64, device=text.device)
    n_tok = torch.zeros((), dtype=torch.int64, device=text.device)
    miss = torch.zeros(256, dtype=torch.int64, device=text.device)
    flags, recs, starts = [], [], []
    for b in range(B):
        grids = []
        outs, _ = tk._chain(list(text[b]), scalars[b], zero, lanes, False,
                            tabs, _recording(epilogue, grids), {})
        held = torch.stack([torch.stack([o[4].bool(), o[3]]) for o in outs])
        ok = held.all().long()
        s = outs[0][0]
        for o in outs[1:]:
            s = s + o[0]
        scores += s.mul_(ok)
        n_tok += sum(o[1] for o in outs) * ok
        miss += sum(o[2] for o in outs) * ok
        flags.append(held)
        recs += [r for r, _s in grids]
        starts += [s0 for _r, s0 in grids]
    T, L = recs[0].shape
    return (scores, n_tok, miss, torch.stack(flags),
            torch.stack(recs).view(B, k, T, L), torch.stack(starts).view(B, k))


def _run_eager(tk: GpuTokenizer, tabs, batch: Batch, n_ids: int, acc):
    """A batch's score chain op by op on ``tabs``: its sums added to
    ``acc`` [scores, n_tokens, miss_mask]; returns (flags, recs, starts)
    as ``_batch_sums`` gives them."""
    with tracing.span("launch", 1):
        scores, n_tok, miss, *rest = _batch_sums(
            tk, tabs, batch.text, batch.scalars, batch.lanes, n_ids)
        for a, v in zip(acc, (scores, n_tok, miss)):
            a += v
    return rest


def _run_captured(tk: GpuTokenizer, tabs, batch: Batch, n_ids: int, acc):
    """``_run_eager``'s results from one replay of the batch's captured
    score chain: the graph of (lanes, dispatches, batch, candidate bucket,
    ``n_ids``) on ``tk``, captured at its first use, its static inputs
    the batch's text and scalars and ``tabs``'s ``PER_CANDIDATE``
    tensors (copied in where the graph holds another candidate's).  Under
    the graph's lock: load, replay, the sums added to ``acc`` and the
    flags and grids cloned, so another thread's replay cannot overwrite
    them first."""
    B, k = batch.text.shape[:2]
    key = ("score", batch.lanes, k, B, tabs.meta.shape[1], n_ids)
    values = {"text": batch.text, "scalars": batch.scalars}
    tables = {f"tables.{name}": getattr(tabs, name)
              for name in PER_CANDIDATE}
    lanes = batch.lanes

    def body(inputs):
        static = copy.copy(tabs)
        for name in PER_CANDIDATE:
            setattr(static, name, inputs[f"tables.{name}"])
        return _batch_sums(tk, static, inputs["text"], inputs["scalars"],
                           lanes, n_ids)
    index = tk.device.index      # None: the current device, as is
    with torch.cuda.device(-1 if index is None else index), \
            tracing.span("launch", 1):
        graph = tk.graph(key, {**values, **tables}, body)
        with graph.lock:
            if graph.source is None or graph.source() is not tabs:
                values.update(tables)
                graph.source = weakref.ref(tabs)
            graph.load(values)
            scores, n_tok, miss, *rest = graph.replay()
            for a, v in zip(acc, (scores, n_tok, miss)):
                a += v
            rest = [t.clone() for t in rest]
            graph.release()
    return rest


def score_batched(tk: GpuTokenizer, tabs, datasets, n_ids: int):
    """Score every strip of ``datasets`` with a candidate on its
    ``CandidateTables`` ``tabs`` over ``tk``'s superset tables,
    ``batch_size`` strips a device call: on a card each batch one replay of a captured
    graph (``_run_captured``), on the CPU op by op (``_run_eager``); one
    read-back.  A strip that did not hold is scored again, alone, op by
    op, repaired (``_repair``) from its own view of its batch's staging
    and the record grids of the first pass.

    Returns (scores int64 [n_ids], n_tokens, miss_mask int64 [256],
    junction repairs, strips scored again)."""
    dev = tk.device
    cap = ids_cap(max(len(tk.vocab.reverse), n_ids))
    strips = [d for d in datasets if len(d)]
    if not strips:
        return np.zeros(n_ids, np.int64), 0, np.zeros(256, np.int64), 0, 0
    run = _run_captured if dev.type == "cuda" else _run_eager
    batch = batch_size(len(strips))
    with tracing.span("score", len(strips)):
        acc = [torch.zeros(cap, dtype=torch.int64, device=dev),
               torch.zeros((), dtype=torch.int64, device=dev),
               torch.zeros(256, dtype=torch.int64, device=dev)]
        kept = []
        for g in range(0, len(strips), batch):
            with tracing.span("stage") as sp:
                staged = tk.stage_batch(strips[g:g + batch], batch)
                sp.n = sum(staged.counts)
            kept.append((staged, *run(tk, tabs, staged, cap, acc)))
        with tracing.span("readback") as sp:
            host = torch.cat([acc[0][:n_ids], acc[1].reshape(1), acc[2]]
                             + [f.reshape(-1).long() for _b, f, _r, _s in kept]
                             ).cpu().numpy()
            sp.n = host.nbytes
    scores, n_tokens = host[:n_ids].copy(), int(host[n_ids])
    miss_mask = host[n_ids + 1:n_ids + 257].copy()
    at, repairs, again = n_ids + 257, 0, 0
    epilogue = score_epilogue(tabs, cap, tk.chunk)
    with tracing.span("rescore") as sp:
        for a in acc:       # now the sums of the strips scored again
            a.zero_()
        for staged, flags, recs, starts in kept:
            held = host[at:at + flags.numel()].reshape(flags.shape) != 0
            at += flags.numel()
            for b, k in enumerate(staged.counts):
                if held[b, :k].all():
                    continue
                grids = [(recs[b, d], starts[b, d]) for d in range(k)]
                repairs += _repair(tk, staged.strip(b), staged.strips[b],
                                   tabs, epilogue, held[b, :k], grids, acc)
                again += 1
        if again:
            s, nt, mm = _read_sums(acc, n_ids)
            scores += s
            n_tokens += nt
            miss_mask += mm
        sp.n = again
    return scores, n_tokens, miss_mask, repairs, again


def score_whole(tk: GpuTokenizer, tabs, datasets, n_ids: int):
    """Whole strips of a candidate: batched (``score_batched``) on a
    superset's ``CandidateTables``, op by op (``score_strips``) on a
    candidate's own tables.  Returns (scores, n_tokens, miss_mask,
    repairs, {cause: count} of ``EAGER_CAUSES``)."""
    eager = dict.fromkeys(EAGER_CAUSES, 0)
    if tabs.rank is None:
        eager["own_tables"] = 1
        return (*score_strips(tk, tabs, datasets, n_ids), eager)
    *sums, eager["repair"] = score_batched(tk, tabs, datasets, n_ids)
    return (*sums, eager)


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
        batch = BATCH if len(n_dispatches) > n_slots else 1
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
    on its thread: the sums of its whole strips (``score_whole``) and of
    each share of a split strip,
    with whether that share held.  Returns ((scores, n_tokens, miss_mask,
    repairs, eager counts), [(strip, scores, n_tokens, miss_mask,
    ok)])."""
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
    sums = score_whole(tk, tabs, whole, n_ids)
    sums[4]["split_share"] = len(split)
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
    (scores, n_tokens, miss_mask, repairs, eager counts by cause), the
    first three over every rank, the last two this process's."""
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
    eager = dict.fromkeys(EAGER_CAUSES, 0)
    for (s, nt, mm, r, e), _parts in shares:
        scores += s
        n_tokens += nt
        miss_mask += mm
        repairs += r
        for cause, count in e.items():
            eager[cause] += count
    # own tables: one candidate, however many slots scored it
    eager["own_tables"] = min(eager["own_tables"], 1)
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
        return s, nt, mm, repairs, eager
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
                eager["repair"] += 1
    s, nt, mm, _ok = multihost.reduce_step(*out)
    return s, nt, mm, repairs, eager
