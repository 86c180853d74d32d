"""The trainer's exact candidate scorer on one device.

Port of ``tokenmonster_tpu/parallel/score.py::make_pallas_score_step``
without its ``shard_map``/``psum`` (one card, one process): each corpus
strip goes through ``GpuTokenizer``'s planning, staging and dispatch chain
(match, decide and follow on the candidate's ``CandidateTables``, with
``start_next`` carried on the device), whose epilogue here is
``device_stitch_score``: chars-covered scores per candidate id over the
spliced record stream, the token count and the missing-byte mask, as the
native contiguous scorer (``tm_tokenize_score``) counts them.  Scores,
counts and masks accumulate on the device across strips and are read back
once per candidate.  Missing bytes are scored on the device.

A strip that overflows the fast record window is scored again on the full
window; a full-window overflow is a kernel fault and raises.  A junction
whose lanes share no state (chains that stay out of phase past the
overlap, as in long runs of one repeated unit) is repaired on the device,
where the JAX package sends the strip to the native scorer: the text's
own chain is followed on from the last lane that holds it
(``stitch.restart_point``) by one lane of its own, which is cut into
columns that replace the lanes after it, and the strip is scored again.
Each repair lane spans twice the lanes of the one before, so a run of m
failed junctions takes about log2(m) repairs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.decide import W3_SHIFT
from ..ops.scan import OVERLAP_SCAN, GpuTokenizer
from ..ops.stitch import device_stitch_score, restart_point
from ..ops.tables import CandidateTables


def score_epilogue(tabs: CandidateTables, n_ids: int, chunk: int):
    """The dispatch epilogue that scores ``tabs``'s candidate: token words
    resolve to candidate ids through ``ids3`` (one gather per record slot,
    as ``make_pallas_score_step`` does; slots that emit nothing are masked
    in ``device_stitch_score``), then the scores of the dispatch."""
    ids3 = tabs.ids3.long().reshape(-1) & 0xFFFFFFFF

    def epilogue(recs, toks, buf, start0, last_lane: int, final: bool):
        t = toks.long()
        idx = t & ((1 << W3_SHIFT) - 1)
        w3 = (t >> W3_SHIFT) & 3
        emit = ids3[(idx * 3 + w3.clamp(max=2)).clamp(0, ids3.numel() - 1)]
        scores, n_tok, miss_mask, start_next, sync_ok = device_stitch_score(
            recs, emit, buf, start0, last_lane, final, n_ids, chunk,
            tabs.delete_token)
        return start_next, (scores, n_tok, miss_mask, sync_ok)
    return epilogue


def _score_staged(tk: GpuTokenizer, staged, tabs, epilogue, full: bool,
                  patches: dict):
    """Enqueue one staged strip: (scores, n_tokens, miss_mask, flags) as
    device tensors, the first three summed over its dispatches, flags
    (dispatches, 2) their (done, sync)."""
    outs = tk._run_staged(staged, full, tabs, epilogue, patches)
    scores = torch.stack([o[0] for o in outs]).sum(0)
    n_tok = torch.stack([o[1] for o in outs]).sum()
    miss_mask = torch.stack([o[2] for o in outs]).sum(0)
    flags = torch.stack([torch.stack([o[4].bool(), o[3]]) for o in outs])
    return scores, n_tok, miss_mask, flags


def _repair_columns(tk: GpuTokenizer, tabs, data: bytes, off: int, g: int,
                    at: int, k: int, t_rec: int):
    """Columns of the text's chain from state (``at``, fd 0) for lanes
    g+1 .. g+k of the dispatch at ``off``, positions in that dispatch:
    lane g+1 gets the chain up to its own scan end, each later lane the
    records past its start up to its scan end, as a lane's own scan would
    reach.  So each column's first record is a state of the lane before it,
    and the splices hold.  {lane: (recs, toks)} int32 columns of ``t_rec``
    rows, or None where a column holds more records than ``t_rec``."""
    chunk = tk.chunk
    end = (g + k + 1) * chunk + OVERLAP_SCAN    # lane g+k's scan end
    recs, toks = tk.chain(tabs, data, off + at, end - at)
    pos = (recs >> 4) + at
    recs = (pos << 4) | (recs & 0xF)
    cols = {}
    for lane in range(g + 1, g + k + 1):
        sel = pos <= (lane + 1) * chunk + OVERLAP_SCAN
        if lane > g + 1:
            sel &= pos > lane * chunk
        if sel.sum() > t_rec:
            return None
        col = np.zeros((2, t_rec), np.int64)
        col[0, :sel.sum()], col[1, :sel.sum()] = recs[sel], toks[sel]
        col = torch.from_numpy(col.astype(np.int32)).to(tk.device)
        cols[lane] = (col[0], col[1])
    return cols


def _repair(tk: GpuTokenizer, staged, data: bytes, tabs, epilogue,
            full: bool):
    """Score one strip whose first pass did not hold: on the full window
    where a lane overflowed, with repair lanes where a splice did not hold.
    Returns (scores, n_tokens, miss_mask) as numpy and the repairs made."""
    _n, L, bufs = staged
    plan = tk._plan(len(data))[1]
    patches, repairs, last = {}, 0, (-1, -1)
    while True:
        grids = []                 # each dispatch's (recs, start0)

        def recording(recs, toks, buf, start0, last_lane, final):
            grids.append((recs, start0))
            return epilogue(recs, toks, buf, start0, last_lane, final)
        s, nt, mm, flags = _score_staged(tk, staged, tabs, recording, full,
                                         patches)
        flags = flags.cpu().numpy()
        if not flags[:, 0].all():
            if full:
                raise RuntimeError("a lane overflowed the full record "
                                   "window, which holds every record a "
                                   "lane can emit: a fault of the decide "
                                   "or follow kernel")
            full, patches, repairs, last = True, {}, 0, (-1, -1)
            continue
        if flags[:, 1].all():
            return s.cpu().numpy(), int(nt), mm.cpu().numpy(), repairs
        d = int(np.nonzero(~flags[:, 1])[0][0])
        last_lane, final = bufs[d][2], d == len(bufs) - 1
        g, at = restart_point(*grids[d], last_lane, final)
        if (d, g) <= last:
            raise RuntimeError(f"a repaired junction (dispatch {d}, lane {g})"
                               " did not hold: a fault of the repair")
        last = (d, g)
        k = min((last_lane if final else L - 1) - g, 1 << repairs)
        cols = _repair_columns(tk, tabs, data, plan[d][0], g, at, k,
                               tk._t_rec(full))
        if cols is None:           # dense text: the full window holds it
            full, patches, repairs, last = True, {}, 0, (-1, -1)
            continue
        for lane, (rec_col, tok_col) in cols.items():
            patches.setdefault(d, {})[lane] = (rec_col, tok_col)
            if lane == L - 1 and not final:
                # the bridge lane is the next dispatch's lane 0
                shift = (plan[d + 1][0] - plan[d][0]) << 4
                rec_col = torch.where(rec_col != 0, rec_col - shift, 0)
                patches.setdefault(d + 1, {})[0] = (rec_col, tok_col)
        repairs += 1


def score_strips(tk: GpuTokenizer, tabs: CandidateTables, datasets,
                 n_ids: int):
    """Score every strip of ``datasets`` with ``tabs``'s candidate, every
    byte on the device.

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
        s, nt, mm, flags = _score_staged(tk, staged, tabs, epilogue, False,
                                         {})
        ok = flags.all()
        acc_s += torch.where(ok, s, 0)
        acc_t += torch.where(ok, nt, 0)
        acc_m += torch.where(ok, mm, 0)
        strips.append((data, staged))
        all_flags.append(flags.all(0))
    if not strips:
        return np.zeros(n_ids, np.int64), 0, np.zeros(256, np.int64), 0
    host = torch.cat([acc_s, acc_t, acc_m,
                      torch.stack(all_flags).reshape(-1).long()]).cpu().numpy()
    scores, n_tokens = host[:n_ids].copy(), int(host[n_ids])
    miss_mask = host[n_ids + 1:n_ids + 257].copy()
    repairs = 0
    for (data, staged), (done, sync) in zip(strips,
                                            host[n_ids + 257:].reshape(-1, 2)):
        if done and sync:
            continue
        s, nt, mm, r = _repair(tk, staged, data, tabs, epilogue, not done)
        scores += s
        n_tokens += nt
        miss_mask += mm
        repairs += r
    return scores, n_tokens, miss_mask, repairs
