"""End-to-end device tokenizer: match -> decide -> follow -> stitch/compact.

Port of ``tokenmonster_tpu/ops/scan.py::TpuTokenizer`` on its Pallas
engine (``_pallas_stitch_fn``), without the XLA engines and the host
stitcher.  Text is cut into fixed-geometry dispatches of up to
``MAX_LANES`` speculative chunk lanes; each lane starts at its chunk with
state (start, fd = 0) and scans ``OVERLAP_SCAN`` bytes past its chunk, and
neighbouring lanes splice at their first shared (position, fd) state
(ops/stitch.py).  Dispatches chain through a bridge lane, carrying the
record skip ``start_next`` on the device, so a whole text is enqueued with
no host sync; the host reads the per-dispatch counts once at the end.

A dispatch that overflows the fast record window retries once with the
full window, which cannot overflow: it holds one record per scanned byte,
two with a delete token (every record advances at least one byte, except
a step from fd 1 to fd 0 in place, which only follows one that advanced).
Two failures are
forced by the data and send the text to the exact native host tokenizer:
a missing byte in a vocabulary without an unk token (a kept record that
emits nothing; the native tokenizer confirms the missing byte), and a
junction whose lanes share no state within the overlap (chains that stay
out of phase, as in long runs of one repeated unit).  Each is counted by
cause in ``fallbacks`` and logged.  Any other failure is a kernel fault
and raises.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..native import NativeVocab
from . import _build
from .decide import decide, resolve_device
from .follow import follow
from .match import match
from .stitch import device_stitch_compact
from .tables import upload_tables

OVERLAP_SCAN = 128  # bytes a lane scans past its chunk end to find sync
MAX_LANES = 512     # lanes per dispatch; longer texts chain dispatches
MARGIN = 512        # real-data lookahead past a dispatch's exact region:
                    # the last lane scans OVERLAP_SCAN bytes past its chunk
                    # end and its matches need up to 2*max_token_length more
GRAIN = 2048        # dispatch buffers round up to the JAX kernels' tile
                    # grain, so each stage sees the N the JAX engine sees

_log = logging.getLogger(__name__)


def _bucket(n_lanes: int) -> int:
    """Round a lane count up to a power of two (few distinct geometries)."""
    b = 1
    while b < n_lanes:
        b <<= 1
    return b


def remap_matches(m: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Match words ``(idx << 6) | len`` of a trainer superset's tables with
    each idx replaced by ``rank[idx]``, the candidate's index of it; 0 (no
    match) stays 0, and alive-masked tables never match a dead index.  As
    ``tokenmonster_tpu/parallel/score.py`` (``_remap``) does before decide:
    a gather, which the JAX package does outside its kernels too."""
    ranked = (rank.index_select(0, m >> 6) << 6) | (m & 63)
    return torch.where(m == 0, m, ranked)


def check_device(device) -> torch.device:
    """``device`` as a torch.device; raises for "cuda" without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "card; pass device='cpu' for the plain PyTorch "
                           "versions of the kernels")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class GpuTokenizer:
    """Device tokenizer for a vocabulary on ``device``: CUDA kernels on a
    CUDA device, their plain PyTorch versions on ``"cpu"``.

    ``launches`` (per kernel, process-wide) and ``last_mode`` ("fast" or
    "full" record window, or "host" after a fallback) show which path the
    last call took; ``fallbacks`` counts, by cause ("missing_byte",
    "junction"), the texts the device path handed to the native tokenizer,
    and ``host_fallbacks`` is their total.  ``hashmatch_tables`` (a numpy
    match-table placement of ``vocab``, this package's or the JAX
    package's) shares one placement build; None builds it here."""

    def __init__(self, vocab, chunk: int = 2048, device="cuda",
                 hashmatch_tables=None, match_only: bool = False):
        self.device = device = check_device(device)
        self.vocab = vocab
        self.chunk = chunk
        self.tables = upload_tables(vocab, hashmatch_tables, device=device,
                                    match_only=match_only)
        self.last_mode = None
        self.fallbacks = {"missing_byte": 0, "junction": 0}

    @property
    def launches(self) -> dict:
        return dict(_build.launches)

    @property
    def host_fallbacks(self) -> int:
        return sum(self.fallbacks.values())

    def _t_rec(self, full: bool, span: int | None = None) -> int:
        """Record rows per lane of ``span`` bytes (default: a chunk):
        typical text emits about one record per 4 bytes (the fast window,
        the JAX engine's, so both take the same retries); the full window
        covers every record a lane can emit."""
        span = self.chunk if span is None else span
        per_byte = 2 if self.tables.has_delete else 1
        t_rec = ((span + OVERLAP_SCAN) * per_byte if full
                 else span * 3 // 8 + OVERLAP_SCAN + 64)
        return -(-t_rec // 128) * 128

    def _plan(self, n: int):
        """Dispatch plan for ``n`` bytes: (n_lanes, [(off, exact,
        last_lane)]).  One dispatch when the text fits; otherwise dispatches
        of MAX_LANES lanes owning (MAX_LANES-1)*chunk bytes each, the last
        lane of every dispatch re-scanned as the next one's lane 0."""
        chunk = self.chunk
        lanes_needed = -(-n // chunk)
        if lanes_needed <= MAX_LANES:
            return _bucket(lanes_needed), [(0, n, lanes_needed - 1)]
        stride = (MAX_LANES - 1) * chunk
        plan = []
        for off in range(0, n, stride):
            exact = min(stride, n - off)
            plan.append((off, exact, -(-exact // chunk) - 1))
        return MAX_LANES, plan

    def stage(self, data: bytes, first: int = 0, stop: int | None = None):
        """Upload the dispatch buffers in one copy; returns the staged
        object ``tokenize_staged`` runs (benchmarks reuse it).  ``first``
        and ``stop``: stage only those dispatches of the text's plan (a
        share of a long strip scored on several devices)."""
        n = len(data)
        arr = np.frombuffer(bytes(data), np.uint8)
        L, plan = self._plan(n)
        plan = plan[first:stop]
        total = L * self.chunk + MARGIN
        p2 = -(-(total + 64) // GRAIN) * GRAIN
        host = np.zeros((len(plan), p2), np.uint8)
        slices = []
        for i, (off, _exact, last_lane) in enumerate(plan):
            sl = arr[off:off + total]
            host[i, :len(sl)] = sl
            slices.append((len(sl), last_lane))
        bufs = torch.from_numpy(host).to(self.device)
        return n, L, [(bufs[i], n_i, lr) for i, (n_i, lr) in enumerate(slices)]

    @staticmethod
    def _compact(recs, toks, buf, start0, last_lane: int, final: bool):
        """The tokenizer's epilogue: (start_next, (out, count, missing,
        sync_ok, junction_ok))."""
        out, count, missing, start_next, sync_ok, junction_ok = (
            device_stitch_compact(recs, toks, start0, last_lane, final,
                                  recs.numel()))
        return start_next, (out, count, missing, sync_ok, junction_ok)

    def _records(self, buf, n: int, tabs, chunk: int, overlap: int,
                 n_lanes: int, t_rec: int):
        """Match, decide and follow on ``tabs``, enqueued: the (recs, toks,
        done_all) of lanes that each scan ``chunk + overlap`` bytes.  Tables
        with a ``rank`` (a trainer candidate's) have their match words
        mapped to candidate indices between match and decide."""
        if tabs.has_space:
            m, mb = match(buf, n, tabs)
        else:
            m, mb = match(buf, n, tabs), None
        if tabs.rank is not None:
            m = remap_matches(m, tabs.rank)
            mb = None if mb is None else remap_matches(mb, tabs.rank)
        ctl, tok = decide(m, mb, buf, n, tabs)
        return follow(ctl, tok, n, chunk, n_lanes, overlap, t_rec)

    def _dispatch(self, buf, n: int, start0, last_lane: int, final: bool,
                  n_lanes: int, full: bool, tabs, epilogue, patch: dict):
        """One dispatch, enqueued: the records on ``tabs``, the lanes of
        ``patch`` ({lane: (recs, toks) columns}) replaced, then
        ``epilogue``.  Returns (start_next, (*epilogue outputs, done_all))
        as device tensors."""
        recs, toks, done_all = self._records(buf, n, tabs, self.chunk,
                                             OVERLAP_SCAN, n_lanes,
                                             self._t_rec(full))
        for lane, (rec_col, tok_col) in patch.items():
            recs[:, lane] = rec_col
            toks[:, lane] = tok_col
        start_next, out = epilogue(recs, toks, buf, start0, last_lane, final)
        return start_next, (*out, done_all)

    def _run_staged(self, staged, full: bool, tabs, epilogue,
                    patches: dict, final: bool = True):
        """Enqueue every dispatch of a staged text, ``start_next`` carried
        as a device tensor; no host sync.  ``tabs`` and ``epilogue``: this
        tokenizer's tables and ``_compact``, or a candidate's tables and
        the trainer's score epilogue; ``patches``: {dispatch: {lane:
        columns}} of lanes to replace (the trainer's junction repair);
        ``final``: the last staged dispatch is the text's last.  Returns
        per dispatch the epilogue's outputs and the follow's done flag."""
        _n, L, bufs = staged
        start0 = torch.zeros((), dtype=torch.int64, device=self.device)
        outs = []
        for i, (buf, n_i, last_lane) in enumerate(bufs):
            start0, out = self._dispatch(buf, n_i, start0, last_lane,
                                         final and i == len(bufs) - 1, L,
                                         full, tabs, epilogue,
                                         patches.get(i, {}))
            outs.append(out)
        return outs

    def chain(self, tabs, data: bytes, at: int, span: int):
        """The text's own record chain from state (``at``, fd 0) through
        ``span`` bytes: the records on ``tabs`` of one lane in a dispatch of
        its own, full record window.  Returns its (recs, toks) as int64
        numpy arrays, positions relative to ``at``."""
        seg = np.frombuffer(bytes(data[at:at + span + MARGIN]), np.uint8)
        host = np.zeros(-(-(len(seg) + 64) // GRAIN) * GRAIN, np.uint8)
        host[:len(seg)] = seg
        buf = torch.from_numpy(host).to(self.device)
        recs, toks, done = self._records(buf, len(seg), tabs, span, 0, 1,
                                         self._t_rec(True, span))
        out = torch.cat([recs[:, 0], toks[:, 0],
                         done.reshape(1).to(torch.int32)]).cpu().numpy()
        if not out[-1]:
            raise RuntimeError("a lane overflowed the full record window, "
                               "which holds every record a lane can emit: "
                               "a fault of the decide or follow kernel")
        t_rec = (len(out) - 1) // 2
        recs, toks = out[:t_rec].astype(np.int64), out[t_rec:-1]
        n_rec = int(((recs & 0xF) != 0).sum())
        return recs[:n_rec] & 0xFFFFFFFF, toks[:n_rec].astype(np.int64)

    def tokenize_staged(self, staged, full: bool = False):
        """Run the device pipeline on a staged text and download the ids.
        Returns (ids u32, missing), or the cause when a dispatch did not
        sync: "window" (a lane overflowed its record window), "junction"
        (an owned junction found no shared state) or "missing_byte" (a kept
        record emits nothing).  A fast-window overflow retries once on the
        full window."""
        if self.tables.match_only:
            raise NotImplementedError(
                "match-only tables (a trainer superset's) have no decide "
                "tables: vocabularies of 2^20 entries or more tokenize on "
                "the host (ROADMAP.md §1 item 14)")
        outs = self._run_staged(staged, full, self.tables, self._compact, {})
        k = len(outs)
        meta = torch.stack([torch.stack([o[j].long() for o in outs])
                            for j in range(1, 6)]).cpu()
        counts, missings, syncs, junctions, dones = meta.numpy()
        if not dones.all():
            if not full:
                return self.tokenize_staged(staged, full=True)
            return "window"
        if not syncs.all():
            return "junction" if not junctions.all() else "missing_byte"
        self.last_mode = "full" if full else "fast"
        words = torch.cat([outs[i][0][:int(counts[i])] for i in range(k)])
        ids = resolve_device(words, self.tables).cpu().numpy()
        return ids.astype(np.uint32), int(missings.sum())

    def tokenize(self, data: bytes):
        """Tokenize normalized+capcoded bytes; returns (ids u32, missing)."""
        if len(data) == 0 or self.vocab.max_token_length == 0:
            return np.zeros(0, np.uint32), 0
        res = self.tokenize_staged(self.stage(data))
        if not isinstance(res, str):
            return res
        if res == "window":
            raise RuntimeError("a lane overflowed the full record window, "
                               "which holds every record a lane can emit: "
                               "a fault of the decide or follow kernel")
        ids, missing = NativeVocab(self.vocab).tokenize(bytes(data))
        if res == "missing_byte" and (missing == 0 or self.tables.has_unk):
            raise RuntimeError("a kept record emitted no token, but the text "
                               "has no byte the vocabulary lacks: a fault of "
                               "the decide or follow kernel")
        self.fallbacks[res] += 1
        self.last_mode = "host"
        _log.warning("device path did not sync for %d bytes (%s); tokenized "
                     "on the host (fallbacks %s)", len(data), res,
                     self.fallbacks)
        return ids, missing
