"""End-to-end device tokenizer: match -> decide -> follow -> stitch/compact.

Port of ``tokenmonster_tpu/ops/scan.py::TpuTokenizer`` on its Pallas
engine (``_pallas_stitch_fn``), without the XLA engines and the host
stitcher.  Text is cut into fixed-geometry dispatches of up to
``MAX_LANES`` speculative chunk lanes; each lane starts at its chunk with
state (start, fd = 0) and scans ``OVERLAP_SCAN`` bytes past its chunk, and
neighbouring lanes splice at their first shared (position, fd) state
(ops/stitch.py).  Dispatches chain through a bridge lane, carrying the
record skip ``start_next`` on the device.  Each dispatch's valid bytes,
last owned lane and final flag sit in one small int32 device array
(``Staged.scalars``), which the kernels and the stitch read on the device,
so the work a dispatch enqueues depends on its geometry alone.

On a card the chain of up to ``MAX_FUSED_DISPATCHES`` dispatches and its
finishing (``ops/finish.py``: the device concat at running offsets, ids
resolved and narrowed, the delete bitmask) is captured once per geometry
(lanes, dispatches, record window) as a CUDA graph and replayed for every
text of that geometry, the counterpart of the JAX package's jitted chain
(``TpuTokenizer._chain_fn``); a longer text replays it group by group,
the record skip carried on the device.  The host reads the metadata of
the whole text in one copy, then downloads the narrowed ids, sized by
the counts, into pinned memory.  CPU tensors take the same chain op by op.

A dispatch that overflows the fast record window retries once with the
full window, which cannot overflow: it holds one record per scanned byte,
two with a delete token (every record advances at least one byte, except
a step from fd 1 to fd 0 in place, which only follows one that advanced).
A junction whose lanes share no state within the overlap (chains that
stay out of phase, as in long runs of one repeated unit, or long tokens
of a large vocabulary) is repaired on the device (``run_repaired``, the
trainer's repair too): the text's own chain is followed on from the last
lane that holds it (``stitch.restart_point``) by one lane of its own,
cut into columns that replace the lanes after it, and the text runs
again; each repair lane spans twice the lanes of the one before.  One
failure is forced by the data and sends the text to the exact native
host tokenizer: a missing byte in a vocabulary without an unk token (a
kept record that emits nothing; the native tokenizer confirms the
missing byte), counted in ``fallbacks`` and logged.  Any other failure
is a kernel fault and raises.
"""

from __future__ import annotations

import logging
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..native import NativeVocab
from . import _build, finish
from .decide import decide
from .follow import follow
from .match import match
from .stitch import device_stitch_compact, restart_point
from .tables import upload_tables

OVERLAP_SCAN = 128  # bytes a lane scans past its chunk end to find sync
MAX_LANES = 512     # lanes per dispatch; longer texts chain dispatches
MARGIN = 512        # real-data lookahead past a dispatch's exact region:
                    # the last lane scans OVERLAP_SCAN bytes past its chunk
                    # end and its matches need up to 2*max_token_length more
GRAIN = 2048        # dispatch buffers round up to the JAX kernels' tile
                    # grain, so each stage sees the N the JAX engine sees
MAX_FUSED_DISPATCHES = 16   # dispatches in one captured graph (the JAX
                            # package's chain length of one jitted call)

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


class Staged(NamedTuple):
    """A text staged on a device (``GpuTokenizer.stage``): its length,
    lanes a dispatch, per dispatch (buffer uint8 [N], valid bytes n, last
    owned lane) with the host's copies of the scalars, the buffers as one
    (k, N) uint8 tensor, and the scalars the device reads: int32 (k, 3)
    rows of (n, last owned lane, 1 for the text's last dispatch else 0)."""
    n: int
    lanes: int
    bufs: list
    text: torch.Tensor
    scalars: torch.Tensor


class _Graph:
    """The captured chain of one geometry: static inputs (text buffers,
    scalars, the record skip into the first dispatch), the graph, its
    outputs, and the launches of each kernel one replay runs."""

    def __init__(self, k: int, width: int, device: torch.device):
        self.text = torch.zeros((k, width), dtype=torch.uint8, device=device)
        self.scalars = torch.zeros((k, 3), dtype=torch.int32, device=device)
        self.start0 = torch.zeros((), dtype=torch.int64, device=device)
        self.graph = None
        self.outputs = None
        self.launches = None

    def load(self, staged: Staged, g0: int, start0) -> None:
        """Copy dispatches [g0, g0 + k) of ``staged`` into the inputs, on
        the current stream; ``start0``: the record skip into the first
        (None: 0)."""
        k = self.text.shape[0]
        self.text.copy_(staged.text[g0:g0 + k])
        self.scalars.copy_(staged.scalars[g0:g0 + k])
        if start0 is None:
            self.start0.zero_()
        else:
            self.start0.copy_(start0)

    def capture(self, body, stream: torch.cuda.Stream) -> None:
        """Warm up ``body(text, scalars, start0)`` once on ``stream`` (what
        runs before a capture, as PyTorch asks: kernel attributes set, the
        library loaded, memory pooled), then capture it there.  The
        warm-up's launches count; the capture's go to ``launches``, which
        each replay counts.  A failed capture raises."""
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body(self.text, self.scalars, self.start0)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # thread_local: a scoring slot's thread may use the card meanwhile
        with _build.tally() as counts, torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            outputs = body(self.text, self.scalars, self.start0)
        self.graph, self.outputs, self.launches = graph, outputs, counts

    def replay(self):
        """Run the captured chain on the current stream; its outputs."""
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.outputs


def _recording(epilogue, grids: list):
    """``epilogue`` that also keeps each dispatch's record grid and record
    skip, (recs, start0), in ``grids``."""
    def recording(recs, toks, buf, start0, last_lane, final):
        grids.append((recs, start0))
        return epilogue(recs, toks, buf, start0, last_lane, final)
    return recording


def _held_flags(meta: np.ndarray) -> np.ndarray:
    """Per dispatch of a (5, k) metadata array (``finish.META_ROWS``),
    whether every lane finished and every junction held: (k, 2) bool."""
    return meta[[4, 3]].T != 0


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
    last call took; ``fallbacks`` counts, by cause (only "missing_byte"
    since junctions are repaired on the device), the texts the device path
    handed to the native tokenizer, and ``host_fallbacks`` is their total;
    ``repairs`` counts the junctions repaired on the device; ``captures``
    the chain geometries captured as CUDA graphs.  ``hashmatch_tables`` (a
    numpy match-table placement of ``vocab``, this package's or the JAX
    package's) shares one placement build; None builds it here."""

    def __init__(self, vocab, chunk: int = 2048, device="cuda",
                 hashmatch_tables=None, match_only: bool = False):
        self.device = device = check_device(device)
        self.vocab = vocab
        self.chunk = chunk
        self.tables = upload_tables(vocab, hashmatch_tables, device=device,
                                    match_only=match_only)
        self.last_mode = None
        self.fallbacks = {"missing_byte": 0}
        self.repairs = 0
        self.wide_ids = len(vocab.reverse) > finish.NARROW_IDS
        self._graphs = {}
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)     # the captures' side stream
        self._lock = threading.Lock()

    @property
    def launches(self) -> dict:
        return dict(_build.launches)

    @property
    def captures(self) -> int:
        return len(self._graphs)

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

    def stage(self, data: bytes, first: int = 0,
              stop: int | None = None) -> Staged:
        """Upload the dispatch buffers and their scalars in one copy from
        pinned memory (host memory on the CPU); returns the ``Staged``
        text ``tokenize_staged`` runs (benchmarks reuse it).  ``first`` and
        ``stop``: stage only those dispatches of the text's plan (a share
        of a long strip scored on several devices); the final flag stays
        the whole text's."""
        n = len(data)
        arr = np.frombuffer(bytes(data), np.uint8)
        L, plan = self._plan(n)
        picked = range(len(plan))[first:stop]
        total = L * self.chunk + MARGIN
        width = -(-(total + 64) // GRAIN) * GRAIN
        k = len(picked)
        cuda = self.device.type == "cuda"
        host = torch.empty(k * width + 12 * k, dtype=torch.uint8,
                           pin_memory=cuda)
        h = host.numpy()
        text = h[:k * width].reshape(k, width)
        scalars = h[k * width:].view(np.int32).reshape(k, 3)
        for r, i in enumerate(picked):
            off, _exact, last_lane = plan[i]
            sl = arr[off:off + total]
            text[r, :len(sl)] = sl
            text[r, len(sl):] = 0
            scalars[r] = (len(sl), last_lane, int(i == len(plan) - 1))
        dev = host.to(self.device, non_blocking=True) if cuda else host
        dtext = dev[:k * width].view(k, width)
        dscalars = dev[k * width:].view(torch.int32).view(k, 3)
        bufs = [(dtext[r], int(scalars[r, 0]), int(scalars[r, 1]))
                for r in range(k)]
        return Staged(n, L, bufs, dtext, dscalars)

    def _compact(self, recs, toks, buf, start0, last_lane, final):
        """The tokenizer's epilogue: (start_next, (out, count, missing,
        sync_ok, junction_ok))."""
        out, count, missing, start_next, sync_ok, junction_ok = (
            device_stitch_compact(recs, toks, start0, last_lane, final,
                                  recs.numel(), self.tables.w3_shift))
        return start_next, (out, count, missing, sync_ok, junction_ok)

    def _records(self, buf, n, tabs, chunk: int, overlap: int,
                 n_lanes: int, t_rec: int):
        """Match, decide and follow on ``tabs``, enqueued: the (recs, toks,
        done_all) of lanes that each scan ``chunk + overlap`` bytes of
        ``buf``, ``n`` of them valid (an int, or a device scalar).  Tables
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
        return follow(ctl, tok, n, chunk, n_lanes, overlap, t_rec,
                      tabs.w3_shift)

    def _dispatch(self, buf, scalars, start0, n_lanes: int, full: bool,
                  tabs, epilogue, patch: dict):
        """One dispatch, enqueued: the records on ``tabs``, the lanes of
        ``patch`` ({lane: (recs, toks) columns}) replaced, then
        ``epilogue``; ``scalars``: its (n, last lane, final) on the device.
        Returns (start_next, (*epilogue outputs, done_all)) as device
        tensors."""
        recs, toks, done_all = self._records(buf, scalars[0], tabs,
                                             self.chunk, OVERLAP_SCAN,
                                             n_lanes, self._t_rec(full))
        for lane, (rec_col, tok_col) in patch.items():
            recs[:, lane] = rec_col
            toks[:, lane] = tok_col
        start_next, out = epilogue(recs, toks, buf, start0, scalars[1],
                                   scalars[2])
        return start_next, (*out, done_all)

    def _chain(self, bufs, scalars, start0, n_lanes: int, full: bool, tabs,
               epilogue, patches: dict):
        """Enqueue dispatches ``bufs`` (their ``scalars`` rows) from the
        record skip ``start0``, ``start_next`` carried as a device tensor;
        no host sync.  Returns (per dispatch the epilogue's outputs and the
        follow's done flag, the last dispatch's start_next)."""
        outs = []
        for i, buf in enumerate(bufs):
            start0, out = self._dispatch(buf, scalars[i], start0, n_lanes,
                                         full, tabs, epilogue,
                                         patches.get(i, {}))
            outs.append(out)
        return outs, start0

    def _run_staged(self, staged: Staged, full: bool, tabs, epilogue,
                    patches: dict):
        """Enqueue every dispatch of a staged text op by op, no host sync.
        ``tabs`` and ``epilogue``: this tokenizer's tables and
        ``_compact``, or a candidate's tables and the trainer's score
        epilogue; ``patches``: {dispatch: {lane: columns}} of lanes to
        replace (the junction repair).  Returns per dispatch the
        epilogue's outputs and the follow's done flag."""
        start0 = torch.zeros((), dtype=torch.int64, device=self.device)
        return self._chain([b[0] for b in staged.bufs], staged.scalars,
                           start0, staged.lanes, full, tabs, epilogue,
                           patches)[0]

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

    def _repair_columns(self, tabs, data: bytes, off: int, g: int, at: int,
                       k: int, t_rec: int):
        """Columns of the text's chain from state (``at``, fd 0) for lanes
        g+1 .. g+k of the dispatch at ``off``, positions in that dispatch:
        lane g+1 gets the chain up to its own scan end, each later lane the
        records past its start up to its scan end, as a lane's own scan
        would reach: through the first record at or past that end.  So each
        column's first record is a state of the lane before it, and the
        splices hold.  {lane: (recs, toks)} int32 columns of ``t_rec``
        rows, or None where a column holds more records than ``t_rec``."""
        chunk = self.chunk
        end = (g + k + 1) * chunk + OVERLAP_SCAN    # lane g+k's scan end
        recs, toks = self.chain(tabs, data, off + at, end - at)
        pos = (recs >> 4) + at
        recs = (pos << 4) | (recs & 0xF)
        cols = {}
        for lane in range(g + 1, g + k + 1):
            last = np.searchsorted(pos, (lane + 1) * chunk + OVERLAP_SCAN)
            sel = np.arange(len(pos)) <= last
            if lane > g + 1:
                sel &= pos > lane * chunk
            if sel.sum() > t_rec:
                return None
            col = np.zeros((2, t_rec), np.int64)
            col[0, :sel.sum()], col[1, :sel.sum()] = recs[sel], toks[sel]
            col = torch.from_numpy(col.astype(np.int32)).to(self.device)
            cols[lane] = (col[0], col[1])
        return cols

    def run_recorded(self, staged: Staged, full: bool, tabs, epilogue,
                     patches: dict):
        """``_run_staged`` that also keeps each dispatch's record grid:
        (outs, grids), grids per dispatch (recs, start0), what
        ``restart_point`` reads where a junction did not hold."""
        grids = []
        return self._run_staged(staged, full, tabs,
                                _recording(epilogue, grids), patches), grids

    def run_repaired(self, staged, data: bytes, tabs, epilogue, held, flags,
                     grids):
        """Run the whole text ``data`` (``staged``) again until every
        dispatch holds: on the full record window where a lane overflowed,
        with repair lanes where a junction's lanes share no state.
        ``held(outs)``: per dispatch, whether every lane finished and
        whether every junction held, a (dispatches, 2) bool array on the
        host.  ``flags`` and ``grids``: ``held`` and the grids of a first
        pass, run by ``run_recorded`` on the fast window with no patches,
        that did not hold; the repair starts from them.  Returns (outs,
        whether the full window was used, repairs made)."""
        L, bufs = staged.lanes, staged.bufs
        plan = self._plan(len(data))[1]
        if len(plan) != len(bufs):
            raise ValueError("run_repaired takes a whole text's staging")
        full, patches, repairs, last = False, {}, 0, (-1, -1)
        while True:
            if not flags[:, 0].all():
                if full:
                    raise RuntimeError("a lane overflowed the full record "
                                       "window, which holds every record a "
                                       "lane can emit: a fault of the "
                                       "decide or follow kernel")
                full, patches, repairs, last = True, {}, 0, (-1, -1)
            else:
                d = int(np.nonzero(~flags[:, 1])[0][0])
                last_lane, final = bufs[d][2], d == len(bufs) - 1
                g, at, j = restart_point(*grids[d], last_lane, final)
                if (d, j) <= last:
                    raise RuntimeError(f"a repaired junction (dispatch {d}, "
                                       f"lane {j}) did not hold: a fault of "
                                       "the repair")
                last = (d, j)
                # the columns reach past junction j, so it holds after this
                # repair
                k = min((last_lane if final else L - 1) - g,
                        max(1 << repairs, j + 1 - g))
                cols = self._repair_columns(tabs, data, plan[d][0], g, at, k,
                                            self._t_rec(full))
                if cols is None:       # dense text: the full window holds it
                    if full:
                        raise RuntimeError("a repair column holds more "
                                           "records than the full record "
                                           "window")
                    full, patches, repairs, last = True, {}, 0, (-1, -1)
                else:
                    for lane, (rec_col, tok_col) in cols.items():
                        patches.setdefault(d, {})[lane] = (rec_col, tok_col)
                        if lane == L - 1 and not final:
                            # the bridge lane is the next dispatch's lane 0
                            shift = (plan[d + 1][0] - plan[d][0]) << 4
                            rec_col = torch.where(rec_col != 0,
                                                  rec_col - shift, 0)
                            patches.setdefault(d + 1, {})[0] = (rec_col,
                                                                tok_col)
                    repairs += 1
            outs, grids = self.run_recorded(staged, full, tabs, epilogue,
                                            patches)
            flags = held(outs)
            if flags.all():
                return outs, full, repairs

    def _graph(self, staged: Staged, g0: int, k: int, start0):
        """The captured chain of ``k`` dispatches at ``staged``'s geometry
        (fast record window), its inputs loaded from dispatch ``g0`` on;
        captured here at its geometry's first use."""
        key = (staged.lanes, k, False)
        graph = self._graphs.get(key)
        fresh = graph is None
        if fresh:
            graph = _Graph(k, staged.text.shape[1], self.device)
        graph.load(staged, g0, start0)
        if fresh:
            lanes = staged.lanes

            def body(text, scalars, s0):
                grids = []
                outs, start_next = self._chain(
                    list(text), scalars, s0, lanes, False, self.tables,
                    _recording(self._compact, grids), {})
                return (*finish.finish(outs, self.tables, self.wide_ids),
                        grids, start_next)
            graph.capture(body, self._stream)
            self._graphs[key] = graph
        return graph

    def _run_captured(self, staged: Staged):
        """The text's chain as replays of captured graphs, groups of up to
        ``MAX_FUSED_DISPATCHES`` dispatches, the record skip carried on the
        device from one group to the next.  Returns (meta (5, k) int32,
        [(ids, delete bits, dispatches)] a group, grids)."""
        k = len(staged.bufs)
        metas, parts, grids, start0 = [], [], [], None
        index = self.device.index    # None: the current device, as is
        with torch.cuda.device(-1 if index is None else index):
            for g0 in range(0, k, MAX_FUSED_DISPATCHES):
                kg = min(MAX_FUSED_DISPATCHES, k - g0)
                meta, ids, bits, gr, start0 = self._graph(
                    staged, g0, kg, start0).replay()
                if g0 + kg < k:     # a later group may replay this graph
                    meta, ids, start0 = meta.clone(), ids.clone(), \
                        start0.clone()
                    bits = None if bits is None else bits.clone()
                    gr = [(r.clone(), s.clone()) for r, s in gr]
                metas.append(meta)
                parts.append((ids, bits, kg))
                grids += gr
        return torch.cat(metas, 1), parts, grids

    def _run_eager(self, staged: Staged):
        """``_run_captured``'s results from the chain enqueued op by op."""
        outs, grids = self.run_recorded(staged, False, self.tables,
                                        self._compact, {})
        meta, ids, bits = finish.finish(outs, self.tables, self.wide_ids)
        return meta, [(ids, bits, len(outs))], grids

    def _read(self, tensors) -> list:
        """Device tensors as numpy arrays: on a card, copied into pinned
        memory and waited for together."""
        if self.device.type == "cpu":
            return [t.numpy() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return [h.numpy() for h in host]

    def _held(self, outs) -> np.ndarray:
        """Per dispatch of ``outs``, whether every lane finished and every
        junction held: (dispatches, 2) bool on the host."""
        return _held_flags(self._read([finish.meta(outs)])[0])

    def _download(self, parts, counts) -> np.ndarray:
        """The u32 ids of ``parts`` (``_run_captured``'s), each group's
        narrowed ids and bitmask read as far as its counts reach."""
        want, totals, at = [], [], 0
        for ids, bits, kg in parts:
            total = int(counts[at:at + kg].sum())
            at += kg
            totals.append(total)
            want.append(ids[:total * (3 if self.wide_ids else 1)])
            if bits is not None:
                want.append(bits[:-(-total // 8)])
        got = iter(self._read(want))
        out = [finish.host_ids(next(got), next(got) if bits is not None
                               else None, total, self.tables.delete_token)
               for (_ids, bits, _kg), total in zip(parts, totals)]
        return out[0] if len(out) == 1 else np.concatenate(out)

    def tokenize_staged(self, staged: Staged, data: bytes):
        """Run the device pipeline on ``data`` staged (``stage(data)``) and
        download the ids.  On a card the chain and its finishing replay
        captured graphs (``_run_captured``); on the CPU they run op by op
        (``_run_eager``, the same chain enqueued from Python).  One read of
        the whole text's metadata, then the narrowed ids.  Returns (ids
        u32, missing), or "missing_byte" where
        a kept record emits nothing.  A dispatch that did not hold runs
        again, op by op, through ``run_repaired``: on the full record window
        where a lane overflowed, with junctions repaired (counted in
        ``repairs``) where lanes share no state."""
        if self.tables.match_only:
            raise NotImplementedError(
                "match-only tables (a trainer superset's) have no decide "
                "tables: a tokenizer uploads the vocabulary's whole tables "
                "(match_only=False)")
        with self._lock:
            run = (self._run_eager if self.device.type == "cpu"
                   else self._run_captured)
            meta_dev, parts, grids = run(staged)
            meta = self._read([meta_dev])[0]
            flags, full = _held_flags(meta), False
            if not flags.all():
                outs, full, repairs = self.run_repaired(
                    staged, data, self.tables, self._compact, self._held,
                    flags, grids)
                self.repairs += repairs
                meta_dev, ids, bits = finish.finish(outs, self.tables,
                                                    self.wide_ids)
                parts = [(ids, bits, len(outs))]
                meta = self._read([meta_dev])[0]
            del grids
            counts, missings, syncs = meta[0], meta[1], meta[2]
            if not syncs.all():
                return "missing_byte"
            self.last_mode = "full" if full else "fast"
            return self._download(parts, counts), int(missings.sum())

    def tokenize(self, data: bytes):
        """Tokenize normalized+capcoded bytes; returns (ids u32, missing)."""
        if len(data) == 0 or self.vocab.max_token_length == 0:
            return np.zeros(0, np.uint32), 0
        res = self.tokenize_staged(self.stage(data), data)
        if not isinstance(res, str):
            return res
        ids, missing = NativeVocab(self.vocab).tokenize(bytes(data))
        if missing == 0 or self.tables.has_unk:
            raise RuntimeError("a kept record emitted no token, but the text "
                               "has no byte the vocabulary lacks: a fault of "
                               "the decide or follow kernel")
        self.fallbacks[res] += 1
        self.last_mode = "host"
        _log.warning("device path did not sync for %d bytes (%s); tokenized "
                     "on the host (fallbacks %s)", len(data), res,
                     self.fallbacks)
        return ids, missing
