#!/usr/bin/env python3
"""Smoke run of tokenmonster_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/, holds each against its plain PyTorch
version at the main path's shapes (realtext-32000, chunk 2048, 512 lanes,
two forward-delete rows; a capcode-0 vocabulary for the one-row match and
decide), drives the main path ``load(vocab, device="cuda").tokenize(text)``
over at least 4 MiB of real text and a mixed batch, checks the ids against
the native host tokenizer, shows the counted host fallback, and times each
kernel beside its plain version and an empty kernel (the launch floor),
launched back to back from the host (``ms``) and queued behind a spin (the
card alone, ``device_ms``), then the staged device chain, the end-to-end
call and the native tokenizer; then the chain as the tokenizer runs it,
captured as CUDA graphs, against the same chain enqueued op by op, in
turns (ids, launches, captures, chain, enqueue, metadata read, download
and e2e times), here and at both pool-scale tokenizers.

The trainer phase distils a getalltokens pool of 8 MiB of real text toward
32,000 ids in the trainer's REMAP mode (match on a candidate's masked
superset tables, each match word mapped to the candidate's index, decide
and follow on candidate-sized tables): the kernels against their plain
versions, ``GpuCandidateScorer.score`` against the native scorer on the
whole text, the junction repair on a forced run, and two seeded rounds
of the port's ``train_vocab`` on the card against its native backend
(every scored candidate, the deletions of each round, the files
written), with times.  Then the cell's next candidate on its own tables
(a placement of its own, full tables): scored by a scorer never
prepared, and with a token the superset lacks and with an unk token by
the prepared one, on one slot and on two, against native and REMAP mode,
with its kernels against their plain versions.  Then the trainer's score
chain as the JAX package runs it (16 strips a device call, one replay of
a captured graph a batch, one read-back a candidate) against the same
batches op by op, in turns: 20 strips of 72 KB a candidate and the full
text, every score equal to native on both paths, launches equal, the
captures no more than the keys, with enqueue, score and call times (at
reference scale too, on its 100 strips).  Then getalltokens of
that configuration with ``TM_GAT_DEVICE=1`` (the window sort on the card;
the ``.tok`` byte for byte the host sort's; each micro-chunk's sort timed
against the native sort in turns), and the same two rounds with the scorer over two slots of
the card and as two gloo processes on it (rounds, files and every
candidate's scores equal; every trainer kernel launched in each
process).  The reference-scale phase does the same as the trainer phase,
for one round, on a pool whose superset holds more than 2^20 entries;
then that superset vocabulary tokenizes the whole text with the wide
token word (S = 21) through ``GpuTokenizer`` and through ``load(...)`` of
its saved ``.vocab`` ("device" and "auto" routes), against native, each
kernel against its plain version at S = 21, with times, and the
vocabulary scored as a trainer candidate on its tokenizer's tables
against ``tm_tokenize_score``.  Then the same for a pool of the same
text, counted once with it, whose superset holds 2^21 - 1 entries or
more: 22-bit placement index fields, token words at S = 22 (follow's u64
tile word timed against the u32 word).  The pipeline
phase runs
getalltokens, trainvocab (cuda against native) and exportvocab from the
shell, then serves the exported vocabulary through ``load(...,
device="cuda")`` and ``load_multiprocess_safe`` (its server on the
card).

Phases print as they go; any failure raises and exits non-zero.  The line
before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository around it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

VOCAB = os.path.join("examples", "realtext-32000-fast.vocab")
CHUNK, LANES = 2048, 512
MAIN_BYTES = 4 << 20          # raw text bytes of the main-path run
REPEAT = 5                    # timings are the median of this many runs
TPU_KERNELS = {               # the Pallas kernel each CUDA kernel replaces
    "match": "tokenmonster_tpu/ops/pallas_match.py:136",
    "decide": "tokenmonster_tpu/ops/pallas_decide.py:83",
    "follow": "tokenmonster_tpu/ops/pallas_follow.py:45",
    "compact": "tokenmonster_tpu/ops/pallas_stitch.py:34",
}
SOURCE = "tokenmonster_tpu_torch/csrc/tm_kernels.cu"
TRAIN_BYTES = 8 << 20         # raw text the trainer phase distils
TRAIN_MIN_OCCUR = 57          # getalltokens min_occur_total: the source's
                              # pool of about 60k, kept above twice the
                              # vocab (64,000) so the rounds distil: 57
                              # gives 65,839 on this text, 60 gave 63,064
TRAIN_POOL = (60_000, 120_000)
TRAIN_VOCAB = 32000
TRAIN_ROUNDS = 2
TRAIN_SEED = 7
TRAIN_KERNELS = ("match", "decide", "follow")
BIG_BYTES = 15 << 20          # the reference-scale pool's text: all the
                              # library holds (10.7 MB on the H100's host;
                              # the source run: 100 MB)
BIG_MIN_OCCUR = 7             # lowered from the source's 60 so that this
                              # text's superset passes BIG_ENTRIES: 10 gave
                              # a pool of 495,183 and 750,243 entries, 6
                              # gave 911,989 and 1,394,357 (the source:
                              # 803,091 and 1,212,993)
BIG_ENTRIES = 1 << 20         # the superset must hold more entries
BIG_CANDIDATES = 3
BIG_ROUNDS = 1
WIDER_MIN_OCCUR = 4           # the largest min occur at which the same
                              # text's superset holds WIDER_ENTRIES: 5
                              # gave a pool of 1,133,169 and 1,738,440
                              # entries, 4 gave 1,605,260 and 2,475,011
WIDER_ENTRIES = (1 << 21) - 1  # at least: 22-bit placement fields
WIDER_CANDIDATES = 1
WIDER_ROUNDS = 1
CLI_ROUNDS = 2
ROOT = os.path.dirname(os.path.abspath(__file__))
# The least time the card could take for a kernel's work: its bytes (each
# input read once, each output written once) over HBM3's 3.35 TB/s
# (NVIDIA's data sheet for the H100 SXM), or its 32-bit integer operations
# over the card's integer rate, whichever is larger.  That rate is 64
# results per clock and SM for 32-bit integer add, multiply-add, shift and
# logic at compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), times 132 SMs at the 1.98 GHz boost clock.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 64 * 132 * 1.98e9
LIBRARY = {                   # why no single PyTorch call computes it
    "match": "no PyTorch op finds longest dictionary matches",
    "decide": "no PyTorch op scores the ungreedy branches",
    "follow": "a serial chain per lane; no PyTorch op follows one",
    "compact": "a segmented gather of kept ranges; no one PyTorch op",
}


CAPTURED = {}                 # the captured-chain phase's numbers, a cell
HOLD_CYCLES = 4_000_000       # about 2 ms at the card's clock: the host
                              # queues 10 launches in well under that
T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def require_self_contained(what: str) -> None:
    """Fail if jax or any module of the JAX package ``tokenmonster_tpu``
    was imported: the port stands alone."""
    require("jax" not in sys.modules, f"{what} imported jax")
    bad = sorted(m for m in sys.modules if m == "tokenmonster_tpu"
                 or m.startswith("tokenmonster_tpu."))
    require(not bad, f"{what} imported the JAX package: {bad}")


def fnv1a64(ids) -> int:
    """FNV-1a over the little-endian u32 id stream."""
    h = 0xCBF29CE484222325
    for b in np.asarray(ids, np.uint32).astype("<u4").tobytes():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def cuda_ms(fn, repeat: int = REPEAT, calls: int = 10,
            queued: bool = False) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``calls``
    back-to-back calls, median of ``repeat`` such runs, after one warm-up
    call.  A call shorter than its host-side launch cost measures that
    cost: what a caller sees who launches from the host as fast as it can.
    ``queued``: a kernel that spins for HOLD_CYCLES holds the stream while
    the host queues every call behind it, so the events time the card
    alone, the gaps between its launches included."""
    from tokenmonster_tpu_torch.ops import _build
    dev = torch.device("cuda", torch.cuda.current_device())
    fn()
    times = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            _build.spin(dev, HOLD_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_seconds(fn, repeat: int = REPEAT) -> float:
    """Median wall seconds of ``fn`` ending in a card synchronise."""
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape, f"shape {tuple(g.shape)} vs "
                                    f"{tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def bound(nbytes: int, ops: int):
    """(ms, "bytes" or "operations"): the least time for this work."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def match_work(buf, n: int, tabs):
    """(bytes, operations) of one match call: the text, every match table
    and the words written; three operations (multiply-add, shift, xor) per
    window hashed, each position hashing up to max_len windows that end by
    n."""
    L = tabs.max_len
    hashed = (n - L + 1) * L + L * (L - 1) // 2 if n >= L else n * (n + 1) // 2
    tables = nbytes(tabs.fields, tabs.disp, tabs.single, tabs.space_single,
                    tabs.scalars, tabs.desc, tabs.len_cls, tabs.ovf_keys)
    out = 4 * buf.numel() * (2 if tabs.has_space else 1)
    return buf.numel() + tables + out, 3 * hashed


def decide_work(m, mb, buf, tabs):
    """The match words, text and meta planes read (what the function
    needs: the kernel's own table, derived from the planes and larger, is
    a cost of its design), the ctl and tok words written; about 60
    operations per branch score set (6 branches of about 10) per position
    and row."""
    rows = 2 if mb is not None else 1
    ins = nbytes(m, buf, tabs.meta, tabs.bb) + (nbytes(mb) if rows > 1
                                                else 0)
    return ins + 2 * 4 * rows * buf.numel(), 60 * rows * buf.numel()


def follow_work(recs):
    """The ctl and tok words of each step taken (this run's steps: its
    nonzero records), the records and token words written; about 10
    operations a step."""
    steps = int((recs != 0).sum())
    return 8 * steps + 2 * nbytes(recs), 10 * steps


def compact_work(kept: int, lanes: int, out_len: int):
    """The kept records and token words read, the lanes' ranges, every
    word of the output written (the kept words and the zeros); two
    operations a kept word."""
    return 8 * kept + 12 * lanes + 4 * out_len, 2 * kept


def smem_plan(buf, n: int, tabs, lanes: int, chunk: int, t_rec: int) -> str:
    """How the match, decide and follow kernels use shared memory at these
    shapes, as their launchers plan it on this card."""
    import ctypes

    from tokenmonster_tpu_torch.ops import _build
    from tokenmonster_tpu_torch.ops.follow import window
    from tokenmonster_tpu_torch.ops.match import match_args
    lib = _build.load_library()
    args = match_args(buf, n, tabs, buf, buf)     # the plan reads no output
    disp = ctypes.c_int(0)
    m_bytes = lib.tm_match_smem(ctypes.byref(args), ctypes.byref(disp))
    fa = _build.FollowArgs(N=buf.numel(), rows=2 if tabs.has_delete else 1,
                           n=n, chunk=chunk, overlap=128,
                           W=window(chunk, 128), L=lanes, t_rec=t_rec)
    tile = lib.tm_follow_tile(ctypes.byref(fa))
    d_bytes = ctypes.c_int(0)
    d_tile = lib.tm_decide_tile(ctypes.byref(d_bytes))
    d_regs = ctypes.c_int(0)
    d_blocks = lib.tm_decide_occupancy(ctypes.byref(d_regs))
    where = "shared" if disp.value else "global"
    return (f"match {m_bytes} B per block, displacements "
            f"({nbytes(tabs.disp)} B) in {where} memory, key filter "
            f"{1 << tabs.filt_log2} bits; decide {d_bytes.value} B per "
            f"block: one 8-byte pair for each of a tile's {d_tile} positions "
            f"and the 128 after it, the per-token entries "
            f"({nbytes(tabs.entries)} B) gathered from global memory once "
            f"per position and fd row, "
            f"{d_regs.value} registers a thread, {d_blocks} blocks of 256 "
            f"threads an SM; "
            f"follow tile {tile} of the {fa.W}-position window per lane "
            f"and row")


def stage_pairs(vocab, raw: bytes, device, downstream: bool):
    """One main-path dispatch (512 lanes of 2048 bytes) of real text and,
    for each kernel on its path, (kernel call, plain call) closures on the
    same inputs, and its (bytes, operations).  ``downstream`` adds follow
    and compact, which need the dispatch to sync."""
    from tokenmonster_tpu_torch.corpus import main_dispatch
    tk, buf, n = main_dispatch(vocab, raw, device, CHUNK, LANES)
    return dispatch_pairs(tk, buf, n, downstream)


def dispatch_pairs(tk, buf, n: int, downstream: bool):
    """``stage_pairs`` on a dispatch ``tk`` staged: its buffer and valid
    bytes."""
    from tokenmonster_tpu_torch.ops import stitch
    from tokenmonster_tpu_torch.ops.decide import decide, decide_plain
    from tokenmonster_tpu_torch.ops.follow import follow, follow_plain
    from tokenmonster_tpu_torch.ops.match import match, match_plain
    from tokenmonster_tpu_torch.ops.scan import OVERLAP_SCAN
    tabs = tk.tables
    S = tabs.w3_shift
    mm = match(buf, n, tabs)
    m, mb = mm if tabs.has_space else (mm, None)
    pairs = {
        "match": (lambda: match(buf, n, tabs),
                  lambda: match_plain(buf, n, tabs)),
        "decide": (lambda: decide(m, mb, buf, n, tabs),
                   lambda: decide_plain(m, mb, buf, n, tabs)),
    }
    work = {"match": match_work(buf, n, tabs),
            "decide": decide_work(m, mb, buf, tabs)}
    if not downstream:
        return buf.numel(), pairs, work, None
    ctl, tok = decide(m, mb, buf, n, tabs)
    t_rec = tk._t_rec(False)
    recs, toks, done = follow(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec,
                              S)
    require(int(done) == 1, "main-path dispatch overflowed its window")
    _f, keep, _sn, ok, s, e = stitch.stitched_keep(recs, 0, LANES - 2, False)
    require(bool(ok), "main-path dispatch did not sync")
    counts = keep.sum(0)
    q = (counts.cumsum(0) - counts - s).to(torch.int32)
    s, e = s.to(torch.int32), e.clamp(max=t_rec - 1).to(torch.int32)
    cap = t_rec * LANES
    pairs["follow"] = (
        lambda: follow(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec, S),
        lambda: follow_plain(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec,
                             S))
    pairs["compact"] = (
        lambda: stitch.compact(recs, toks, s, e, q, cap, S),
        lambda: stitch.compact_plain(recs, toks, s, e, q, cap, S))
    work["follow"] = follow_work(recs)
    work["compact"] = compact_work(int(counts.sum()), LANES, cap)
    return (buf.numel(), pairs, work,
            smem_plan(buf, n, tabs, LANES, CHUNK, t_rec))


def compare(pairs, name: str) -> int:
    """max_abs_err of the kernel against its plain version."""
    kernel, plain = pairs[name]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    return max_abs_err(got, want)


class _RoundLog(logging.Handler):
    """The master loop's "round N: deleted K; ..." lines."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("round "):
            self.lines.append(msg)


def _train(run, log: _RoundLog):
    """(round lines, wall seconds) of one training run."""
    log.lines = []
    t0 = time.perf_counter()
    run()
    return list(log.lines), time.perf_counter() - t0


def _dir_bytes(path) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def trainer_inputs(dev, card: str, work: str):
    """The trainer phase's inputs: a getalltokens pool of TRAIN_BYTES of
    standard-library text written to ``work``/pool.tok, its normalized
    text, a ``GpuCandidateScorer`` armed on its superset, the first
    dispatch of that text staged for it, and ``candidate()``, which makes
    the next candidate as the master loop makes them: the singles, then a
    seeded shuffle of the tokens cut to the effective vocab size."""
    import random
    from types import SimpleNamespace

    from tokenmonster_tpu_torch.core import capcode as cc
    from tokenmonster_tpu_torch.core.normalize import Normalizer
    from tokenmonster_tpu_torch.core.vocab import normalize_and_capcode
    from tokenmonster_tpu_torch.corpus import stdlib_text
    from tokenmonster_tpu_torch.ops.scan import MARGIN
    from tokenmonster_tpu_torch.train import trainvocab as port
    from tokenmonster_tpu_torch.train.getalltokens import (get_all_tokens,
                                                           load_tokens_file,
                                                           save_tokens_file)

    raw, _dropped = stdlib_text(None, TRAIN_BYTES)
    t0 = time.perf_counter()
    counter, char_table, header = get_all_tokens(
        raw, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=TRAIN_MIN_OCCUR)
    gat_s = time.perf_counter() - t0
    print(f"pool: {len(counter)} candidates from {len(raw)} bytes of "
          f"standard-library text (balanced, capcode 2, nfd, min occur "
          f"{TRAIN_MIN_OCCUR}) in {gat_s:.1f} s (host sort)")
    require(TRAIN_POOL[0] <= len(counter) <= TRAIN_POOL[1],
            f"pool of {len(counter)} outside {TRAIN_POOL}")
    tok_path = os.path.join(work, "pool.tok")
    save_tokens_file(tok_path, counter, char_table, header)
    dic = load_tokens_file(tok_path)
    capcode, norm_flag = dic["using_capcode"], dic["norm_flag"]
    text = normalize_and_capcode(raw, capcode, Normalizer(norm_flag))

    pool = port.superset_pool(tok_path)
    sc = port.GpuCandidateScorer(dic["charset"], capcode, norm_flag,
                                 device=dev)
    sc.set_specials([])
    t0 = time.perf_counter()
    sc.prepare(pool)
    torch.cuda.synchronize()
    arm_s = time.perf_counter() - t0
    print(f"superset: {len(sc._sup.vocab.tokens)} entries from a pool of "
          f"{len(pool)} tokens, armed (vocabulary, CHD placement, "
          f"upload) in {arm_s:.3f} s [{card}]")

    singles = sorted({t for t in dic["tokens"] if len(t) == 1}
                     | {bytes([b]) for b in (cc.DELETE_TOKEN,
                                             cc.CHARACTER_TOKEN,
                                             cc.WORD_TOKEN)})
    multi = [t for t in pool if len(t) > 1]
    rng = random.Random(TRAIN_SEED)

    def candidate():
        rng.shuffle(multi)
        return sc.build(singles + multi[:TRAIN_VOCAB - len(singles)])

    tk = sc._sup.tokenizer
    staged = tk.stage(text[:(LANES - 1) * tk.chunk + MARGIN])
    lanes, bufs = staged.lanes, staged.bufs
    require(lanes == LANES, f"{lanes} lanes staged")
    buf, n, _last = bufs[0]
    return SimpleNamespace(raw=raw, tok_path=tok_path, norm_flag=norm_flag,
                           text=text, sc=sc, tk=tk, buf=buf, n=n,
                           t_rec=tk._t_rec(False), candidate=candidate,
                           gat_s=gat_s)


def gather_work(buf, n: int, tabs):
    """REMAP mode's rank gather of a dispatch's match words (between match
    and decide; torch ops, not a kernel) on a candidate's tables: its
    closure and its (bytes, operations).  It reads both words and the rank
    table and writes two words, about four operations a word."""
    from tokenmonster_tpu_torch.ops.match import match
    from tokenmonster_tpu_torch.ops.scan import remap_matches
    m, mb = match(buf, n, tabs)

    def gather():
        return remap_matches(m, tabs.rank), remap_matches(mb, tabs.rank)
    return gather, (nbytes(m, mb, tabs.rank) + 2 * nbytes(m), 8 * m.numel())


def masked_pairs(t, tabs):
    """(kernel, plain) closures of the trainer's kernels on one
    candidate's tables and ``trainer_inputs`` ``t``'s dispatch, on the
    same inputs, and each one's (bytes, operations).  Decide is given the
    match words mapped to the candidate's indices (REMAP mode)."""
    from tokenmonster_tpu_torch.ops.decide import decide, decide_plain
    from tokenmonster_tpu_torch.ops.follow import follow, follow_plain
    from tokenmonster_tpu_torch.ops.match import match, match_plain
    from tokenmonster_tpu_torch.ops.scan import OVERLAP_SCAN, remap_matches
    buf, n, chunk, t_rec = t.buf, t.n, t.tk.chunk, t.t_rec
    m, mb = match(buf, n, tabs)
    m, mb = remap_matches(m, tabs.rank), remap_matches(mb, tabs.rank)
    ctl, tok = decide(m, mb, buf, n, tabs)
    recs = follow(ctl, tok, n, chunk, LANES, OVERLAP_SCAN, t_rec)[0]
    pairs = {
        "match": (lambda: match(buf, n, tabs),
                  lambda: match_plain(buf, n, tabs)),
        "decide": (lambda: decide(m, mb, buf, n, tabs),
                   lambda: decide_plain(m, mb, buf, n, tabs)),
        "follow": (lambda: follow(ctl, tok, n, chunk, LANES,
                                  OVERLAP_SCAN, t_rec)[:2],
                   lambda: follow_plain(ctl, tok, n, chunk, LANES,
                                        OVERLAP_SCAN, t_rec)[:2]),
    }
    counts = {"match": match_work(buf, n, tabs),
              "decide": decide_work(m, mb, buf, tabs),
              "follow": follow_work(recs)}
    return pairs, counts


def _cand_key(cand) -> str:
    """A candidate's identity across processes: the hash of its tokens."""
    return hashlib.sha1(b"\0".join(bytes(t) for t in cand.tokens)).hexdigest()


def port_native_score(cand, datasets):
    """The native trainer scorer (``tm_tokenize_score``): the port's
    ``CandidateScorer(backend="native").score``."""
    from tokenmonster_tpu_torch.train import trainvocab as port
    return port.CandidateScorer(cand.charset, cand.using_capcode,
                               cand.normalizer.flag).score(cand, datasets)


def worker_strips(text: bytes, seed: int) -> list:
    """A worker's strips of ``text`` as ``train_vocab`` cuts them at its
    defaults (15% of the text in 20 strips below 10 MB, else 100), from a
    seeded first offset."""
    import random
    n = len(text)
    count = 20 if n < 10 * 1024 * 1024 else 100
    per = n * 15 // 100 // count
    per += 4 - per % 4
    offset = n // count
    frm = random.Random(seed).randrange(max(1, offset))
    strips = []
    for _ in range(count):
        if frm + per > n:
            frm = frm + per - n
        strips.append(text[frm:frm + per])
        frm += offset
    return strips


def score_chain_phase(card: str, key: str, sc, cells: dict, candidate,
                      native_score, rounds: str, candidates: int = 2) -> dict:
    """The trainer's score chain as the JAX package runs it against the
    same batches op by op, on the prepared scorer ``sc`` (no new arm):
    for each cell of ``cells`` (name -> strips), ``candidates`` seeded
    candidates (``candidate()``) scored through ``sc.score`` with every
    batch a replay of its captured graph, and with ``_run_captured``
    replaced by ``_run_eager``, in turns after one captured warm-up.
    Each score equals native's (scores, token count, missing set) on
    both paths, launches per kernel a candidate are equal, the captured
    path replays once a batch and reads back once a candidate, and the
    captures are no more than the keys the cells use.  Prints per
    candidate the enqueue, score and call ms of each path, replays,
    read-backs and launches; ``rounds``: the cell's round times, cuda
    against native.  Returns, per kernel, its launches a candidate on
    the captured path, by cell."""
    from contextlib import ExitStack
    from unittest import mock

    from tokenmonster_tpu_torch.ops import _build, scan, tables
    from tokenmonster_tpu_torch.parallel import score as pscore
    from tokenmonster_tpu_torch.train import trainvocab as port

    t_phase = time.perf_counter()
    tk = sc._sup.tokenizer
    before = set(tk._graphs)
    eager0 = dict(sc.eager_scores)
    keys, out = set(), {}

    def batch_keys(cand, strips):
        strips = [d for d in strips if len(d)]
        B = pscore.batch_size(len(strips))
        cap = pscore.ids_cap(max(len(tk.vocab.reverse), len(cand.reverse)))
        width = tables.bucket_width(len(cand.tokens))
        got = set()
        for g in range(0, len(strips), B):
            plans = [tk._plan(len(d)) for d in strips[g:g + B]]
            got.add(("score", max(p[0] for p in plans),
                     max(len(p[1]) for p in plans), B, width, cap))
        return got

    def run(cand, strips, name: str) -> dict:
        """One ``sc.score`` call on ``name``'s path, its steps timed and
        its replays, read-backs and launches counted."""
        seen = {"enqueue": 0.0, "score": 0.0, "replays": 0, "reads": 0}
        real_run = (pscore._run_eager if name == "eager"
                    else pscore._run_captured)
        real_whole, real_replay = port.score_whole, scan._Graph.replay
        real_cpu = torch.Tensor.cpu

        def enqueue(*args):
            t0 = time.perf_counter()
            res = real_run(*args)
            seen["enqueue"] += time.perf_counter() - t0
            return res

        def whole(*args):
            t0 = time.perf_counter()
            res = real_whole(*args)
            seen["score"] += time.perf_counter() - t0
            return res

        def replay(graph):
            seen["replays"] += 1
            return real_replay(graph)

        def cpu(t, *args, **kw):
            seen["reads"] += t.is_cuda
            return real_cpu(t, *args, **kw)

        with ExitStack() as stack:
            for obj, attr, fn in ((pscore, "_run_captured", enqueue),
                                  (port, "score_whole", whole),
                                  (scan._Graph, "replay", replay),
                                  (torch.Tensor, "cpu", cpu)):
                stack.enter_context(mock.patch.object(obj, attr, fn))
            _build.reset_launches()
            t0 = time.perf_counter()
            got = sc.score(cand, strips)
            seen["call"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            seen["launches"] = dict(_build.launches)
        seen["got"] = got
        return seen

    for cell, strips in cells.items():
        cands = [candidate() for _ in range(candidates)]
        wants = [native_score(cand, strips) for cand in cands]
        warm = sc.score(cands[0], strips)        # captures the cell's keys
        require(np.array_equal(warm[0], wants[0][0])
                and warm[1:] == wants[0][1:],
                f"{key} {cell}: the warm-up call differs from native")
        for cand in cands:
            keys |= batch_keys(cand, strips)
        n_strips = sum(1 for d in strips if len(d))
        n_b = -(-n_strips // pscore.batch_size(n_strips))
        for ci, (cand, want) in enumerate(zip(cands, wants)):
            runs = {}
            for name in (("captured", "eager") if ci % 2 == 0
                         else ("eager", "captured")):
                runs[name] = run(cand, strips, name)
                got = runs[name]["got"]
                require(np.array_equal(got[0], want[0])
                        and got[1:] == want[1:],
                        f"{key} {cell} candidate {ci}: the {name} path "
                        "differs from native")
            cap_run, eag_run = runs["captured"], runs["eager"]
            require(cap_run["launches"] == eag_run["launches"],
                    f"{key} {cell}: launches differ: {cap_run['launches']}"
                    f" against {eag_run['launches']}")
            require(all(cap_run["launches"][k] > 0 for k in TRAIN_KERNELS),
                    f"{key} {cell}: a kernel was not launched")
            require(cap_run["replays"] == n_b and eag_run["replays"] == 0,
                    f"{key} {cell}: {cap_run['replays']} replays for "
                    f"{n_b} batches, {eag_run['replays']} op by op")
            for k in TRAIN_KERNELS:
                out.setdefault(k, {})[f"{key} {cell}"] = \
                    cap_run["launches"][k]
            print(f"{key} {cell} candidate {ci}: {len(cand.reverse)} ids, "
                  f"{len(strips)} strips of {len(strips[0])} bytes, "
                  f"{n_b} batches; " + "; ".join(
                      f"{name}: enqueue {r['enqueue'] * 1e3:.3f} ms, score "
                      f"{r['score'] * 1e3:.3f} ms, call "
                      f"{r['call'] * 1e3:.3f} ms, replays {r['replays']}, "
                      f"read-backs {r['reads']}"
                      for name, r in runs.items())
                  + f"; launches a candidate {cap_run['launches']}; equal "
                  f"to native on both paths ({want[1]} tokens) [{card}]")
            CAPTURED.setdefault(f"score {key} {cell}", []).append(
                {name: {m: r[m] for m in ("enqueue", "score", "call",
                                          "replays", "reads", "launches")}
                 for name, r in runs.items()})
    fresh = set(tk._graphs) - before
    require(fresh <= keys and tk.captures <= len(before | keys),
            f"{key}: graphs {sorted(tk._graphs)} beyond the keys "
            f"{sorted(keys)}")
    eager = {c: sc.eager_scores[c] - eager0[c] for c in eager0}
    require(eager["own_tables"] == eager["split_share"] == 0,
            f"{key}: whole strips left the batched path: {eager}")
    print(f"{key}: captures {tk.captures} for keys {sorted(keys)}; op by "
          f"op by cause in this phase {eager}; {rounds}; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


def trainer_phase(dev, card: str, work: str):
    """Candidate scoring and ``train_vocab`` on the card, in ``work``;
    returns, per kernel on the trainer's path, its trainer-shape numbers,
    and what the later trainer phases compare with: the pool and its text,
    the native run's round lines and files, and every candidate the cuda
    run scored, by ``_cand_key``."""
    from types import SimpleNamespace
    from unittest import mock

    from tokenmonster_tpu_torch.native import load_native
    from tokenmonster_tpu_torch.ops import _build
    from tokenmonster_tpu_torch.ops.tables import decide_entries
    from tokenmonster_tpu_torch.parallel.score import score_strips
    from tokenmonster_tpu_torch.train import trainvocab as port
    from tokenmonster_tpu_torch.train.score_helpers import \
        candidate_runtime_state

    failed = []
    load_native()
    native_score = port_native_score

    def check(cond, msg: str) -> None:
        """Record a failed check; the phase fails at its end, after every
        check has run and printed."""
        if not cond:
            print(f"FAILED: {msg}", flush=True)
            failed.append(msg)

    t = trainer_inputs(dev, card, work)
    sc, tk, text = t.sc, t.tk, t.text
    sup = sc._sup

    errs = dict.fromkeys(TRAIN_KERNELS, 0)
    mask_ms, score_ms = [], []
    for ci in range(3):
        cand = t.candidate()
        t0 = time.perf_counter()
        tabs = candidate_runtime_state(sup, cand)
        torch.cuda.synchronize()
        mask_ms.append((time.perf_counter() - t0) * 1e3)
        cpairs, cwork = masked_pairs(t, tabs)
        for name in TRAIN_KERNELS:
            errs[name] = max(errs[name], compare(cpairs, name))
        pairs = cpairs         # timed below: the last candidate's
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got_s, got_t, got_m, repairs = score_strips(
            tk, tabs, [text], len(cand.reverse))
        end.record()
        end.synchronize()
        score_ms.append(start.elapsed_time(end))
        want_s, want_t, want_m = native_score(cand, [text])
        check(np.array_equal(got_s, want_s) and got_t == want_t
              and set(np.nonzero(got_m)[0].tolist()) == want_m,
              f"candidate {ci}: device scores differ from native")
        got = sc.score(cand, [text])
        check(np.array_equal(got[0], want_s) and got[1] == want_t
              and got[2] == want_m,
              f"candidate {ci}: GpuCandidateScorer.score differs")
        print(f"candidate {ci}: {len(cand.reverse)} ids, "
              f"{len(cand.tokens)} entries; match/decide/follow "
              f"max_abs_err {errs}; {got[1]} tokens, missing "
              f"{sorted(got[2])}, junction repairs {repairs} over "
              f"{len(text)} bytes, all on the card")
    check(not any(errs.values()), f"kernels disagree: {errs}")

    # the junction repair, forced: after an "x", a run of "a" with
    # tokens "aa", "a", "x" puts every lane out of the text's phase
    rv = port.CandidateScorer(1, 2, t.norm_flag).build([b"aa", b"a", b"x"])
    rsc = port.GpuCandidateScorer(1, 2, t.norm_flag, device=dev)
    rsc.set_specials([])
    rsc.prepare([b"aa", b"a", b"x"])
    run = [b"x" + b"a" * (300 << 10) + b"xaaxa" * 20]
    got = rsc.score(rv, run)
    want = native_score(rv, run)
    check(np.array_equal(got[0], want[0]) and got[1:] == want[1:]
          and rsc.repairs > 0, f"repaired run: {rsc.repairs} repairs, "
                               "or scores differ from native")
    print(f"junction repair: {len(run[0])} bytes of one run, "
          f"{rsc.repairs} repairs, equal to native")
    print(f"host masking: {statistics.median(mask_ms):.3f} ms per "
          f"candidate (median of 3, upload included); device score: "
          f"{statistics.median(score_ms):.3f} ms per candidate over "
          f"{len(text)} bytes (CUDA events, read-back included) [{card}]")

    # train_vocab on the card against the native backend
    scored, scorers = [], []

    class Recording(port.GpuCandidateScorer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            scorers.append(self)

        def prepare(self, superset_tokens, hashmatch_tables=None):
            t0 = time.perf_counter()
            super().prepare(superset_tokens, hashmatch_tables)
            torch.cuda.synchronize()
            self.arm_s = time.perf_counter() - t0

        def score(self, cand, datasets):
            res = super().score(cand, datasets)
            scored.append((cand, datasets, res))
            return res

    log = _RoundLog()
    logger = logging.getLogger("tokenmonster_tpu_torch.trainvocab")
    logger.addHandler(log)
    logger.setLevel(logging.INFO)

    def config(backend):
        return port.TrainConfig(vocab_size=TRAIN_VOCAB, workers=2,
                               fast=True, seed=TRAIN_SEED,
                               max_rounds=TRAIN_ROUNDS, backend=backend)

    res_cuda = os.path.join(work, "cuda")
    res_native = os.path.join(work, "native")
    _build.reset_launches()
    with mock.patch.object(port, "GpuCandidateScorer", Recording):
        rounds_cuda, cuda_s = _train(lambda: port.train_vocab(
            t.raw, t.tok_path, res_cuda, config("cuda"), device=dev),
            log)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    rounds_native, native_s = _train(lambda: port.train_vocab(
        t.raw, t.tok_path, res_native, config("native")), log)
    logger.removeHandler(log)
    for line in rounds_cuda:
        print(f"cuda   {line}")
    check(rounds_cuda == rounds_native,
          f"rounds differ from native: {rounds_native}")
    check(any(" deleted 0;" not in r for r in rounds_cuda),
          "no round deleted a token")
    files = _dir_bytes(res_cuda)
    check(files and files == _dir_bytes(res_native),
          f"results differ from native's: {sorted(files)}")
    check(len(scorers) == 1 and scorers[0].own_table_scores == 0,
          f"{len(scorers)} scorers armed, or a candidate of the loop left "
          "REMAP mode")
    for cand, datasets, (got_s, got_t, got_miss) in scored:
        want_s, want_t, want_m = native_score(cand, datasets)
        check(np.array_equal(got_s, want_s) and got_t == want_t
              and got_miss == want_m,
              "a candidate of the cuda run differs from native")
    check(all(launches[k] > 0 for k in TRAIN_KERNELS),
          f"a trainer kernel was not launched: {launches}")
    check(scorers[0].eager_scores["split_share"] == 0,
          f"a share of a strip ran op by op: {scorers[0].eager_scores}")
    print(f"train_vocab: {len(scored)} candidates scored on the card "
          f"and by native, {len(files)} files written "
          f"({', '.join(sorted(files))}); junction repairs "
          f"{scorers[0].repairs}, every byte on the card; op by op by "
          f"cause {scorers[0].eager_scores}; captures "
          f"{scorers[0]._sup.tokenizer.captures}; launches {launches}")
    arm = scorers[0].arm_s if scorers else 0.0
    print(f"wall per round: cuda {(cuda_s - arm) / TRAIN_ROUNDS:.3f} s "
          f"after a {arm:.3f} s superset arm, native "
          f"{native_s / TRAIN_ROUNDS:.3f} s ({os.cpu_count()} host "
          f"threads) [{card}]")
    shared = SimpleNamespace(
        raw=t.raw, text=t.text, tok_path=t.tok_path, gat_s=t.gat_s,
        rounds_native=rounds_native, files_native=_dir_bytes(res_native),
        round_s=(cuda_s - arm) / TRAIN_ROUNDS,
        native_round_s=native_s / TRAIN_ROUNDS,
        scored={_cand_key(c): r for c, _d, r in scored}, inputs=t)

    out = {}
    for name in TRAIN_KERNELS:
        kernel, plain = pairs[name]
        b_ms, b_by = bound(*cwork[name])
        ms = cuda_ms(kernel)
        device_ms = cuda_ms(kernel, queued=True)
        plain_ms = cuda_ms(plain, calls=1)
        out[name] = {"trainer_launches": launches[name],
                     "trainer_max_abs_err": errs[name], "trainer_ms": ms,
                     "trainer_device_ms": device_ms,
                     "trainer_plain_ms": plain_ms,
                     "trainer_bound_ms": b_ms, "trainer_bound_by": b_by,
                     "trainer_roofline_share": b_ms / ms,
                     "trainer_device_roofline_share": b_ms / device_ms}
        print(f"{name}: trainer shapes kernel {ms:.4f} ms launched back to "
              f"back from the host ({device_ms:.4f} on the card alone), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{cwork[name][0]} B, {cwork[name][1]} ops), roofline "
              f"{100 * b_ms / ms:.2f}% ({100 * b_ms / device_ms:.2f}% of "
              f"the card alone) (N={t.buf.numel()}, {LANES} lanes, "
              f"masked superset of {len(sup.vocab.tokens)}) [{card}]")
    gather, g_work = gather_work(t.buf, t.n, tabs)
    g_bound, g_by = bound(*g_work)
    g_ms = cuda_ms(gather)
    g_device_ms = cuda_ms(gather, queued=True)
    out["decide"].update(trainer_gather_ms=g_ms,
                         trainer_gather_device_ms=g_device_ms,
                         trainer_gather_bound_ms=g_bound)
    print(f"rank gather (torch ops, REMAP mode): {g_ms:.4f} ms a dispatch "
          f"from the host, {g_device_ms:.4f} on the card alone, bound "
          f"{g_bound:.4f} ms ({g_by}) [{card}]")
    # a candidate's decide table is built around the launches, by torch ops
    # on its uploaded planes: no kernel's time or bound holds it
    rows = tabs.entries.shape[0]
    e_ms = cuda_ms(lambda: decide_entries(tabs.meta, rows))
    e_device_ms = cuda_ms(lambda: decide_entries(tabs.meta, rows), calls=1,
                          queued=True)
    out["decide"].update(trainer_entries_ms=e_ms,
                         trainer_entries_device_ms=e_device_ms)
    per_cand = launches["decide"] / max(len(scored), 1)
    print(f"decide_entries: a candidate's table ({nbytes(tabs.entries)} B "
          f"from planes of {nbytes(tabs.meta)} B, torch ops) {e_ms:.4f} ms "
          f"from the host, {e_device_ms:.4f} on the card alone, once a "
          f"candidate, beside {per_cand:.0f} decide launches a candidate "
          f"of {out['decide']['trainer_ms']:.4f} "
          f"({out['decide']['trainer_device_ms']:.4f}) ms [{card}]")
    print(f"shared memory at trainer shapes: "
          f"{smem_plan(t.buf, t.n, tabs, LANES, tk.chunk, t.t_rec)}")
    require(not failed, f"trainer phase: {len(failed)} checks failed")
    return out, shared

def own_tables_phase(dev, card: str, t) -> dict:
    """The trainer's scorer on candidates' own tables, at the 8 MiB cell
    (``trainer_inputs`` ``t``, whose scorer holds the superset in REMAP
    mode): the next seeded 32,000-id candidate scored by a scorer never
    prepared; that candidate with a token the superset lacks, and with the
    unk token (the superset has none), by the prepared scorer; then all
    three over two slots of the card (a fresh scorer, and one prepared on
    the same superset placement).  Each on the whole text against
    ``tm_tokenize_score``, the first also against the prepared scorer's
    REMAP result, the two slots against one; times of each case's
    placement, upload and device score beside REMAP's masking and score;
    the launches of all that; then match, decide and follow on the
    candidate's own tables against their plain versions, and their times.
    Returns, per kernel, its numbers keyed ``own_*``."""
    from unittest import mock

    from tokenmonster_tpu_torch.ops import _build
    from tokenmonster_tpu_torch.ops.scan import MARGIN, GpuTokenizer
    from tokenmonster_tpu_torch.parallel import score as pscore
    from tokenmonster_tpu_torch.parallel.score import score_strips
    from tokenmonster_tpu_torch.train import trainvocab as port
    from tokenmonster_tpu_torch.train.score_helpers import \
        candidate_runtime_state

    sc, text = t.sc, t.text
    sup = sc._sup
    cand = t.candidate()
    toks = [bytes(x) for x in cand.tokens]
    require(sc.build(toks).tokens == cand.tokens,
            "the candidate does not rebuild from its tokens")
    absent = b"qqzxjqqzxj"
    require(absent not in sup.index, "the absent token is in the superset")
    lacking = sc.build(toks + [absent])
    with_unk = sc.build(toks)
    require(with_unk.enable_unk_token(), "no unk token enabled")

    timed = {}
    real_build, real_strips, real_slots = (port.build_hashmatch,
                                           pscore.score_strips,
                                           port.score_slots)
    own_tks = []

    def placement(*args, **kw):
        t0 = time.perf_counter()
        out = real_build(*args, **kw)
        timed["placement_s"] = time.perf_counter() - t0
        return out

    class Upload(GpuTokenizer):
        def __init__(self, *args, **kw):
            t0 = time.perf_counter()
            super().__init__(*args, **kw)
            torch.cuda.synchronize(self.device)
            if not self.tables.match_only:
                timed.setdefault("upload_s", []).append(
                    time.perf_counter() - t0)
                own_tks.append(self)

    def strips_on_events(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_strips(*args)
        end.record()
        end.synchronize()
        timed["score_ms"] = start.elapsed_time(end)
        return out

    def slots_on_host(*args):
        t0 = time.perf_counter()
        out = real_slots(*args)
        timed["score_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def native_score(c):
        return port.CandidateScorer(c.charset, c.using_capcode,
                                    c.normalizer.flag).score(c, [text])

    def scorer(devices):
        out = port.GpuCandidateScorer(cand.charset, cand.using_capcode,
                                      cand.normalizer.flag, device=devices)
        out.set_specials([])
        return out

    def held(got, want, what: str) -> None:
        require(np.array_equal(got[0], want[0]) and got[1:] == want[1:],
                f"{what}: scores, token count or missing set differ")

    def scored(scorer_, c, what: str):
        timed.clear()
        own, repairs = scorer_.own_table_scores, scorer_.repairs
        got = scorer_.score(c, [text])
        require(scorer_.own_table_scores == own + 1,
                f"{what}: not scored on its own tables")
        where = ("CUDA events" if scorer_._slots is None
                 else "host clock, two threads, the slots' uploads")
        print(f"{what}: {len(c.tokens)} entries, S = "
              f"{own_tks[-1].tables.w3_shift}; placement "
              f"{timed['placement_s']:.3f} s, upload "
              f"{sum(timed['upload_s']):.3f} s ({len(timed['upload_s'])} "
              f"slot(s)), device score {timed['score_ms']:.3f} ms ({where},"
              f" read-back included); {got[1]} tokens, missing "
              f"{sorted(got[2])}; own_table_scores "
              f"{scorer_.own_table_scores}, repairs "
              f"{scorer_.repairs - repairs} [{card}]")
        return got

    fresh = scorer(dev)
    cases = (("unprepared", fresh, cand), ("superset lacks a token", sc,
                                           lacking),
             ("unk id the superset lacks", sc, with_unk))
    one = {}
    t0_phase = time.perf_counter()
    _build.reset_launches()
    with mock.patch.object(port, "build_hashmatch", placement), \
            mock.patch.object(port, "GpuTokenizer", Upload), \
            mock.patch.object(pscore, "score_strips", strips_on_events), \
            mock.patch.object(port, "score_slots", slots_on_host):
        for what, scorer_, c in cases:
            one[what] = scored(scorer_, c, what)
            held(one[what], native_score(c), f"{what} against native")
        # the same candidate in REMAP mode, for comparison
        t0 = time.perf_counter()
        tabs = candidate_runtime_state(sup, cand)
        torch.cuda.synchronize()
        mask_ms = (time.perf_counter() - t0) * 1e3
        timed.clear()
        remap = strips_on_events(sup.tokenizer, tabs, [text],
                                 len(cand.reverse))
        held((remap[0], remap[1],
              {int(b) for b in np.nonzero(remap[2])[0]}),
             one["unprepared"], "REMAP against own tables")
        print(f"the same candidate in REMAP mode: host masking "
              f"{mask_ms:.3f} ms (upload included), device score "
              f"{timed['score_ms']:.3f} ms (CUDA events, read-back "
              f"included); equal to its own tables' [{card}]")
        fresh2 = scorer([dev, dev])
        prep2 = scorer([dev, dev])
        prep2.prepare(port.superset_pool(t.tok_path),
                      hashmatch_tables=sup.hashmatch)
        for (what, _s, c), two in zip(cases, (fresh2, prep2, prep2)):
            got = scored(two, c, f"two slots, {what}")
            held(got, one[what], f"two slots, {what}, against one slot")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    phase_s = time.perf_counter() - t0_phase
    require(all(launches[k] > 0 for k in TRAIN_KERNELS),
            f"an own-tables kernel was not launched: {launches}")
    print(f"own tables: {len(cases)} candidates on one slot and on two, "
          f"equal to native (and the first to REMAP), in {phase_s:.1f} s; "
          f"launches {launches} [{card}]")

    tk = own_tks[0]
    staged = tk.stage(text[:(LANES - 1) * tk.chunk + MARGIN])
    lanes, bufs = staged.lanes, staged.bufs
    require(lanes == LANES, f"{lanes} lanes staged")
    N, pairs, work_of, plan = dispatch_pairs(tk, bufs[0][0], bufs[0][1],
                                             True)
    out = {}
    for name in TRAIN_KERNELS:
        err = compare(pairs, name)
        require(err == 0, f"{name} on own tables: max_abs_err {err}")
        kernel, plain = pairs[name]
        b_ms, b_by = bound(*work_of[name])
        ms = cuda_ms(kernel)
        device_ms = cuda_ms(kernel, queued=True)
        plain_ms = cuda_ms(plain, calls=1, repeat=3)
        out[name] = {"own_launches": launches[name], "own_max_abs_err": err,
                     "own_ms": ms, "own_device_ms": device_ms,
                     "own_plain_ms": plain_ms, "own_bound_ms": b_ms,
                     "own_bound_by": b_by, "own_roofline_share": b_ms / ms,
                     "own_device_roofline_share": b_ms / device_ms}
        print(f"{name}: own tables of {len(cand.tokens)} entries kernel "
              f"{ms:.4f} ms from the host ({device_ms:.4f} on the card "
              f"alone), plain {plain_ms:.4f} ms, max_abs_err {err}, bound "
              f"{b_ms:.4f} ms ({b_by}, {work_of[name][0]} B, "
              f"{work_of[name][1]} ops), roofline {100 * b_ms / ms:.2f}% "
              f"({100 * b_ms / device_ms:.2f}% of the card alone) "
              f"(N={N}, {LANES} lanes) [{card}]")
    print(f"shared memory on own tables: {plan}")
    return out


def sort_phase(dev, card: str, shared) -> dict:
    """getalltokens of the trainer phase's configuration with
    ``TM_GAT_DEVICE=1``: every micro-chunk's window sort on the card (no
    host fallback), the ``.tok`` file byte for byte the host sort's; then
    each micro-chunk's sort on the card against the native host sort, in
    turns in this process, with the same run structure.  Returns the
    sort's numbers for the kernels line."""
    from unittest import mock

    from tokenmonster_tpu_torch.native import native_sorted_windows
    from tokenmonster_tpu_torch.ops import device_sort
    from tokenmonster_tpu_torch.train import getalltokens as gat

    sorts = []
    real = device_sort.device_sorted_windows

    def recording(data, n, width, device="cuda"):
        sorts.append((np.array(data, copy=True), n, width, str(device)))
        return real(data, n, width, device)

    torch.cuda.reset_peak_memory_stats(dev)
    os.environ["TM_GAT_DEVICE"] = "1"
    try:
        with mock.patch.object(device_sort, "device_sorted_windows",
                               recording):
            t0 = time.perf_counter()
            counter, char_table, header = gat.get_all_tokens(
                shared.raw, "balanced", charset=1, normalization="nfd",
                using_capcode=2, min_occur_total=TRAIN_MIN_OCCUR)
            gat_s = time.perf_counter() - t0
    finally:
        del os.environ["TM_GAT_DEVICE"]
    peak = torch.cuda.max_memory_allocated(dev)
    path = os.path.join(os.path.dirname(shared.tok_path), "pool_device.tok")
    gat.save_tokens_file(path, counter, char_table, header)
    with open(path, "rb") as f, open(shared.tok_path, "rb") as g:
        same = f.read() == g.read()
    require(sorts and all(d == "cuda" for *_x, d in sorts),
            f"getalltokens did not sort on the card: {sorts}")
    require(same, "the device sort's .tok file differs from the host "
                  "sort's")
    print(f"getalltokens with TM_GAT_DEVICE=1: {len(counter)} candidates in "
          f"{gat_s:.1f} s (host sort: {shared.gat_s:.1f} s), .tok byte for "
          f"byte the host sort's; {len(sorts)} micro-chunk sorts on the "
          f"card, peak {peak / 2**30:.3f} GiB allocated [{card}]")

    rows = []
    for data, n, width, _d in sorts:
        w32 = -(-width // 4)
        dev_s, host_s = [], []
        for turn in range(REPEAT):           # device, host, host, device...
            for side in (("dev", "host") if turn % 2 == 0
                         else ("host", "dev")):
                t0 = time.perf_counter()
                if side == "dev":
                    order_d, fd_d = real(data, n, width, dev)
                    dev_s.append(time.perf_counter() - t0)
                else:
                    order_h, fd_h = native_sorted_windows(data, n, width)
                    host_s.append(time.perf_counter() - t0)
        require(np.array_equal(np.sort(order_d), np.arange(n, dtype=np.uint32))
                and np.array_equal(np.minimum(fd_d, width),
                                   np.minimum(fd_h, width)),
                f"micro-chunk of {n} windows: the run structure differs "
                "from the host sort's")
        # the bound: every LSD pass reads and writes each position's w32
        # words once
        b_ms = w32 * 2 * w32 * 4 * n / PEAK_BYTES_S * 1e3
        ms, host_ms = (statistics.median(dev_s) * 1e3,
                       statistics.median(host_s) * 1e3)
        rows.append({"windows": n, "width": width, "ms": ms,
                     "host_ms": host_ms, "bound_ms": b_ms})
        print(f"window sort of a micro-chunk ({n} windows of {width} bytes, "
              f"{w32} LSD passes of torch.sort(stable=True)): card "
              f"{ms:.3f} ms (upload, passes, first differences and "
              f"download), native host sort {host_ms:.3f} ms "
              f"({os.cpu_count()} threads), in turns, medians of {REPEAT}; "
              f"bound {b_ms:.3f} ms (bytes: {w32} passes reading and "
              f"writing {4 * w32} B a window) [{card}]")
    return {"name": "device_sort", "route": "torch",
            "source": "tokenmonster_tpu_torch/ops/device_sort.py",
            "replaces": "tokenmonster_tpu/ops/device_sort.py:26 (XLA, not "
                        "a Pallas kernel)",
            "getalltokens_s": gat_s, "host_getalltokens_s": shared.gat_s,
            "peak_bytes": peak, "micro_chunks": rows}


# One rank of the multi-process trainer run (``multidevice_phase``): joins
# a gloo group on localhost, runs the trainer phase's seeded train_vocab
# with the scorer on the device given, and prints its round lines,
# launches, arm time and scored candidates on one line.  Arguments: rank,
# world, port, work directory (pool.tok and data.bin), the TrainConfig
# fields as JSON, device.
RANK_CHILD = r"""
import hashlib, json, logging, os, sys, time

import numpy as np
import torch

from tokenmonster_tpu_torch.ops import _build
from tokenmonster_tpu_torch.parallel import multihost
from tokenmonster_tpu_torch.train import trainvocab as port

rank, world, port_no, work, cfg, device = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    json.loads(sys.argv[5]), sys.argv[6])
multihost.init_distributed(f"tcp://localhost:{port_no}", world, rank,
                           backend="gloo", timeout_s=300)
rounds, scored, arm = [], {}, []


class Rounds(logging.Handler):
    def emit(self, record):
        if record.getMessage().startswith("round "):
            rounds.append(record.getMessage())


class Recording(port.GpuCandidateScorer):
    def prepare(self, superset_tokens, hashmatch_tables=None):
        t0 = time.perf_counter()
        super().prepare(superset_tokens, hashmatch_tables)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        arm.append(time.perf_counter() - t0)

    def score(self, cand, datasets):
        res = super().score(cand, datasets)
        key = hashlib.sha1(b"\0".join(bytes(t) for t in cand.tokens))
        scored[key.hexdigest()] = res
        return res


log = logging.getLogger("tokenmonster_tpu_torch.trainvocab")
log.addHandler(Rounds())
log.setLevel(logging.INFO)
port.GpuCandidateScorer = Recording
with open(os.path.join(work, "data.bin"), "rb") as f:
    raw = f.read()
_build.reset_launches()
t0 = time.perf_counter()
port.train_vocab(raw, os.path.join(work, "pool.tok"),
                 os.path.join(work, "ranks"),
                 port.TrainConfig(backend="cuda", **cfg), device=device)
if torch.device(device).type == "cuda":
    torch.cuda.synchronize()
secs = time.perf_counter() - t0
np.savez(os.path.join(work, f"rank{rank}.npz"),
         **{k: v[0] for k, v in scored.items()})
print("RANK " + json.dumps({
    "rounds": rounds, "launches": dict(_build.launches), "seconds": secs,
    "arm_s": arm[0],
    "scored": {k: [v[1], sorted(v[2])] for k, v in scored.items()}}),
    flush=True)
"""


def run_ranks(work: str, world: int, cfg: dict, device: str) -> list:
    """Run ``world`` ranks of ``RANK_CHILD`` over one rendezvous on
    localhost, in ``work`` (which holds pool.tok and data.bin), each in a
    process that refuses jax and the JAX package, with a timeout of its
    own; returns each rank's result, its scored candidates as
    {key: (scores, n_tokens, missing set)}."""
    import socket
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port_no = str(sock.getsockname()[1])
    sock.close()
    site = os.path.join(work, "site")
    os.makedirs(site, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(PIPELINE_SITE)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([site, ROOT]),
           "LOCAL_WORLD_SIZE": str(world)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CHILD, str(rank), str(world), port_no,
         work, json.dumps(cfg), device], cwd=work,
        env={**env, "LOCAL_RANK": str(rank)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    ranks = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"rank {rank} exited {p.returncode}: "
                                   f"{err[-3000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        require(len(line) == 1, f"rank {rank} printed no result")
        got = json.loads(line[0][5:])
        arrays = np.load(os.path.join(work, f"rank{rank}.npz"))
        got["scored"] = {k: (arrays[k], n_tok, set(miss))
                         for k, (n_tok, miss) in got["scored"].items()}
        ranks.append(got)
    return ranks


def multidevice_phase(dev, card: str, shared) -> dict:
    """The trainer phase's seeded ``train_vocab`` with the scorer split
    over two slots on the one card (``device=[cuda:0, cuda:0]``: each
    candidate's text in two shares of its dispatches, each on its own
    thread and stream), then as two processes over ``torch.distributed``
    (gloo: two ranks cannot share a card over NCCL), each rank's share on
    the card: round lines, written files and every candidate's scores,
    token count and missing set equal to the one-device run and to native,
    and every trainer kernel launched in each process.  Returns the
    launches."""
    from unittest import mock

    from tokenmonster_tpu_torch.ops import _build
    from tokenmonster_tpu_torch.parallel.score import plan_pieces
    from tokenmonster_tpu_torch.train import trainvocab as port

    work = os.path.dirname(shared.tok_path)
    cfg = dict(vocab_size=TRAIN_VOCAB, workers=2, fast=True, seed=TRAIN_SEED,
               max_rounds=TRAIN_ROUNDS)
    scored, scorers = {}, []

    class Recording(port.GpuCandidateScorer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            scorers.append(self)

        def prepare(self, superset_tokens, hashmatch_tables=None):
            t0 = time.perf_counter()
            super().prepare(superset_tokens, hashmatch_tables)
            torch.cuda.synchronize()
            self.arm_s = time.perf_counter() - t0

        def score(self, cand, datasets):
            res = super().score(cand, datasets)
            scored[_cand_key(cand)] = res
            return res

    def same_scores(got: dict) -> bool:
        return (got.keys() == shared.scored.keys() and all(
            np.array_equal(g[0], shared.scored[k][0])
            and g[1:] == shared.scored[k][1:] for k, g in got.items()))

    log = _RoundLog()
    logger = logging.getLogger("tokenmonster_tpu_torch.trainvocab")
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    res_two = os.path.join(work, "two_slots")
    _build.reset_launches()
    with mock.patch.object(port, "GpuCandidateScorer", Recording):
        rounds, secs = _train(lambda: port.train_vocab(
            shared.raw, shared.tok_path, res_two,
            port.TrainConfig(backend="cuda", **cfg), device=[dev, dev]), log)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    logger.removeHandler(log)
    sc = scorers[0]
    shares = plan_pieces([len(sc._sup.tokenizer._plan(len(shared.text))[1])],
                         2)
    require(len(scorers) == 1 and len(sc._slots) == 2 and all(shares),
            f"the scorer was not armed on two slots, or a slot has no share "
            f"of the text: {shares}")
    require(rounds == shared.rounds_native,
            f"two slots: rounds differ from native: {rounds}")
    require(_dir_bytes(res_two) == shared.files_native,
            "two slots: files differ from native's")
    require(same_scores(scored), "two slots: a candidate's scores differ "
                                 "from the one-device run's")
    require(all(launches[k] > 0 for k in TRAIN_KERNELS),
            f"two slots: a trainer kernel was not launched: {launches}")
    print(f"two slots on {dev}: the text's dispatches in shares {shares}; "
          f"{len(scored)} candidates equal to the "
          f"one-device run's (and native's), rounds and "
          f"{len(shared.files_native)} files equal native's; launches "
          f"{launches}; {(secs - sc.arm_s) / TRAIN_ROUNDS:.3f} s a round "
          f"after a {sc.arm_s:.3f} s arm of both slots (one slot: "
          f"{shared.round_s:.3f} s) [{card}]")

    with open(os.path.join(work, "data.bin"), "wb") as f:
        f.write(shared.raw)
    t0 = time.perf_counter()
    ranks = run_ranks(work, 2, cfg, str(dev))
    secs = time.perf_counter() - t0
    for rank, got in enumerate(ranks):
        got_scored = got["scored"]
        require(got["rounds"] == shared.rounds_native,
                f"rank {rank}: rounds differ from native: {got['rounds']}")
        require(same_scores(got_scored), f"rank {rank}: a candidate's "
                "scores differ from the one-device run's")
        require(all(got["launches"].get(k, 0) > 0 for k in TRAIN_KERNELS),
                f"rank {rank} did not launch every trainer kernel: "
                f"{got['launches']}")
    require(_dir_bytes(os.path.join(work, "ranks")) == shared.files_native,
            "two processes: rank 0's files differ from native's")
    print(f"two processes (gloo, one card): {len(ranks[0]['scored'])} "
          f"candidates equal to the one-device run's in both ranks, rounds "
          f"equal native's in both, rank 0's files equal native's; launches "
          f"{[r['launches'] for r in ranks]}; a round "
          f"{[round((r['seconds'] - r['arm_s']) / TRAIN_ROUNDS, 3) for r in ranks]}"
          f" s after arms of {[round(r['arm_s'], 3) for r in ranks]} s "
          f"({secs:.1f} s in all, start-up included) [{card}]")
    return {"two_slot_launches": launches,
            "rank_launches": [r["launches"] for r in ranks]}


def _popcount_share(words: torch.Tensor) -> float:
    """The share of set bits in int32 ``words``."""
    return float(np.unpackbits(words.cpu().numpy().view(np.uint8)).mean())


def wide_tokenizer_phase(dev, card: str, sup, raw: bytes, text: bytes,
                         work: str, shift: int, key: str) -> dict:
    """The tokenizer at a vocabulary of 2^20 entries or more: a trainer
    superset's vocabulary (``sup``), whose token words take the wide shift
    ``shift`` (21 at the reference-scale superset, 22 past 2^21 entries).
    Through ``GpuTokenizer`` on the arm's placement
    (``GpuCandidateScorer.prepare`` builds it as ``upload_tables`` would,
    space-stripped entries included), then saved and loaded with
    ``load(path, device="cuda")``, its route pinned to "device" and then
    "auto", which must pick the device: the ids of the whole text against
    native (arrays and FNV-1a 64, missing counts) on every call, no host
    fallback; each kernel against its plain version on one dispatch, then
    times.  At S = 21 decide is timed against S = 20 on the same dispatch,
    in turns; above, follow's u64 tile word against its u32 word at S = 21.
    Returns per kernel its numbers at this vocabulary, keys prefixed
    ``key``."""
    from unittest import mock

    import tokenmonster_tpu_torch as tt
    from tokenmonster_tpu_torch.native import NativeVocab
    from tokenmonster_tpu_torch.ops import _build, tables
    from tokenmonster_tpu_torch.ops.scan import MARGIN, GpuTokenizer

    v = sup.vocab
    n_ent = len(v.tokens)
    require(tables.MAX_ENTRIES <= n_ent <= tables.placement_limit(),
            f"{n_ent} entries: not a vocabulary of the wide word")
    require(sup.hashmatch.has_space == (tables.space_prefix(v) is not None),
            "the arm's placement is not the one upload_tables builds")
    t0 = time.perf_counter()
    wtk = GpuTokenizer(v, device=dev, hashmatch_tables=sup.hashmatch)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    tabs = wtk.tables
    require(tabs.w3_shift == shift, f"token words at shift {tabs.w3_shift}")
    tab_bytes = nbytes(*tabs.buffers())
    nv = NativeVocab(v)
    t0 = time.perf_counter()
    want, wmiss = nv.tokenize(text)
    native_s = time.perf_counter() - t0
    h_want = fnv1a64(want)
    print(f"{key} tokenizer: the superset vocabulary, {n_ent} entries, "
          f"delete token {tabs.has_delete}, token words at S = "
          f"{tabs.w3_shift}, {tabs.idx1_bits}-bit index fields; tables "
          f"uploaded in {up_s:.3f} s on the arm's placement, {tab_bytes} B "
          f"on the card; native {native_s:.3f} s [{card}]")

    missing_seen = []
    tokenize = GpuTokenizer.tokenize

    def recording(self, data):
        res = tokenize(self, data)
        missing_seen.append(res[1])
        return res

    def held(ids, what: str) -> None:
        ids32 = np.asarray(ids, np.uint32)
        require(np.array_equal(ids32, want), f"{what}: ids differ from "
                                             "native")
        h = fnv1a64(ids32)
        require(h == h_want, f"{what}: fnv differs from native")
        require(missing_seen[-1] == wmiss, f"{what}: missing "
                f"{missing_seen[-1]}, native {wmiss}")
        print(f"{what}: {len(ids32)} ids, fnv1a64 {h:016x} (native "
              f"{h_want:016x}), missing {missing_seen[-1]} (native {wmiss})")

    path = os.path.join(work, f"{key}.vocab")
    t0 = time.perf_counter()
    v.save(path)
    vocab = tt.load(path, device="cuda", route="device")
    load_s = time.perf_counter() - t0
    _build.reset_launches()
    with mock.patch.object(GpuTokenizer, "tokenize", recording):
        t0 = time.perf_counter()
        ids, _missing = wtk.tokenize(text)
        tok_s = time.perf_counter() - t0
        held(ids, f"GpuTokenizer, {len(text)} normalized bytes")
        t0 = time.perf_counter()
        ids = vocab.tokenize(raw)
        first_s = time.perf_counter() - t0
        require(vocab.last_route == "device", f"route {vocab.last_route}")
        held(ids, f"load(route=\"device\"), {len(raw)} raw bytes")
        vocab.route = "auto"
        ids = vocab.tokenize(raw)
        require(vocab.last_route == "device",
                f"route \"auto\" picked {vocab.last_route}")
        held(ids, f"load(route=\"auto\"), picked {vocab.last_route}")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    api_tk = vocab._tpu
    require(wtk.host_fallbacks == 0 == api_tk.host_fallbacks,
            f"a host fallback: {wtk.fallbacks}, {api_tk.fallbacks}")
    require(api_tk.tables.w3_shift == shift, "load() took another shift")
    require(all(launches[k] > 0 for k in TPU_KERNELS),
            f"a kernel was not launched: {launches}")
    print(f"{key} tokenizer: GpuTokenizer call {tok_s:.3f} s; saved and "
          f"loaded in {load_s:.3f} s, first device call {first_s:.3f} s "
          f"(its placement built); route counts {vocab.route_counts}; "
          f"junctions repaired on the card {wtk.repairs} (GpuTokenizer), "
          f"{api_tk.repairs} (load(), both calls); launches {launches} "
          f"[{card}]")

    # the vocabulary as a trainer candidate on the tables its tokenizer
    # holds: the own-tables scorer's path, at S = shift
    from tokenmonster_tpu_torch.parallel.score import score_strips
    n_ids = len(v.reverse)
    _build.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got_s, got_t, got_m, repairs = score_strips(wtk, tabs, [text], n_ids)
    end.record()
    end.synchronize()
    own_launches = dict(_build.launches)
    t0 = time.perf_counter()
    want_s = np.zeros(n_ids + 1, np.int64)
    want_m = np.zeros(256, np.uint8)
    want_t, _n_miss = nv.tokenize_score(text, want_s, want_m)
    native_score_s = time.perf_counter() - t0
    require(np.array_equal(got_s, want_s[:n_ids]) and got_t == want_t
            and np.array_equal(got_m != 0, want_m != 0),
            f"{key} vocabulary as a candidate on its own tables: scores "
            "differ from native")
    require(all(own_launches[k] > 0 for k in TRAIN_KERNELS),
            f"a kernel was not launched scoring on own tables: "
            f"{own_launches}")
    print(f"{key} vocabulary scored as a candidate on its tokenizer's "
          f"tables (S = {tabs.w3_shift}): {got_t} tokens, missing "
          f"{np.nonzero(got_m)[0].tolist()}, equal to native; device score "
          f"{start.elapsed_time(end):.3f} ms (CUDA events, read-back "
          f"included), native {native_score_s:.3f} s; junction repairs "
          f"{repairs}; launches {own_launches} [{card}]")

    staged = wtk.stage(text[:(LANES - 1) * wtk.chunk + MARGIN])
    lanes, bufs = staged.lanes, staged.bufs
    require(lanes == LANES, f"{lanes} lanes staged")
    N, pairs, work_of, plan = dispatch_pairs(wtk, bufs[0][0], bufs[0][1],
                                             True)
    errs = {name: compare(pairs, name) for name in TPU_KERNELS}
    print(f"{key} tokenizer, N={N}, {LANES} lanes x {CHUNK}, S = {shift}: "
          f"max_abs_err {errs}")
    require(not any(errs.values()),
            f"kernels disagree at S = {shift}: {errs}")
    out = {}
    for name in TPU_KERNELS:
        kernel, plain = pairs[name]
        b_ms, b_by = bound(*work_of[name])
        ms = cuda_ms(kernel)
        device_ms = cuda_ms(kernel, queued=True)
        plain_ms = cuda_ms(plain, calls=1, repeat=3)
        out[name] = {f"{key}_launches": launches[name],
                     f"{key}_own_launches": own_launches.get(name, 0),
                     f"{key}_max_abs_err": errs[name], f"{key}_ms": ms,
                     f"{key}_device_ms": device_ms,
                     f"{key}_plain_ms": plain_ms, f"{key}_bound_ms": b_ms,
                     f"{key}_bound_by": b_by,
                     f"{key}_roofline_share": b_ms / ms,
                     f"{key}_device_roofline_share": b_ms / device_ms}
        print(f"{name}: {n_ent}-entry vocabulary kernel {ms:.4f} ms from "
              f"the host ({device_ms:.4f} on the card alone), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{work_of[name][0]} B, {work_of[name][1]} ops), roofline "
              f"{100 * b_ms / ms:.2f}% ({100 * b_ms / device_ms:.2f}% of "
              f"the card alone) [{card}]")
    print(f"shared memory at the {key} vocabulary: {plan}")

    from tokenmonster_tpu_torch.ops.decide import decide
    from tokenmonster_tpu_torch.ops.follow import follow
    from tokenmonster_tpu_torch.ops.match import match
    from tokenmonster_tpu_torch.ops.scan import OVERLAP_SCAN
    buf, n = bufs[0][0], bufs[0][1]
    mm = match(buf, n, tabs)
    m, mb = mm if tabs.has_space else (mm, None)
    if shift == 21:
        # the shift alone: decide on the same dispatch and tables at S = 20
        # (its words wrong for indices past 2^20; timed only), in turns
        narrow = copy.copy(tabs)
        narrow.w3_shift = 20
        turns = {20: [], 21: []}
        for s in (21, 20, 20, 21):
            turns[s].append(cuda_ms(lambda: decide(
                m, mb, buf, n, narrow if s == 20 else tabs), queued=True))
        what = "decide"
    else:
        # the tile word alone: follow of the same decisions with the token
        # words cut to S = 21 (a u32 tile word; wrong for indices past
        # 2^21, timed only) against S (a u64 tile word), in turns
        ctl, tok = decide(m, mb, buf, n, tabs)
        t64 = tok.long()
        tok21 = ((t64 & ((1 << 21) - 1)) | ((t64 >> shift) & 3) << 21).to(
            torch.int32)
        t_rec = wtk._t_rec(False)
        recs = {s: follow(ctl, w, n, CHUNK, LANES, OVERLAP_SCAN, t_rec, s)[0]
                for s, w in ((shift, tok), (21, tok21))}
        require(torch.equal(recs[shift], recs[21]),
                "the u32 and u64 tile words walked different chains")
        turns = {21: [], shift: []}
        for s in (shift, 21, 21, shift):
            w = tok if s == shift else tok21
            turns[s].append(cuda_ms(lambda: follow(
                ctl, w, n, CHUNK, LANES, OVERLAP_SCAN, t_rec, s),
                queued=True))
        what = "follow"
    for s, runs in turns.items():
        out[what][f"{key}_s{s}_device_ms"] = statistics.mean(runs)
    order = sorted(turns, reverse=True)
    print(f"{what} on the card alone, the same dispatch: "
          + ", ".join(f"S = {s} {turns[s]} ms" for s in order)
          + f" (in turns {order[0]}, {order[1]}, {order[1]}, {order[0]}) "
          f"[{card}]")

    staged = wtk.stage(text)
    wtk.tokenize_staged(staged, text)
    chain_s = host_seconds(lambda: wtk._run_staged(staged, False, tabs,
                                                   wtk._compact, {}))
    vocab.route = "device"
    before = vocab.route_counts["device"]
    e2e, nat = [], []
    for _ in range(3):                         # in turns
        t0 = time.perf_counter()
        vocab.tokenize(raw)
        e2e.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        nv.tokenize(text)
        nat.append(time.perf_counter() - t0)
    require(vocab.route_counts["device"] == before + 3,
            "a timed call did not take the device route")
    require(api_tk.host_fallbacks == 0, "a timed call fell back")
    print(f"{key} tokenizer: device chain (one pass, no repair) "
          f"{chain_s * 1e3:.3f} ms over {len(text)} normalized bytes "
          f"({len(text) / chain_s / 1e6:.3f} MB/s); e2e load().tokenize "
          f"{statistics.median(e2e):.3f} s over {len(raw)} raw bytes, "
          f"native {statistics.median(nat):.3f} s on the normalized text "
          f"({os.cpu_count()} host threads), medians of 3 in turns [{card}]")
    phase(f"{key} tokenizer: the captured chain against eager")
    CAPTURED[key] = captured_chain_phase(card, key, vocab, raw, want, 3)
    return out


class _Steps:
    """The seconds of each step of ``load(...).tokenize`` calls on the
    device tokenizer ``tk`` of ``core`` while ``timing()`` patches them:
    normalization, staging and upload, the chain's enqueue and the chain
    (enqueue to the card's synchronise), the metadata read, the repair
    pass (where a junction did not hold), the id download and, within it,
    the host's expansion of the delete bitmask.  Each patched step but the
    read ends in a card synchronise, so its seconds are its own."""

    def __init__(self, tk, core, run_name: str):
        self.tk, self.core, self.run_name = tk, core, run_name
        self.steps = {}

    def _add(self, name: str, seconds: float) -> None:
        self.steps[name] = self.steps.get(name, 0.0) + seconds

    def _timed(self, name: str, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self._add(name, time.perf_counter() - t0)
            return out
        return wrapped

    def _run(self, fn):
        def wrapped(staged):
            t0 = time.perf_counter()
            out = fn(staged)
            self._add("enqueue", time.perf_counter() - t0)
            torch.cuda.synchronize()
            self._add("chain", time.perf_counter() - t0)
            return out
        return wrapped

    def _read(self, fn):
        def wrapped(tensors):
            t0 = time.perf_counter()
            out = fn(tensors)
            if "meta" not in self.steps:      # the call's first read
                self._add("meta", time.perf_counter() - t0)
            return out
        return wrapped

    def timing(self):
        """The patches, as one context manager."""
        from contextlib import ExitStack
        from unittest import mock

        from tokenmonster_tpu_torch.ops import finish
        tk, stack = self.tk, ExitStack()
        run = getattr(tk, self.run_name)
        for obj, name, fn in (
                (self.core, "normalize", self._timed("normalize",
                                                     self.core.normalize)),
                (tk, "stage", self._timed("stage", tk.stage)),
                (tk, "_run_captured", self._run(run)),
                (tk, "_read", self._read(tk._read)),
                (tk, "run_repaired", self._timed("repair", tk.run_repaired)),
                (tk, "_download", self._timed("download", tk._download)),
                (finish, "host_ids", self._timed("expand", finish.host_ids))):
            stack.enter_context(mock.patch.object(obj, name, fn))
        return stack


def captured_chain_phase(card: str, key: str, vocab, raw: bytes, want,
                         repeat: int = REPEAT) -> dict:
    """The tokenizer's chain as captured CUDA graphs against the same chain
    enqueued op by op, through ``vocab`` (``load(..., device="cuda")``,
    route pinned to "device") on ``raw``: each path's ids (FNV-1a 64)
    against native's ``want`` and each other's, every call on the device
    route with no host fallback, the launches per kernel of one call of
    each (equal), the captures against the geometries used; then in turns
    (eager, captured, captured, eager, ...) the chain's wall and enqueue
    ms on a staged text, one call's steps (``_Steps``) and one call's e2e,
    ``repeat`` rounds.  The eager path is the captured one with
    ``_run_captured`` replaced by ``_run_eager``.  Returns the numbers."""
    from contextlib import nullcontext
    from unittest import mock

    from tokenmonster_tpu_torch.ops import _build
    from tokenmonster_tpu_torch.ops.scan import MAX_FUSED_DISPATCHES

    core = vocab._core
    tk = vocab._tpu_tokenizer()
    vocab.route = "device"
    norm = core.normalize(raw)
    h_want = fnv1a64(want)

    def mode(name: str):
        return (mock.patch.object(tk, "_run_captured", tk._run_eager)
                if name == "eager" else nullcontext())

    fallbacks, routes = tk.host_fallbacks, dict(vocab.route_counts)
    t0 = time.perf_counter()
    vocab.tokenize(raw)              # the geometry captured, if it is new
    first_s = time.perf_counter() - t0
    calls, ids_of = {}, {}
    for name in ("captured", "eager"):
        with mode(name):
            _build.reset_launches()
            ids = np.asarray(vocab.tokenize(raw), np.uint32)
            torch.cuda.synchronize()
        calls[name] = dict(_build.launches)
        ids_of[name] = ids
        h = fnv1a64(ids)
        require(np.array_equal(ids, want) and h == h_want,
                f"{key}: the {name} path's ids differ from native")
        print(f"{key} {name}: {len(ids)} ids, fnv1a64 {h:016x} (native "
              f"{h_want:016x}); launches of one call {calls[name]}")
    require(np.array_equal(ids_of["captured"], ids_of["eager"]),
            f"{key}: captured and eager ids differ")
    require(calls["captured"] == calls["eager"],
            f"{key}: launches differ: {calls}")
    require(all(calls["captured"][k] > 0 for k in TPU_KERNELS),
            f"{key}: a kernel was not launched: {calls}")
    lanes, plan = tk._plan(len(norm))
    k = len(plan)
    keys = {(lanes, min(MAX_FUSED_DISPATCHES, k - g), False)
            for g in range(0, k, MAX_FUSED_DISPATCHES)}
    require(keys <= set(tk._graphs), f"{key}: geometries {sorted(keys)} "
                                     f"not captured: {sorted(tk._graphs)}")

    staged = tk.stage(norm)
    times = {"captured": [], "eager": []}
    for r in range(repeat):
        for name in (("eager", "captured") if r % 2 == 0
                     else ("captured", "eager")):
            run = tk._run_eager if name == "eager" else tk._run_captured
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(staged)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            steps = _Steps(tk, core, "_run_eager" if name == "eager"
                           else "_run_captured")
            with steps.timing():
                vocab.tokenize(raw)
            with mode(name):
                t3 = time.perf_counter()
                vocab.tokenize(raw)
                t4 = time.perf_counter()
            times[name].append({"chain": t2 - t0, "enqueue": t1 - t0,
                                "e2e": t4 - t3, **{f"step_{s}": v for s, v
                                                   in steps.steps.items()}})
    fell_back = tk.host_fallbacks - fallbacks
    require(fell_back == 0, f"{key}: a call fell back")
    n_calls = 3 + 2 * 2 * repeat
    routes = {r: vocab.route_counts[r] - routes[r] for r in routes}
    require(routes == {"device": n_calls, "native": 0},
            f"{key}: a call took another route: {routes}")
    out = {"first_call_s": first_s, "captures": tk.captures,
           "graph_keys": sorted(map(list, tk._graphs)),
           "launches_per_call": calls["captured"], "repairs": tk.repairs,
           "route_counts": routes, "host_fallbacks": fell_back,
           "normalized_bytes": len(norm), "raw_bytes": len(raw)}
    for name, runs in times.items():
        med = {m: statistics.median(r.get(m, 0.0) for r in runs)
               for m in runs[0]}
        for m, v in med.items():
            out[f"{name}_{m}_ms"] = v * 1e3
        split = ", ".join(f"{m[5:]} {v * 1e3:.3f}" for m, v in med.items()
                          if m.startswith("step_"))
        print(f"{key} {name}: chain {med['chain'] * 1e3:.3f} ms "
              f"({len(norm) / med['chain'] / 1e6:.3f} MB/s over "
              f"{len(norm)} normalized bytes), enqueue "
              f"{med['enqueue'] * 1e3:.3f} ms; e2e {med['e2e'] * 1e3:.3f} "
              f"ms ({len(raw) / med['e2e'] / 1e6:.3f} MB/s over {len(raw)} "
              f"raw bytes); one call's steps, each ending in a card "
              f"synchronise (ms): {split}; medians of {repeat} in turns "
              f"[{card}]")
    print(f"{key}: {tk.captures} captures for geometries "
          f"{sorted(tk._graphs)} (this text: {sorted(keys)}); first call "
          f"{first_s:.3f} s; this phase's {n_calls} calls: route counts "
          f"{routes}, host_fallbacks {fell_back}; junction repairs "
          f"{tk.repairs} (the tokenizer's calls so far) [{card}]")
    return out


def count_pools(raw: bytes, min_occurs) -> dict:
    """getalltokens of ``raw`` (balanced, charset 1, nfd, capcode 2) at
    each min occur of ``min_occurs``, from one count: the count and its
    prunes between micro-chunks do not depend on the min occur, so the
    count is made once at the smallest, and each pool is the count's
    tokens that occur at least that often with the extra tokens added, as
    ``get_all_tokens`` finishes a pool (``_finish_get_all_tokens``).
    Returns {min occur: (counter, char_table, header)}."""
    from tokenmonster_tpu_torch.core.normalize import Normalizer
    from tokenmonster_tpu_torch.train import getalltokens as gat

    counted, char_table, _header = gat.get_all_tokens(
        raw, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=min(min_occurs), add_extra_tokens=False)
    len(counted)                              # the native counts, read out
    pools = {}
    for m in min_occurs:
        counter = gat.TokenCounter()
        counter.counts = {k: c for k, c in counted.counts.items() if c >= m}
        pools[m] = gat._finish_get_all_tokens(
            counter, char_table, raw, level=2, using_capcode=2, charset=1,
            normalizer=Normalizer("nfd"), only_latin=False,
            only_valid=False, min_occur_total=m, min_occur_singles=m,
            add_extra_tokens=True)
    return pools


def pool_phase(dev, card: str, raw: bytes, pool_of, min_occur: int,
               work: str, key: str, at_least: int, shift: int,
               candidates: int, rounds: int) -> dict:
    """The trainer and the tokenizer at a pool's scale: the getalltokens
    pool ``pool_of`` (``count_pools``) of ``raw`` at ``min_occur``, whose
    superset must hold at least ``at_least`` entries, armed in REMAP mode;
    match on the masked superset tables, the rank gather, decide and
    follow on candidate-sized tables against their plain versions;
    ``candidates`` seeded 32,000-id candidates scored on the whole text
    against native; seeded ``train_vocab`` rounds against the native
    backend; then the superset vocabulary as a tokenizer at S = ``shift``
    (``wide_tokenizer_phase``).  Returns, per kernel on the path, its
    numbers at these shapes, keys prefixed ``key``."""
    import random
    from types import SimpleNamespace
    from unittest import mock

    from tokenmonster_tpu_torch.core import capcode as cc
    from tokenmonster_tpu_torch.core.normalize import Normalizer
    from tokenmonster_tpu_torch.core.vocab import normalize_and_capcode
    from tokenmonster_tpu_torch.ops import _build, tables
    from tokenmonster_tpu_torch.ops.hashmatch import build_hashmatch
    from tokenmonster_tpu_torch.ops.scan import MARGIN, remap_matches
    from tokenmonster_tpu_torch.parallel.score import score_strips
    from tokenmonster_tpu_torch.train import trainvocab as port
    from tokenmonster_tpu_torch.train.getalltokens import (load_tokens_file,
                                                           save_tokens_file)
    from tokenmonster_tpu_torch.train.score_helpers import \
        candidate_runtime_state

    failed = []

    def check(cond, msg: str) -> None:
        if not cond:
            print(f"FAILED: {msg}", flush=True)
            failed.append(msg)

    native_score = port_native_score
    counter, char_table, header = pool_of
    tok_path = os.path.join(work, f"{key}.tok")
    save_tokens_file(tok_path, counter, char_table, header)
    dic = load_tokens_file(tok_path)
    capcode, norm_flag = dic["using_capcode"], dic["norm_flag"]
    text = normalize_and_capcode(raw, capcode, Normalizer(norm_flag))
    pool = port.superset_pool(tok_path)
    print(f"pool: {len(counter)} candidates from {len(raw)} bytes of "
          f"standard-library text (balanced, charset 1, nfd, capcode 2, "
          f"min occur {min_occur}); superset pool {len(pool)} tokens ('D ' "
          f"forms and the 256 bytes added); {len(text)} normalized bytes "
          f"[{card}]")

    # arm, with its host parts timed: the superset vocabulary
    # (Vocab._generate), the CHD placement, then the upload, key filter
    # and token index
    armed = {}

    class Timed(port.GpuCandidateScorer):
        def build(self, token_list):
            t0 = time.perf_counter()
            v = super().build(token_list)
            armed.setdefault("build_s", time.perf_counter() - t0)
            return v

    def placement(*args, **kw):
        t0 = time.perf_counter()
        out = build_hashmatch(*args, **kw)
        armed["placement_s"] = time.perf_counter() - t0
        return out

    sc = Timed(dic["charset"], capcode, norm_flag, device=dev)
    sc.set_specials([])
    t0 = time.perf_counter()
    with mock.patch.object(port, "build_hashmatch", placement):
        sc.prepare(pool)
    torch.cuda.synchronize()
    arm_s = time.perf_counter() - t0
    sup = sc._sup
    base = sup.tokenizer.tables
    n_sup = len(sup.vocab.tokens)
    require(n_sup >= at_least,
            f"superset of {n_sup} entries, fewer than {at_least}")
    require(base.match_only, "the superset was not armed in REMAP mode")
    fill = _popcount_share(base.filt)
    print(f"superset: {n_sup} entries, armed in REMAP mode in "
          f"{arm_s:.3f} s (vocabulary {armed['build_s']:.3f} s, CHD "
          f"placement {armed['placement_s']:.3f} s, upload, key filter "
          f"and index {arm_s - armed['build_s'] - armed['placement_s']:.3f}"
          f" s); {base.idx1_bits}-bit index fields, token words of its "
          f"vocabulary at S = {tables.w3_shift(sup.vocab)}, match tables "
          f"{nbytes(base.fields, base.disp)} B, key filter "
          f"{1 << base.filt_log2} bits, {100 * fill:.1f}% set [{card}]")

    singles = sorted({t for t in dic["tokens"] if len(t) == 1}
                     | {bytes([b]) for b in (cc.DELETE_TOKEN,
                                             cc.CHARACTER_TOKEN,
                                             cc.WORD_TOKEN)})
    multi = [t for t in pool if len(t) > 1]
    rng = random.Random(TRAIN_SEED)
    tk = sup.tokenizer
    staged = tk.stage(text[:(LANES - 1) * tk.chunk + MARGIN])
    lanes, bufs = staged.lanes, staged.bufs
    require(lanes == LANES, f"{lanes} lanes staged")
    t = SimpleNamespace(buf=bufs[0][0], n=bufs[0][1], tk=tk,
                        t_rec=tk._t_rec(False))
    dispatches = len(tk._plan(len(text))[1])

    errs = dict.fromkeys(TRAIN_KERNELS, 0)
    gather_err = 0
    mask_ms, gather_ms, score_ms, repairs = [], [], [], 0
    for ci in range(candidates):
        rng.shuffle(multi)
        cand = sc.build(singles + multi[:TRAIN_VOCAB - len(singles)])
        t0 = time.perf_counter()
        tabs = candidate_runtime_state(sup, cand)
        torch.cuda.synchronize()
        mask_ms.append((time.perf_counter() - t0) * 1e3)
        pairs, cwork = masked_pairs(t, tabs)
        for name in TRAIN_KERNELS:
            errs[name] = max(errs[name], compare(pairs, name))
        gather, g_work = gather_work(t.buf, t.n, tabs)
        # the gather's plain version: the same torch ops on the host
        m_dev, mb_dev = pairs["match"][0]()
        rank_cpu = tabs.rank.cpu()
        gather_err = max(gather_err, max_abs_err(gather(), tuple(
            remap_matches(w.cpu(), rank_cpu).to(w.device)
            for w in (m_dev, mb_dev))))
        gather_ms.append(cuda_ms(gather, queued=True) * dispatches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got_s, got_t, got_m, r = score_strips(tk, tabs, [text],
                                              len(cand.reverse))
        end.record()
        end.synchronize()
        score_ms.append(start.elapsed_time(end))
        repairs += r
        want_s, want_t, want_m = native_score(cand, [text])
        got_miss = set(np.nonzero(got_m)[0].tolist())
        check(np.array_equal(got_s, want_s) and got_t == want_t
              and got_miss == want_m,
              f"{key} candidate {ci}: scores differ from native")
        print(f"candidate {ci}: {len(cand.reverse)} ids; {got_t} tokens "
              f"(native {want_t}), missing {sorted(got_miss)}, scores "
              f"equal {np.array_equal(got_s, want_s)}, junction repairs "
              f"{r}; match/decide/follow max_abs_err {errs}, rank gather "
              f"max_abs_err {gather_err}")
    check(not any(errs.values()) and not gather_err,
          f"kernels disagree: {errs}, gather {gather_err}")
    g_bound, g_by = bound(*g_work)
    g_ms = cuda_ms(gather)
    g_device_ms = cuda_ms(gather, queued=True)
    print(f"per candidate: host masking {statistics.median(mask_ms):.3f}"
          f" ms (upload and rank included), rank gather "
          f"{statistics.median(gather_ms):.3f} ms on the card alone "
          f"({dispatches} dispatches of two gathers, {g_device_ms:.4f} "
          f"ms a dispatch, {g_ms:.4f} from the host, bound "
          f"{g_bound:.4f} ms, {g_by}), device score "
          f"{statistics.median(score_ms):.3f} ms over {len(text)} bytes "
          f"(CUDA events, read-back included); medians of "
          f"{candidates} [{card}]")

    # train_vocab on the card against the native backend, the loop's own
    # scorer armed on the vocabulary and placement built above
    scored, scorers, score_s, native_score_s = [], [], [], []

    class Recording(port.GpuCandidateScorer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            scorers.append(self)

        def build(self, token_list):
            if len(token_list) == len(pool) and token_list == pool:
                return sup.vocab
            return super().build(token_list)

        def prepare(self, superset_tokens, hashmatch_tables=None):
            same = list(superset_tokens) == pool
            t0 = time.perf_counter()
            super().prepare(superset_tokens,
                            sup.hashmatch if same else None)
            torch.cuda.synchronize()
            self.arm_s = time.perf_counter() - t0

        def score(self, cand, datasets):
            t0 = time.perf_counter()
            res = super().score(cand, datasets)
            score_s.append(time.perf_counter() - t0)
            scored.append((cand, datasets, res))
            return res

    class TimedNative(port.CandidateScorer):
        def score(self, cand, datasets):
            t0 = time.perf_counter()
            res = super().score(cand, datasets)
            native_score_s.append(time.perf_counter() - t0)
            return res

    log = _RoundLog()
    logger = logging.getLogger("tokenmonster_tpu_torch.trainvocab")
    logger.addHandler(log)
    logger.setLevel(logging.INFO)

    def config(backend):
        return port.TrainConfig(vocab_size=TRAIN_VOCAB, workers=2,
                               fast=True, seed=TRAIN_SEED,
                               max_rounds=rounds, backend=backend)

    res_cuda = os.path.join(work, f"{key}_cuda")
    res_native = os.path.join(work, f"{key}_native")
    _build.reset_launches()
    with mock.patch.object(port, "GpuCandidateScorer", Recording):
        rounds_cuda, cuda_s = _train(lambda: port.train_vocab(
            raw, tok_path, res_cuda, config("cuda"), device=dev), log)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    with mock.patch.object(port, "CandidateScorer", TimedNative):
        rounds_native, native_s = _train(lambda: port.train_vocab(
            raw, tok_path, res_native, config("native")), log)
    logger.removeHandler(log)
    for line in rounds_cuda:
        print(f"cuda   {line}")
    check(rounds_cuda == rounds_native,
          f"rounds differ from native: {rounds_native}")
    files = _dir_bytes(res_cuda)
    check(files == _dir_bytes(res_native),
          f"results differ from native's: {sorted(files)}")
    check(len(scorers) == 1
          and scorers[0]._sup.tokenizer.tables.match_only
          and scorers[0].own_table_scores == 0,
          "the loop's scorer was not armed once in REMAP mode, or a "
          "candidate left it")
    for cand, datasets, (got_s, got_t, got_miss) in scored:
        want_s, want_t, want_m = native_score(cand, datasets)
        check(np.array_equal(got_s, want_s) and got_t == want_t
              and got_miss == want_m,
              "a candidate of the REMAP run differs from native")
    check(all(launches[k] > 0 for k in TRAIN_KERNELS),
          f"a trainer kernel was not launched: {launches}")
    arm = scorers[0].arm_s if scorers else 0.0
    written = (f"{len(files)} files equal ({', '.join(sorted(files))})"
               if files else f"no file written by either in {rounds} "
               "rounds (the loop's first checkpoint is its midway "
               "target's)")
    print(f"train_vocab at {n_sup} superset entries: {len(scored)} "
          f"candidates scored on the card and by native, equal; "
          f"{written}; junction repairs "
          f"{scorers[0].repairs if scorers else 0}; launches {launches} "
          f"({launches['match'] / max(1, len(scored)):.0f} dispatches a "
          f"candidate: its strips, one or more each)")
    round_line = (f"wall per round: cuda {(cuda_s - arm) / rounds:.3f} s "
                  f"after a {arm:.3f} s arm (vocabulary and placement "
                  f"shared), of which score calls "
                  f"{sum(score_s) / rounds:.3f} s (two threads); native "
                  f"{native_s / rounds:.3f} s, of which score calls "
                  f"{sum(native_score_s) / rounds:.3f} s "
                  f"({os.cpu_count()} host threads)")
    print(f"{round_line}; op by op by cause "
          f"{scorers[0].eager_scores if scorers else {}} [{card}]")
    require(not failed, f"{key} trainer: {len(failed)} checks failed")
    chain = {}
    if shift == 21:
        phase("trainer at reference scale: the captured score chain "
              "against op by op")

        def next_candidate():
            rng.shuffle(multi)
            return sc.build(singles + multi[:TRAIN_VOCAB - len(singles)])
        chain = score_chain_phase(card, key, sc, {"strips": worker_strips(
            text, TRAIN_SEED)}, next_candidate, native_score, round_line)
    wide = wide_tokenizer_phase(dev, card, sup, raw, text, work, shift,
                                "wide" if shift == 21 else key)

    out = {}
    p = "bigpool" if shift == 21 else f"{key}_pool"
    for name in TRAIN_KERNELS:
        kernel, plain = pairs[name]
        b_ms, b_by = bound(*cwork[name])
        ms = cuda_ms(kernel)
        device_ms = cuda_ms(kernel, queued=True)
        plain_ms = cuda_ms(plain, calls=1, repeat=3)
        tables_of = (f"masked superset of {n_sup}" if name == "match" else
                     f"candidate tables of {tabs.meta.shape[1]} slots")
        out[name] = {f"{p}_launches": launches[name],
                     f"{p}_max_abs_err": errs[name], f"{p}_ms": ms,
                     f"{p}_device_ms": device_ms,
                     f"{p}_plain_ms": plain_ms,
                     f"{p}_bound_ms": b_ms, f"{p}_bound_by": b_by,
                     f"{p}_roofline_share": b_ms / ms,
                     f"{p}_device_roofline_share": b_ms / device_ms}
        print(f"{name}: {key} trainer shapes kernel {ms:.4f} ms from the "
              f"host ({device_ms:.4f} on the card alone), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{cwork[name][0]} B, {cwork[name][1]} ops), roofline "
              f"{100 * b_ms / ms:.2f}% ({100 * b_ms / device_ms:.2f}% of "
              f"the card alone) (N={t.buf.numel()}, {LANES} lanes, "
              f"{tables_of}) [{card}]")
    for name, numbers in wide.items():
        out.setdefault(name, {}).update(numbers)
    for name, numbers in chain.items():
        out[name].setdefault("score_graph_launches", {}).update(numbers)
    out["match"][f"{p}_filter_fill"] = fill
    out["decide"].update({f"{p}_gather_ms": g_ms,
                          f"{p}_gather_device_ms": g_device_ms,
                          f"{p}_gather_bound_ms": g_bound})
    print(f"shared memory at {key} trainer shapes: "
          f"{smem_plan(t.buf, t.n, tabs, LANES, tk.chunk, t.t_rec)}")
    return out


def bigpool_phase(dev, card: str) -> dict:
    """The trainer and the tokenizer at pool scale, two pools of all the
    library's text counted once (``count_pools``): the reference
    configuration's scale, a superset of more than 2^20 entries (S = 21),
    then one of 2^21 - 1 entries or more (22-bit index fields, S = 22),
    each through ``pool_phase``.  Returns, per kernel, both cells'
    numbers."""
    import shutil
    import tempfile

    from tokenmonster_tpu_torch.corpus import stdlib_text

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_bigpool_",
                            dir=os.path.join(ROOT, "build"))
    try:
        raw, _dropped = stdlib_text(None, BIG_BYTES)
        t0 = time.perf_counter()
        pools = count_pools(raw, (BIG_MIN_OCCUR, WIDER_MIN_OCCUR))
        print(f"getalltokens of {len(raw)} bytes, pools at min occur "
              f"{BIG_MIN_OCCUR} and {WIDER_MIN_OCCUR} from one count, in "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        out = pool_phase(dev, card, raw, pools.pop(BIG_MIN_OCCUR),
                         BIG_MIN_OCCUR, work, "bigpool", BIG_ENTRIES + 1, 21,
                         BIG_CANDIDATES, BIG_ROUNDS)
        phase(f"trainer and tokenizer past 2^21 - 2 entries: min occur "
              f"{WIDER_MIN_OCCUR}")
        wider = pool_phase(dev, card, raw, pools.pop(WIDER_MIN_OCCUR),
                           WIDER_MIN_OCCUR, work, "wider", WIDER_ENTRIES, 22,
                           WIDER_CANDIDATES, WIDER_ROUNDS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, numbers in wider.items():
        out.setdefault(name, {}).update(numbers)
    return out

# Imported at start-up by every Python process of the shell pipeline (it is
# put first on PYTHONPATH): refuses jax and the JAX package, seeds
# random.Random's default (the CLI has no seed flag, and two trainvocab
# runs compare only on the same draws) and reports the kernel launches at
# exit.
PIPELINE_SITE = r"""
import atexit, json, os, random, sys

REFUSED = ("jax", "tokenmonster_tpu")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, _Refuse())
_seed = os.environ.get("SMOKE_RANDOM_SEED")
if _seed is not None:
    class _Seeded(random.Random):
        def __init__(self, x=None):
            super().__init__(int(_seed) if x is None else x)

    random.Random = _Seeded


@atexit.register
def _report():
    b = sys.modules.get("tokenmonster_tpu_torch.ops._build")
    print("LAUNCHES " + json.dumps(dict(b.launches) if b else {}),
          file=sys.stderr, flush=True)
"""


def cli_phase(dev, card: str) -> dict:
    """The pipeline from the shell, each step ``python -m
    tokenmonster_tpu_torch ...`` in a process that refuses jax and the JAX
    package: getalltokens on the trainer phase's configuration, trainvocab
    with ``-backend cuda`` against ``-backend native`` (every file equal),
    exportvocab; then the exported vocabulary through ``load(...,
    device="cuda")`` on the main path's text (FNV-equal to native, no
    fallback) and through ``load_multiprocess_safe`` (its server spawned by
    the client on the card, refusing both names too: the main text on its
    device route, whose launches it reports, and 64 KiB on its host
    route).  Returns the kernel launches of the in-process tokenize."""
    import shutil
    import tempfile

    import tokenmonster_tpu_torch as tt
    from tokenmonster_tpu_torch.core.vocab import Vocab
    from tokenmonster_tpu_torch.corpus import stdlib_text
    from tokenmonster_tpu_torch.native import NativeVocab
    from tokenmonster_tpu_torch.ops import _build

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_",
                            dir=os.path.join(ROOT, "build"))
    site = os.path.join(work, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(PIPELINE_SITE)
    path = os.pathsep.join([site, ROOT] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    env = {**os.environ, "PYTHONPATH": path,
           "SMOKE_RANDOM_SEED": str(TRAIN_SEED)}

    def cli(*args) -> tuple[str, dict, float]:
        """(stdout, kernel launches, seconds) of one command."""
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "tokenmonster_tpu_torch", *args],
            cwd=work, env=env, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        require(res.returncode == 0, f"{args[0]} exited {res.returncode}: "
                                     f"{res.stderr[-3000:]}")
        line = [ln for ln in res.stderr.splitlines()
                if ln.startswith("LAUNCHES ")]
        require(len(line) == 1, f"{args[0]}: the refusing start-up did not "
                                "run")
        print(f"$ python -m tokenmonster_tpu_torch {' '.join(args)}: "
              f"{secs:.1f} s; {res.stdout.strip().splitlines()[-1]}")
        return res.stdout, json.loads(line[0][9:]), secs

    try:
        raw, _dropped = stdlib_text(None, TRAIN_BYTES)
        with open(os.path.join(work, "data.txt"), "wb") as f:
            f.write(raw)
        cli("getalltokens", "-dataset", "data.txt", "-output", "pool.tok",
            "-mode", "balanced", "-charset", "utf-8", "-norm", "nfd",
            "-capcode", "2", "-min-occur", str(TRAIN_MIN_OCCUR))
        train = ("trainvocab", "-dataset", "data.txt", "-dictionary",
                 "pool.tok", "-vocab-size", str(TRAIN_VOCAB), "-workers",
                 "2", "-fast", "-max-rounds", str(CLI_ROUNDS))
        _out, cuda_launches, cuda_s = cli(*train, "-dir", "cuda",
                                          "-backend", "cuda", "-device",
                                          dev.type)
        _out, native_launches, native_s = cli(*train, "-dir", "native",
                                              "-backend", "native")
        files = _dir_bytes(os.path.join(work, "cuda"))
        require(files and files == _dir_bytes(os.path.join(work, "native")),
                f"trainvocab -backend cuda wrote other files than native: "
                f"{sorted(files)}")
        require(all(cuda_launches.get(k, 0) > 0 for k in TRAIN_KERNELS)
                and not any(native_launches.values()),
                f"launches: cuda {cuda_launches}, native {native_launches}")
        print(f"trainvocab: {CLI_ROUNDS} rounds, -backend cuda "
              f"{cuda_s:.1f} s (launches {cuda_launches}), -backend native "
              f"{native_s:.1f} s; the {len(files)} files are equal "
              f"({', '.join(sorted(files))}) [{card}]")
        cli("exportvocab", "-input", "cuda", "-output", "out.vocab")
        exported = os.path.join(work, "out.vocab")

        core = Vocab.load(exported)
        text, dropped = stdlib_text(core, MAIN_BYTES)
        vocab = tt.load(exported, device=dev, route="device")
        want, _wmiss = NativeVocab(core).tokenize(core.normalize(text))
        _build.reset_launches()
        t0 = time.perf_counter()
        ids = np.asarray(vocab.tokenize(text), np.uint32)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = dict(_build.launches)
        tk = vocab._tpu
        require(vocab.last_route == "device" and tk.host_fallbacks == 0,
                f"route {vocab.last_route}, fallbacks {tk.fallbacks}")
        require(fnv1a64(ids) == fnv1a64(want) and np.array_equal(ids, want),
                "the exported vocabulary's ids differ from native")
        require(all(launches[k] > 0 for k in TPU_KERNELS),
                f"a kernel was not launched: {launches}")
        print(f"exported vocabulary: {len(core)} tokens; load(..., "
              f"device='cuda').tokenize of {len(text)} bytes ({dropped} "
              f"lines dropped): {len(ids)} ids, fnv1a64 {fnv1a64(ids):016x} "
              f"equal to native, fallbacks {tk.fallbacks}, launches "
              f"{launches}, {e2e_s * 1e3:.1f} ms (first call) [{card}]")

        # the server subprocess inherits this process's stderr: send it to
        # a file while the server lives, for its LAUNCHES line at exit
        piece = text[:64 << 10]
        piece = piece[:piece.rfind(b"\n") + 1]
        saved = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = path
        err_path = os.path.join(work, "server.err")
        sys.stderr.flush()
        saved_err = os.dup(2)
        with open(err_path, "wb") as err:
            os.dup2(err.fileno(), 2)
        try:
            remote = tt.load_multiprocess_safe(exported)   # device "cuda"
            try:
                t0 = time.perf_counter()
                big = np.asarray(remote.tokenize(text), np.uint32)
                remote_s = time.perf_counter() - t0
                got = np.asarray(remote.tokenize(piece), np.uint32)
                decoded = remote.decode(got)
                remote.unload()
            finally:
                remote._server.close()
        finally:
            sys.stderr.flush()
            os.dup2(saved_err, 2)
            os.close(saved_err)
            if saved is None:
                del os.environ["PYTHONPATH"]
            else:
                os.environ["PYTHONPATH"] = saved
        with open(err_path, errors="replace") as f:
            err_lines = f.read().splitlines()
        line = [ln for ln in err_lines if ln.startswith("LAUNCHES ")]
        require(len(line) == 1, "the server's refusing start-up did not run: "
                                f"{err_lines[-20:]}")
        server_launches = json.loads(line[0][9:])
        require(np.array_equal(big, want), "the server's ids of the main "
                                           "text differ from native")
        want_p, _m = NativeVocab(core).tokenize(core.normalize(piece))
        require(np.array_equal(got, want_p), "the server's ids differ "
                                             "from native")
        require(decoded == vocab.decode(got),
                "the server's decode differs from load(...).decode")
        require(all(server_launches.get(k, 0) > 0 for k in TPU_KERNELS),
                f"the server did not tokenize on the card: launches "
                f"{server_launches}")
        print(f"load_multiprocess_safe (server -device cuda): {len(text)} "
              f"bytes through the server subprocess, {len(big)} ids equal "
              f"to native, {remote_s * 1e3:.1f} ms (first call, pipe "
              f"included), the server's launches {server_launches}; "
              f"{len(piece)} bytes on its host route, {len(got)} ids equal "
              f"to native [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1

    phase("device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    import tokenmonster_tpu_torch as tt
    from tokenmonster_tpu_torch.core.vocab import Vocab
    from tokenmonster_tpu_torch.corpus import one_row_vocab, stdlib_text
    from tokenmonster_tpu_torch.native import NativeVocab
    from tokenmonster_tpu_torch.ops import _build
    require_self_contained("the port")

    phase("build")
    t0 = time.perf_counter()
    cached = os.path.exists(_build.library_path())
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s "
          f"({'reused' if cached else 'compiled'} {_build.library_path()})")

    phase("kernels against plain versions (tolerance 0)")
    core = Vocab.load(VOCAB)
    raw, dropped = stdlib_text(core, MAIN_BYTES)
    require(len(raw) >= MAIN_BYTES, f"only {len(raw)} bytes of text")
    errs = {}
    N, pairs, work, plan = stage_pairs(core, raw, dev, downstream=True)
    for name in TPU_KERNELS:
        errs[name] = compare(pairs, name)
        print(f"{name}: realtext-32000 two rows, N={N}, {LANES} lanes x "
              f"{CHUNK}: max_abs_err {errs[name]}")
    N1, pairs1, _work1, _plan1 = stage_pairs(one_row_vocab(core), raw, dev,
                                             downstream=False)
    for name in pairs1:
        err = compare(pairs1, name)
        print(f"{name}: capcode-0 one row, N={N1}: max_abs_err {err}")
        errs[name] = max(errs[name], err)
    require(not any(errs.values()), f"kernels disagree: {errs}")

    phase("main path: load(...).tokenize on real text")
    print(f"text: {len(raw)} bytes of standard-library files, {dropped} "
          f"lines dropped for bytes the vocabulary lacks")
    vocab = tt.load(VOCAB, device="cuda")
    nv = NativeVocab(core)
    norm = core.normalize(raw)
    want, wmiss = nv.tokenize(norm)
    _build.reset_launches()
    ids = vocab.tokenize(raw)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    require(vocab.last_route == "device",
            f"the call took the {vocab.last_route} route")
    tk = vocab._tpu
    require(tk.tables.w3_shift == 20,
            f"token words at shift {tk.tables.w3_shift}, not 20")
    print(f"route {vocab.last_route}, launches {launches} (the first call "
          f"of its geometry: the warm-up before the capture, then the "
          f"replay), captures {tk.captures}, last_mode {tk.last_mode}, "
          f"fallbacks {tk.fallbacks}, dispatches "
          f"{len(tk._plan(len(norm))[1])}")
    ids32 = np.asarray(ids, np.uint32)
    require(np.array_equal(ids32, want), "ids differ from native")
    h_got, h_want = fnv1a64(ids32), fnv1a64(want)
    print(f"{len(ids32)} ids, fnv1a64 {h_got:016x} (native {h_want:016x})")
    require(h_got == h_want, "fnv differs from native")
    _ids, missing = tk.tokenize(norm)
    require(missing == 0 == wmiss, f"missing {missing}, native {wmiss}")
    require(tk.host_fallbacks == 0, "the device path fell back to the host")
    require(all(launches[k] > 0 for k in TPU_KERNELS),
            f"a kernel was not launched: {launches}")

    sizes = (3 << 20, 64 << 10, 5 << 19, 500)
    lines = raw.splitlines(keepends=True)
    batch_raw = []
    for i, size in enumerate(sizes):   # whole lines: a cut character
        item, at, got = [], 1000 * i, 0  # would be a byte the vocab lacks
        while got < size:
            item.append(lines[at])
            got += len(lines[at])
            at += 1
        batch_raw.append(b"".join(item))
    vocab.route = "device"      # every item, small ones too, on the card
    before = dict(vocab.route_counts)
    _build.reset_launches()
    batch = vocab.tokenize(batch_raw)
    batch_launches = dict(_build.launches)
    require(vocab.route_counts["device"] == before["device"] + len(sizes),
            f"a batch item took another route: {vocab.route_counts}")
    require(tk.host_fallbacks == 0, "a batch item fell back")
    for item, got in zip(batch_raw, batch):
        w, _m = nv.tokenize(core.normalize(item))
        require(np.array_equal(np.asarray(got, np.uint32), w),
                f"batch item of {len(item)} bytes differs from native")
    require(all(batch_launches[k] >= len(sizes) for k in TPU_KERNELS),
            f"a batch item skipped a kernel: {batch_launches}")
    print(f"batch of {len(sizes)} "
          f"({', '.join(str(len(b)) for b in batch_raw)} bytes) "
          f"equals native; launches {batch_launches}")

    phase("counted host fallback")
    short = b"a byte the vocabulary lacks: \x01 here"
    fids = vocab.tokenize(short)
    wf, wfm = nv.tokenize(core.normalize(short))
    require(vocab.last_route == "device", "the short text was not routed "
                                          "to the device path")
    require(tk.fallbacks == {"missing_byte": 1},
            f"fallbacks {tk.fallbacks}, expected one missing_byte")
    require(np.array_equal(np.asarray(fids, np.uint32), wf) and wfm > 0,
            "fallback ids differ from native")
    print(f"fallbacks {tk.fallbacks}, last_mode {tk.last_mode}, "
          f"{len(fids)} ids equal native, native missing {wfm}")

    phase(f"times on {card} (median of {REPEAT} runs)")
    # what a launch costs: an empty kernel through the wrappers' launch
    # path, timed as the kernels are: launched back to back from the host
    # (its enqueue included, the slower side for every short kernel), and
    # queued behind a spin (the card alone)
    floor_ms = cuda_ms(lambda: _build.spin(dev))
    floor_device_ms = cuda_ms(lambda: _build.spin(dev), queued=True)
    print(f"launch floor: an empty kernel {floor_ms:.4f} ms per launch "
          f"back to back from the host, {floor_device_ms:.4f} ms on the "
          f"card alone [{card}]")
    kernels = []
    for name in TPU_KERNELS:
        kernel, plain = pairs[name]
        ms = cuda_ms(kernel)
        device_ms = cuda_ms(kernel, queued=True)
        plain_ms = cuda_ms(plain, calls=1)
        b_ms, b_by = bound(*work[name])
        print(f"{name}: kernel {ms:.4f} ms launched back to back from the "
              f"host, {ms / floor_ms:.1f}x the launch floor ({device_ms:.4f} "
              f"on the card alone, {device_ms / floor_device_ms:.1f}x that "
              f"floor), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {work[name][0]} B, {work[name][1]} ops), roofline "
              f"{100 * b_ms / ms:.2f}% ({100 * b_ms / device_ms:.2f}% of "
              f"the card alone) "
              f"(N={N}, {LANES} lanes; no library call: {LIBRARY[name]}) "
              f"[{card}]")
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": TPU_KERNELS[name],
                        "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms,
                        "device_ms": device_ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "roofline_share": b_ms / ms,
                        "device_roofline_share": b_ms / device_ms,
                        "library_ms": None, "launch_floor_ms": floor_ms,
                        "launch_floor_device_ms": floor_device_ms})
    print(f"shared memory at main-path shapes: {plan}")
    staged = tk.stage(norm)
    tk.tokenize_staged(staged, norm)
    chain_s = host_seconds(lambda: tk._run_staged(staged, False, tk.tables,
                                                  tk._compact, {}))
    print(f"device chain: {len(norm) / chain_s / 1e6:.3f} MB/s over "
          f"{len(norm)} normalized bytes ({chain_s * 1e3:.3f} ms) [{card}]")
    e2e = []
    before = vocab.route_counts["device"]
    for _ in range(REPEAT):                 # route pinned to "device"
        t0 = time.perf_counter()
        vocab.tokenize(raw)
        e2e.append(time.perf_counter() - t0)
    require(vocab.route_counts["device"] == before + REPEAT,
            "a timed call did not take the device route")
    require(tk.fallbacks == {"missing_byte": 1}, "a timed call fell back")
    e2e_s = statistics.median(e2e)
    print(f"e2e load().tokenize: {len(raw) / e2e_s / 1e6:.3f} MB/s over "
          f"{len(raw)} raw bytes ({e2e_s * 1e3:.3f} ms, normalization and "
          f"id download included) [{card}]")
    nat = []
    for _ in range(REPEAT):
        t0 = time.perf_counter()
        nv.tokenize(norm)
        nat.append(time.perf_counter() - t0)
    nat_s = statistics.median(nat)
    print(f"native: {len(norm) / nat_s / 1e6:.3f} MB/s over {len(norm)} "
          f"normalized bytes, {os.cpu_count()} host threads [{card}]")
    phase("main tokenizer: the captured chain against eager")
    CAPTURED["main"] = captured_chain_phase(card, "main", vocab, raw, want)

    import shutil
    import tempfile
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_trainer_",
                            dir=os.path.join(ROOT, "build"))
    try:
        phase("trainer: candidate scoring and train_vocab")
        trainer, shared = trainer_phase(dev, card, work)
        require_self_contained("the trainer")
        phase("trainer: candidates on their own tables")
        own = own_tables_phase(dev, card, shared.inputs)
        phase("trainer: the captured score chain against op by op")
        t = shared.inputs
        chain = score_chain_phase(
            card, "trainer", t.sc, {"strips": worker_strips(t.text,
                                                            TRAIN_SEED),
                                    "full text": [t.text]},
            t.candidate, port_native_score,
            f"wall per round (trainer phase): cuda {shared.round_s:.3f} s, "
            f"native {shared.native_round_s:.3f} s")
        for name, numbers in chain.items():
            trainer[name]["score_graph_launches"] = numbers
        phase("getalltokens: the window sort on the card")
        device_sort = sort_phase(dev, card, shared)
        phase("trainer: multi-device scoring, two slots and two processes")
        multidevice = multidevice_phase(dev, card, shared)
        require_self_contained("multi-device scoring")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase("trainer at reference pool scale: REMAP mode")
    bigpool = bigpool_phase(dev, card)
    require_self_contained("the reference-scale trainer")
    phase("the pipeline from the shell")
    pipeline = cli_phase(dev, card)
    require_self_contained("the pipeline")
    for k in kernels:
        # the score graph's launches a candidate, by cell
        graphs = {cell: n for part in (trainer, bigpool)
                  for cell, n in part.get(k["name"], {}).get(
                      "score_graph_launches", {}).items()}
        k.update(trainer.get(k["name"], {}))
        k.update(own.get(k["name"], {}))
        k.update(bigpool.get(k["name"], {}))
        k["score_graph_launches"] = graphs
        k["pipeline_launches"] = pipeline[k["name"]]
        if k["name"] in TRAIN_KERNELS:
            k["two_slot_launches"] = multidevice["two_slot_launches"][
                k["name"]]
            k["rank_launches"] = [r[k["name"]]
                                  for r in multidevice["rank_launches"]]

    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor_ms,
                      "launch_floor_device_ms": floor_device_ms,
                      "not_kernels": [device_sort],
                      "captured_chain": CAPTURED}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
