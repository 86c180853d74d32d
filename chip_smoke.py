#!/usr/bin/env python3
"""Smoke run of tokenmonster_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/, holds each against its plain PyTorch
version at the main path's shapes (realtext-32000, chunk 2048, 512 lanes,
two forward-delete rows; a capcode-0 vocabulary for the one-row match and
decide), drives the main path ``load(vocab, device="cuda").tokenize(text)``
over at least 4 MiB of real text and a mixed batch, checks the ids against
the native host tokenizer, shows the counted host fallback, and times each
kernel beside its plain version, the staged device chain, the end-to-end
call and the native tokenizer.

The trainer phase distils a getalltokens pool of 8 MiB of real text toward
32,000 ids: match, decide and follow on a candidate's masked superset
tables against their plain versions, ``GpuCandidateScorer.score`` against
the native scorer on the whole text, the junction repair on a forced run,
and three seeded rounds of the port's ``train_vocab`` on the card against
its native backend (every scored candidate, the deletions of each round,
the files written), with times.

Phases print as they go; any failure raises and exits non-zero.  The line
before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository around it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

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
TRAIN_ROUNDS = 3
TRAIN_SEED = 7
TRAIN_KERNELS = ("match", "decide", "follow")
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


def cuda_ms(fn, repeat: int = REPEAT, calls: int = 10) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``calls`` back-to-back calls, median of ``repeat`` such runs, after one
    warm-up call.  A call shorter than its host-side launch cost measures
    that cost."""
    fn()
    times = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
    """The match words and text read, the metadata planes, the ctl and tok
    words written; about 60 operations per branch score set (6 branches of
    about 10) per position and row."""
    rows = 2 if mb is not None else 1
    ins = nbytes(m, buf, tabs.meta, tabs.bb) + (nbytes(mb) if rows > 1 else 0)
    return ins + 2 * 4 * rows * buf.numel(), 60 * rows * buf.numel()


def follow_work(recs):
    """The ctl and tok words of each step taken (this run's steps: its
    nonzero records), the records and token words written; about 10
    operations a step."""
    steps = int((recs != 0).sum())
    return 8 * steps + 2 * nbytes(recs), 10 * steps


def compact_work(kept: int, lanes: int):
    """The kept records and token words read, the lanes' ranges, the words
    written; two operations a word."""
    return 8 * kept + 12 * lanes + 4 * kept, 2 * kept


def smem_plan(buf, n: int, tabs, lanes: int, chunk: int, t_rec: int) -> str:
    """How the match and follow kernels use shared memory at these shapes,
    as their launchers plan it on this card."""
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
    where = "shared" if disp.value else "global"
    return (f"match {m_bytes} B per block, displacements "
            f"({nbytes(tabs.disp)} B) in {where} memory, key filter "
            f"{1 << tabs.filt_log2} bits; follow tile {tile} of the {fa.W}-position window per lane and row")


def stage_pairs(vocab, raw: bytes, device, downstream: bool):
    """One main-path dispatch (512 lanes of 2048 bytes) of real text and,
    for each kernel on its path, (kernel call, plain call) closures on the
    same inputs, and its (bytes, operations).  ``downstream`` adds follow
    and compact, which need the dispatch to sync."""
    from tokenmonster_tpu_torch.corpus import main_dispatch
    from tokenmonster_tpu_torch.ops import stitch
    from tokenmonster_tpu_torch.ops.decide import decide, decide_plain
    from tokenmonster_tpu_torch.ops.follow import follow, follow_plain
    from tokenmonster_tpu_torch.ops.match import match, match_plain
    from tokenmonster_tpu_torch.ops.scan import OVERLAP_SCAN
    tk, buf, n = main_dispatch(vocab, raw, device, CHUNK, LANES)
    tabs = tk.tables
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
    recs, toks, done = follow(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec)
    require(int(done) == 1, "main-path dispatch overflowed its window")
    _f, keep, _sn, ok, s, e = stitch.stitched_keep(recs, 0, LANES - 2, False)
    require(bool(ok), "main-path dispatch did not sync")
    counts = keep.sum(0)
    q = (counts.cumsum(0) - counts - s).to(torch.int32)
    s, e = s.to(torch.int32), e.clamp(max=t_rec - 1).to(torch.int32)
    cap = t_rec * LANES
    pairs["follow"] = (
        lambda: follow(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec),
        lambda: follow_plain(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec))
    pairs["compact"] = (
        lambda: stitch.compact(recs, toks, s, e, q, cap),
        lambda: stitch.compact_plain(recs, toks, s, e, q, cap))
    work["follow"] = follow_work(recs)
    work["compact"] = compact_work(int(counts.sum()), LANES)
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
    print(f"pool: {len(counter)} candidates from {len(raw)} bytes of "
          f"standard-library text (balanced, capcode 2, nfd, min occur "
          f"{TRAIN_MIN_OCCUR}) in {time.perf_counter() - t0:.1f} s")
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
    _n, lanes, bufs = tk.stage(text[:(LANES - 1) * tk.chunk + MARGIN])
    require(lanes == LANES, f"{lanes} lanes staged")
    buf, n, _last = bufs[0]
    return SimpleNamespace(raw=raw, tok_path=tok_path, norm_flag=norm_flag,
                           text=text, sc=sc, tk=tk, buf=buf, n=n,
                           t_rec=tk._t_rec(False), candidate=candidate)


def masked_pairs(t, tabs):
    """(kernel, plain) closures of the trainer's kernels on one
    candidate's tables and ``trainer_inputs`` ``t``'s dispatch, on the
    same inputs, and each one's (bytes, operations)."""
    from tokenmonster_tpu_torch.ops.decide import decide, decide_plain
    from tokenmonster_tpu_torch.ops.follow import follow, follow_plain
    from tokenmonster_tpu_torch.ops.match import match, match_plain
    from tokenmonster_tpu_torch.ops.scan import OVERLAP_SCAN
    buf, n, chunk, t_rec = t.buf, t.n, t.tk.chunk, t.t_rec
    m, mb = match(buf, n, tabs)
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


def trainer_phase(dev, card: str) -> dict:
    """Candidate scoring and ``train_vocab`` on the card; returns, per
    kernel on the trainer's path, its trainer-shape numbers."""
    import shutil
    import tempfile
    from unittest import mock

    from tokenmonster_tpu_torch.native import load_native
    from tokenmonster_tpu_torch.ops import _build
    from tokenmonster_tpu_torch.parallel.score import score_strips
    from tokenmonster_tpu_torch.train import trainvocab as port
    from tokenmonster_tpu_torch.train.score_helpers import \
        candidate_runtime_state

    failed = []
    load_native()

    def native_score(cand, datasets):
        """The native trainer scorer (``tm_tokenize_score``): the port's
        ``CandidateScorer(backend="native").score``."""
        return port.CandidateScorer(cand.charset, cand.using_capcode,
                                   cand.normalizer.flag).score(cand, datasets)

    def check(cond, msg: str) -> None:
        """Record a failed check; the phase fails at its end, after every
        check has run and printed."""
        if not cond:
            print(f"FAILED: {msg}", flush=True)
            failed.append(msg)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_trainer_",
                            dir=os.path.join(ROOT, "build"))
    try:
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
        check(len(scorers) == 1, f"{len(scorers)} scorers armed")
        for cand, datasets, (got_s, got_t, got_miss) in scored:
            want_s, want_t, want_m = native_score(cand, datasets)
            check(np.array_equal(got_s, want_s) and got_t == want_t
                  and got_miss == want_m,
                  "a candidate of the cuda run differs from native")
        check(all(launches[k] > 0 for k in TRAIN_KERNELS),
              f"a trainer kernel was not launched: {launches}")
        print(f"train_vocab: {len(scored)} candidates scored on the card "
              f"and by native, {len(files)} files written "
              f"({', '.join(sorted(files))}); junction repairs "
              f"{scorers[0].repairs}, every byte on the card; launches "
              f"{launches}")
        arm = scorers[0].arm_s if scorers else 0.0
        print(f"wall per round: cuda {(cuda_s - arm) / TRAIN_ROUNDS:.3f} s "
              f"after a {arm:.3f} s superset arm, native "
              f"{native_s / TRAIN_ROUNDS:.3f} s ({os.cpu_count()} host "
              f"threads) [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    out = {}
    for name in TRAIN_KERNELS:
        kernel, plain = pairs[name]
        b_ms, b_by = bound(*cwork[name])
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, calls=1)
        out[name] = {"trainer_launches": launches[name],
                     "trainer_max_abs_err": errs[name], "trainer_ms": ms,
                     "trainer_plain_ms": plain_ms,
                     "trainer_bound_ms": b_ms, "trainer_bound_by": b_by,
                     "trainer_roofline_share": b_ms / ms}
        print(f"{name}: trainer shapes kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{cwork[name][0]} B, {cwork[name][1]} ops), roofline "
              f"{100 * b_ms / ms:.2f}% (N={t.buf.numel()}, {LANES} lanes, "
              f"masked superset of {len(sup.vocab.tokens)}) [{card}]")
    print(f"shared memory at trainer shapes: "
          f"{smem_plan(t.buf, t.n, tabs, LANES, tk.chunk, t.t_rec)}")
    require(not failed, f"trainer phase: {len(failed)} checks failed")
    return out


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
    print(f"route {vocab.last_route}, launches {launches}, last_mode "
          f"{tk.last_mode}, fallbacks {tk.fallbacks}, dispatches "
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
    require(tk.fallbacks == {"missing_byte": 1, "junction": 0},
            f"fallbacks {tk.fallbacks}, expected one missing_byte")
    require(np.array_equal(np.asarray(fids, np.uint32), wf) and wfm > 0,
            "fallback ids differ from native")
    print(f"fallbacks {tk.fallbacks}, last_mode {tk.last_mode}, "
          f"{len(fids)} ids equal native, native missing {wfm}")

    phase(f"times on {card} (median of {REPEAT} runs)")
    kernels = []
    for name in TPU_KERNELS:
        kernel, plain = pairs[name]
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, calls=1)
        b_ms, b_by = bound(*work[name])
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}, {work[name][0]} B, "
              f"{work[name][1]} ops), roofline {100 * b_ms / ms:.2f}% "
              f"(N={N}, {LANES} lanes; no library call: {LIBRARY[name]}) "
              f"[{card}]")
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": TPU_KERNELS[name],
                        "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "roofline_share": b_ms / ms,
                        "library_ms": None})
    print(f"shared memory at main-path shapes: {plan}")
    staged = tk.stage(norm)
    tk.tokenize_staged(staged)
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
    require(tk.fallbacks["missing_byte"] == 1
            and tk.fallbacks["junction"] == 0, "a timed call fell back")
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

    phase("trainer: candidate scoring and train_vocab")
    trainer = trainer_phase(dev, card)
    require_self_contained("the trainer")
    for k in kernels:
        k.update(trainer.get(k["name"], {}))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
