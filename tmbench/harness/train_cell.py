"""Cells whose traffic is of kind "train": the vocabulary trainer's early
rounds, ``train_vocab(corpus, pool, results, TrainConfig(...),
device=device, on_round=window)``, the loop as a user runs it.

Set-up makes the corpus (``inputs.corpus``) and the getalltokens pool
(``pool``, kept in ``.tmbench_cache/pool/`` like the corpus, so a
checkout's first run builds it), then starts the loop: its normalization
of the corpus, the arming of its superset and round 1, which warms every
shape the rounds use (a capture each), all untimed.  The window is
``rounds.RoundWindow``: it opens at round 1's end and closes at the first
round boundary at least ``--seconds`` on and ``min_rounds`` rounds in,
where the hook stops the loop.  The training seed is ``--seed``, so two
runs of a seed make the same rounds.  ``tokenize_MBps`` is the strip
bytes every candidate of the window's rounds scored over the window's
seconds.

Once the window has closed, ``check`` holds the run against the plain
reference: every window round's deletions recomputed from the program's
own scores by the frozen rule (``reference/trainer.py``), every candidate
of the window's first and last rounds built as its token list says and
scored whole by the reference's loop (``reference/candidates.py``), each
strip found in the reference's own normalization of the corpus, and the
pool (``reference/pool_check.py``)."""

from __future__ import annotations

import gc
import hashlib
import inspect
import logging
import os
import tempfile
import time

import numpy as np

from . import inputs
from .rounds import RoundWindow
from .spans import Spans
from .trace import Trace

CHARSETS = {"utf-8": 1}


class Run:
    """What one run of a trainer cell measured and kept for its check."""

    def __init__(self):
        self.info = {}
        self.attempted = 0      # candidates scored in the window
        self.failed = 0         # a candidate that fails raises, and the
                                # run with it
        self.metrics = {}
        self.ctx = {}


def hooked() -> bool:
    """Whether the program's ``train_vocab`` takes the ``on_round`` hook
    the window is made of."""
    from tokenmonster_tpu_torch.train import trainvocab
    return "on_round" in inspect.signature(trainvocab.train_vocab).parameters


def pool(config: dict, corpus: bytes):
    """(path, info) of the configuration's getalltokens pool of
    ``corpus``: made with the program's ``get_all_tokens`` at the
    configuration's header, mode and ``min_occur``, kept by a key of what
    it was made from."""
    from tokenmonster_tpu_torch.train.getalltokens import (get_all_tokens,
                                                           save_tokens_file)
    p = config["pool"]
    key = inputs._key(p, config["capcode"], config["charset"],
                      config["normalization"],
                      hashlib.sha256(corpus).hexdigest())
    path = inputs._stored("pool", key, ".tok")
    made_s, cached = 0.0, os.path.exists(path)
    if not cached:
        t0 = time.perf_counter()
        counter, chars, header = get_all_tokens(
            corpus, p["mode"], charset=CHARSETS[config["charset"]],
            normalization=config["normalization"],
            using_capcode=config["capcode"], min_occur_total=p["min_occur"])
        save_tokens_file(path + ".part.tok", counter, chars, header)
        os.replace(path + ".part.tok", path)
        made_s = time.perf_counter() - t0
    return path, {"sha256": inputs.sha256_file(path), "made_s": made_s,
                  "from_cache": cached}


def normalized(config: dict, corpus: bytes, reference) -> bytes:
    """The reference's own normalization of ``corpus`` (kept like the
    corpus)."""
    from ..reference.core.vocab import Vocab
    v = Vocab.load(inputs.vocab_file(config))
    key = inputs._key("normalized", hashlib.sha256(corpus).hexdigest(),
                      v.normalizer.flag, v.using_capcode)
    path = inputs._stored("normalized", key, ".bin")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    text = reference.normalize([corpus], v.normalizer.flag,
                               v.using_capcode)[0]
    inputs._write(path, text)
    return text


class _Log(logging.Handler):
    """The trainer's log lines of the run."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _dispatches(work: list, tables: list):
    """The recorders of the window's match work, (buffer size, bytes to
    match) a dispatch: a batch's rows, a strip scored again, a repair
    lane; the superset's tables kept once."""
    def batch(b, args):
        tables[:1] = [args[0].tables]
        width = b.text.shape[-1]
        work.extend((width, int(n)) for n in b.host_scalars[..., 0].ravel()
                    if n > 0)

    def again(out, args):
        work.extend((buf.numel(), n) for buf, n, _last in args[1].bufs
                    if n > 0)

    def lane(out, args):
        from tokenmonster_tpu_torch.ops.scan import GRAIN, MARGIN
        _tk, _tabs, data, at, span = args
        n = min(len(data) - at, span + MARGIN)
        work.append((-(-(n + 64) // GRAIN) * GRAIN, n))
    return batch, again, lane


def run(cell, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, reference) -> Run:
    if not hooked():
        raise RuntimeError("train_vocab takes no on_round hook: this "
                           "program cannot close a window on its rounds")
    from tokenmonster_tpu_torch import tracing
    from tokenmonster_tpu_torch.ops.scan import GpuTokenizer
    from tokenmonster_tpu_torch.train import trainvocab as tv

    cfg, mix, out = cell.config, cell.traffic, Run()
    corpus, dropped, made_s, cached = inputs.corpus(cfg, reference)
    out.info["corpus"] = {"bytes": len(corpus), "lines_dropped": dropped,
                          "sha256": hashlib.sha256(corpus).hexdigest(),
                          "made_s": made_s, "from_cache": cached}
    pool_path, out.info["pool"] = pool(cfg, corpus)

    spans, work, tables = Spans(), [], []
    trace = Trace() if traced else None

    def opened():
        gc.collect()
        if traced:
            batch, again, lane = _dispatches(work, tables)
            spans.wrap(GpuTokenizer, "stage_batch", "stage_batch",
                       on_return=batch)
            spans.wrap(GpuTokenizer, "run_recorded", "run_recorded",
                       on_return=again)
            spans.wrap(GpuTokenizer, "chain", "chain", on_return=lane)
            tracing.clear()
            trace.start()

    def closed():
        if traced:
            if device != "cpu":
                import torch
                torch.cuda.synchronize()
            trace.stop()

    window = RoundWindow(seconds, mix["min_rounds"], on_open=opened,
                         on_close=closed)
    t = cfg["train"]
    config = tv.TrainConfig(vocab_size=t["vocab_size"], fast=t["fast"],
                            workers=t["workers"], percentage=t["percentage"],
                            strips=t["strips"], seed=seed)
    logs = _Log()
    logger = logging.getLogger("tokenmonster_tpu_torch.trainvocab")
    logger.addHandler(logs)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        with tempfile.TemporaryDirectory(prefix="tmbench_train_") as results:
            tv.train_vocab(corpus, pool_path, results, config, device=device,
                           on_round=window)
    finally:
        logger.removeHandler(logs)
        logger.setLevel(level)
        spans.restore()
    if not window.closed:
        raise RuntimeError(f"the loop ended after {len(window.rounds)} "
                           "window rounds, before the window closed")

    w0, w1 = window.t0, window.t1
    out.info["log"] = [m for m in logs.lines if not m.startswith("round ")]
    out.info["warm_up"] = {"round": window.warm.number,
                           "remaining": window.warm.remaining,
                           "counters": window.warm.counters}
    first, last = window.rounds[0], window.rounds[-1]
    out.info["window"] = {
        "seconds": w1 - w0, "rounds": [first.number, last.number],
        "round_s": list(np.diff([w0] + window.ends)),
        "deleted": [r.removed for r in window.rounds],
        "remaining": last.remaining, "strip_bytes": window.bytes,
        "counters": {k: v - window.warm.counters.get(k, 0)
                     for k, v in last.counters.items()}}
    out.attempted = sum(len(r.candidates) for r in window.rounds)
    out.metrics = {"setup_s": w0 - t_start,
                   "tokenize_MBps": window.bytes / (w1 - w0) / 1e6}
    out.ctx = {"window_ns": (window.t0_ns, window.t1_ns),
               "spans": spans, "units": out.attempted,
               "dispatches": work, "tables": tables[0] if tables else None,
               "counters": (window.warm.counters, last.counters)}
    if traced:
        out.ctx["ops"] = trace.ops(window.t0_ns, window.t1_ns)
        # the program's spans, by name, name the card's idle gaps
        for s in tracing.records(window.t0_ns, window.t1_ns):
            spans.by_name.setdefault(s.name, []).append(
                (s.start, s.end, s.thread))
    out.window = window
    out.config, out.traffic = cfg, mix
    out.corpus = corpus
    out.pool_path = pool_path
    return out


STAND_INS = ("greedy", "altered", "dropped")


def _votes(r, c, scores) -> set:
    """The deletion votes of candidate ``c`` of round ``r`` by the frozen
    rule, from ``scores``."""
    from ..reference.trainer import _select_deletions
    return set(_select_deletions(c.vocab, scores, r.vocab_size,
                                 c.remaining_plus, r.midway_target, r.fast,
                                 r.specials, c.work_type))


def _reference_scores(out: Run, picked: list, reference,
                      greedy: bool) -> dict:
    """{(round, candidate): (scores, tokens in text, missing)} of the
    picked rounds' candidates by the reference's loop (``greedy``: the
    control's)."""
    from ..reference import candidates as rc
    got = {}
    with tempfile.TemporaryDirectory(prefix="tmbench_cand_") as d:
        for k in picked:
            for j, c in enumerate(out.window.rounds[k].candidates):
                path = os.path.join(d, f"{k}_{j}.vocab")
                c.vocab.save(path)
                got[k, j] = rc.score(reference, path, c.datasets, greedy)
    return got


def _vocab_off(out: Run, picked: list, header: dict) -> int:
    """``vocab_faults`` summed over the picked rounds' candidates: each
    candidate's vocabulary, as the program built and saved it, against
    the one its token list makes."""
    from ..reference import candidates as rc
    off = 0
    with tempfile.TemporaryDirectory(prefix="tmbench_vocab_") as d:
        for k in picked:
            r = out.window.rounds[k]
            for j, c in enumerate(r.candidates):
                path = os.path.join(d, f"{k}_{j}.vocab")
                c.vocab.save(path)
                off += rc.vocab_faults(path, c.tokens, r.specials, header)
    return off


def check(out: Run, seed: int, count: int, reference,
          stand_in: str | None = None) -> dict:
    """The numbers compared, each exact: ``deletions_off``, the tokens the
    window's rounds voted out and took out (and the count the pool lost)
    against those the frozen rule draws from the program's scores (before
    midway every vote of a deletion candidate is a deletion);
    ``scores_off``, ``tokens_off`` and ``missing_off``, the scores by id,
    the tokens in text and the missing byte values of every candidate of
    the window's first and last rounds (``count`` 1: the first alone)
    against the reference's loop over the same strips; ``strips_off``,
    those strips not found in the reference's normalization of the
    corpus; ``pool_off``, pool entries that break ``pool_check``'s rule.
    ``stand_in`` reads what stands in the program's place instead: the
    control ("greedy", the greedy loop's scores) or the program's own
    results with a fault planted ("altered": one score; "dropped": one
    deletion).  ``vocab_off``: the picked candidates' vocabularies against
    the ones their token lists make (``candidates.vocab_faults``)."""
    from ..reference.core.vocab import Vocab
    from ..reference.pool_check import pool_faults

    cfg, rounds = out.config, out.window.rounds
    picked = sorted({0, len(rounds) - 1} if count > 1 else {0})
    if getattr(out, "reference", None) is None:        # once a run
        norm = normalized(cfg, out.corpus, reference)
        v = Vocab.load(inputs.vocab_file(cfg))
        want = {"using_capcode": v.using_capcode, "charset": v.charset,
                "norm_flag": v.normalizer.flag, "level": v.level}
        pool = pool_faults(out.pool_path, norm, want,
                           cfg["pool"]["min_occur"],
                           out.traffic["pool_sample"], seed)
        strips = sum(1 for k in picked for c in rounds[k].candidates
                     for d in c.datasets if norm.find(d) < 0)
        out.reference = (_reference_scores(out, picked, reference, False),
                         pool, strips, _vocab_off(out, picked, want))
    want, (pool_off, pool_n), strips_off, vocab_off = out.reference
    if stand_in == "greedy" and getattr(out, "greedy", None) is None:
        out.greedy = _reference_scores(out, picked, reference, True)

    def program(k, j):
        """The results of candidate j of window round k that stand in
        the program's place."""
        if stand_in == "greedy" and (k, j) in out.greedy:
            return out.greedy[k, j]
        c = rounds[k].candidates[j]
        scores = np.asarray(c.scores, np.int64)
        if stand_in == "altered" and (k, j) == (0, 0):
            scores = scores.copy()
            scores[len(scores) // 2] += 1
        return scores, c.tokens_in_text, set(c.missing)

    deletions_off = 0
    for k, r in enumerate(rounds):
        drawn = set()
        for j, c in enumerate(r.candidates):
            if c.work_type == 0:
                drawn |= _votes(r, c, program(k, j)[0])
        deleted = set(r.deleted)
        if stand_in == "dropped" and k == 0 and deleted:
            deleted.discard(min(deleted))
        deletions_off += len(drawn ^ deleted) + abs(r.removed - len(drawn))
    scores_off = tokens_off = missing_off = 0
    for (k, j), (s, t, m) in sorted(want.items()):
        ps, pt, pm = program(k, j)
        n = min(len(ps), len(s))
        scores_off += int((ps[:n] != s[:n]).sum()) + abs(len(ps) - len(s))
        tokens_off += abs(pt - t)
        missing_off += len(pm ^ m)
    out.info["checked"] = {"rounds": [rounds[k].number for k in picked],
                           "candidates": len(want), "pool_entries": pool_n}
    return {"deletions_off": (deletions_off, 0),
            "scores_off": (scores_off, 0), "tokens_off": (tokens_off, 0),
            "missing_off": (missing_off, 0),
            "strips_off": (0 if stand_in else strips_off, 0),
            "pool_off": (0 if stand_in else pool_off, 0),
            "vocab_off": (0 if stand_in else vocab_off, 0)}
