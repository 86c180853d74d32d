#!/usr/bin/env python3
"""Time each kernel against its previous design.

    python3 tools/measure/previous_kernels.py extract
    python3 tools/measure/previous_kernels.py time [KERNEL ...]
    python3 tools/measure/previous_kernels.py paths

``extract``, in a git checkout, writes the kernel sources of
``tokenmonster_tpu_torch/csrc/`` at the commits of ``PREVIOUS`` to
``build/previous_kernels/<commit>/``, which git ignores: a previous design
is read from history, not kept in the tree.  For match and follow that is
8033868, the last commit with the one-thread-per-position match kernel and
the one-thread-per-lane follow kernel; for decide and compact f9d4c8f, the
last with the one-thread-per-(position, row) decide kernel and the
one-block-per-lane compact kernel behind a ``torch.zeros``.  It also unpacks
the port's package at ``PARENT`` to
``build/previous_kernels/<PARENT>/tree/`` for ``paths``.  Run
it before copying the tree to the machine with the card, which has no git
history.

``time``, on a CUDA card with those directories present, builds the
previous designs with nvcc beside the current kernels, holds both against
the plain versions (tolerance 0), and times both on the same inputs in
turns (current, previous, previous, current; each design the mean of its
two medians of CUDA-event runs, ``chip_smoke.cuda_ms``), queued behind a
spin (the card alone) and launched back to back from the host, at two
shapes:

- main: ``chip_smoke.py``'s main-path dispatch, 512 lanes x 2,048 bytes of
  standard-library text under realtext-32000, two fd rows;
- trainer: the same script's trainer pool, its superset masked to the
  first seeded 32,000-id candidate, on the first dispatch of its text
  (compact is not on the trainer's path).

``paths``, on a CUDA card, times what a user calls, this tree against the
``PARENT`` tree, in one process: the parent's package is imported under
another name beside this tree's, and every measurement alternates between
the two (current, parent, parent, current, ...), so a drift of the host's
speed falls on both.  It times the staged device chain and the end-to-end
``load(...).tokenize`` of ``chip_smoke.py``'s 4 MiB (MB/s), the native
tokenizer on the same text as a reading of the host's speed, and on the
smoke's trainer pool the host masking (``candidate_runtime_state``, upload
and table build included) and the device score (``score_strips``) of
``CANDIDATES`` seeded 32,000-id candidates, wall milliseconds ending in a
synchronise: medians, and the median of the paired differences.  Each
tree also runs ``ROUND_RUNS`` seeded two-round ``train_vocab`` runs on the
smoke's trainer configuration: seconds per round after the arm.

Each prints the card's name and power limit, and as its last line one JSON
object of the times.  The previous designs' argument structs are copied
below as they were at those commits, so the current ones may change freely.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
OUT = os.path.join(ROOT, "build", "previous_kernels")
SOURCES = ("tm_kernels.cu", "tm_kernels.cuh")
PREVIOUS = {"match": "8033868", "decide": "f9d4c8f", "follow": "8033868",
            "compact": "f9d4c8f"}
PARENT = "f35d910"            # the tree ``paths`` compares with
PARENT_FILES = ("tokenmonster_tpu_torch",)
CHAIN_RUNS, E2E_RUNS, CANDIDATES, ROUND_RUNS = 60, 12, 24, 2

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


class MatchArgs(ctypes.Structure):
    """``tmk::MatchArgs`` of the previous design."""
    _fields_ = [("text", _P), ("fields", _P), ("disp", _P), ("single", _P),
                ("space_single", _P), ("scalars", _P), ("desc", _P),
                ("len_cls", _P), ("ovf_keys", _P), ("m", _P), ("mb", _P),
                ("N", _I64), ("n", _I32), ("max_len", _I32),
                ("idx1_bits", _I32), ("has_space", _I32), ("lil_off", _I32),
                ("pad_", _I32)]


class DecideArgs(ctypes.Structure):
    """``tmk::DecideArgs`` of the previous design."""
    _fields_ = [("m", _P), ("mb", _P), ("text", _P), ("meta", _P),
                ("bb", _P), ("ctl", _P), ("tok", _P), ("N", _I64),
                ("meta_stride", _I64), ("n", _I32), ("has_delete", _I32),
                ("has_unk", _I32), ("unk_token", _I32), ("lil_off", _I32),
                ("pad_", _I32)]


class FollowArgs(ctypes.Structure):
    """``tmk::FollowArgs`` of the previous design."""
    _fields_ = [("ctl", _P), ("tok", _P), ("recs", _P), ("toks", _P),
                ("done_all", _P), ("N", _I64), ("rows", _I32), ("n", _I32),
                ("chunk", _I32), ("overlap", _I32), ("W", _I32), ("L", _I32),
                ("t_rec", _I32), ("pad_", _I32)]


class CompactArgs(ctypes.Structure):
    """``tmk::CompactArgs`` of the previous design."""
    _fields_ = [("recs", _P), ("toks", _P), ("s", _P), ("e", _P), ("q", _P),
                ("out", _P), ("out_len", _I64), ("T", _I32), ("L", _I32)]


def extract() -> int:
    for commit in sorted(set(PREVIOUS.values())):
        out = os.path.join(OUT, commit)
        os.makedirs(out, exist_ok=True)
        for name in SOURCES:
            src = subprocess.run(
                ["git", "show",
                 f"{commit}:tokenmonster_tpu_torch/csrc/{name}"],
                cwd=ROOT, capture_output=True, check=True).stdout
            with open(os.path.join(out, name), "wb") as f:
                f.write(src)
        print(f"wrote {', '.join(SOURCES)} of {commit} to {out}")
    tree = os.path.join(OUT, PARENT, "tree")
    shutil.rmtree(tree, ignore_errors=True)
    os.makedirs(tree)
    tar = subprocess.run(["git", "archive", PARENT, *PARENT_FILES], cwd=ROOT,
                         capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", tree], input=tar, check=True)
    print(f"unpacked {', '.join(PARENT_FILES)} of {PARENT} to {tree}")
    return 0


class Previous:
    """The previous designs' kernels, launched on the current tables and
    inputs (the hash placement and every word format are the same in all
    designs).  ``libs``: {commit: path of its built library}."""

    def __init__(self, libs: dict):
        self.fn = {}
        for name, struct in (("match", MatchArgs), ("decide", DecideArgs),
                             ("follow", FollowArgs),
                             ("compact", CompactArgs)):
            fn = getattr(ctypes.CDLL(libs[PREVIOUS[name]]),
                         f"tm_{name}_launch")
            fn.argtypes = ([ctypes.POINTER(struct), ctypes.c_int, _P]
                           if name == "decide"
                           else [ctypes.POINTER(struct), _P])
            fn.restype = ctypes.c_int
            self.fn[name] = fn

    def _launch(self, name: str, args, *extra) -> None:
        import torch
        stream = torch.cuda.current_stream().cuda_stream
        code = self.fn[name](ctypes.byref(args), *extra, stream)
        if code != 0:
            raise RuntimeError(f"previous {name} kernel: launch failed "
                               f"({code})")

    def match(self, buf, n: int, tabs):
        import torch
        m = torch.empty(buf.numel(), dtype=torch.int32, device=buf.device)
        mb = torch.empty_like(m) if tabs.has_space else m
        self._launch("match", MatchArgs(
            text=buf.data_ptr(), fields=tabs.fields.data_ptr(),
            disp=tabs.disp.data_ptr(), single=tabs.single.data_ptr(),
            space_single=tabs.space_single.data_ptr(),
            scalars=tabs.scalars.data_ptr(), desc=tabs.desc.data_ptr(),
            len_cls=tabs.len_cls.data_ptr(),
            ovf_keys=tabs.ovf_keys.data_ptr(), m=m.data_ptr(),
            mb=mb.data_ptr(), N=buf.numel(), n=n, max_len=tabs.max_len,
            idx1_bits=tabs.idx1_bits, has_space=int(tabs.has_space),
            lil_off=tabs.lil_off))
        return (m, mb) if tabs.has_space else m

    def decide(self, m, mb, text, n: int, tabs, meta):
        """``meta``: the metadata planes, planar and contiguous, as this
        design reads them."""
        import torch
        N = m.numel()
        rows = 2 if tabs.has_delete else 1
        ctl = torch.empty((rows, N), dtype=torch.int32, device=m.device)
        tok = torch.empty((rows, N), dtype=torch.int32, device=m.device)
        self._launch("decide", DecideArgs(
            m=m.data_ptr(), mb=(mb if mb is not None else m).data_ptr(),
            text=text.data_ptr(), meta=meta.data_ptr(),
            bb=tabs.bb.data_ptr(), ctl=ctl.data_ptr(), tok=tok.data_ptr(),
            N=N, meta_stride=meta.shape[1], n=n,
            has_delete=int(tabs.has_delete), has_unk=int(tabs.has_unk),
            unk_token=tabs.unk_token, lil_off=tabs.lil_off), rows)
        return (ctl[0], tok[0]) if rows == 1 else (ctl, tok)

    def follow(self, ctl, tok, n, chunk, lanes, overlap, t_rec):
        import torch

        from tokenmonster_tpu_torch.ops.follow import window
        recs = torch.empty((t_rec, lanes), dtype=torch.int32,
                           device=ctl.device)
        toks = torch.empty_like(recs)
        done = torch.ones(1, dtype=torch.int32, device=ctl.device)
        self._launch("follow", FollowArgs(
            ctl=ctl.data_ptr(), tok=tok.data_ptr(), recs=recs.data_ptr(),
            toks=toks.data_ptr(), done_all=done.data_ptr(),
            N=ctl.shape[-1], rows=1 if ctl.dim() == 1 else ctl.shape[0],
            n=n, chunk=chunk, overlap=overlap, W=window(chunk, overlap),
            L=lanes, t_rec=t_rec))
        return recs, toks, done[0]

    def compact(self, recs, toks, s, e, q, out_len: int):
        """The previous wrapper's two launches: a zero-fill, then the
        kernel."""
        import torch
        T, L = recs.shape
        out = torch.zeros(out_len, dtype=torch.int32, device=recs.device)
        self._launch("compact", CompactArgs(
            recs=recs.data_ptr(), toks=toks.data_ptr(), s=s.data_ptr(),
            e=e.data_ptr(), q=q.data_ptr(), out=out.data_ptr(),
            out_len=out_len, T=T, L=L))
        return out


def triples(prev: Previous, buf, n: int, tabs, chunk: int, lanes: int,
            t_rec: int, downstream: bool):
    """Per kernel, (current, previous, plain) calls on the same inputs;
    ``downstream`` adds compact, which needs the dispatch to sync."""
    from tokenmonster_tpu_torch.ops import stitch
    from tokenmonster_tpu_torch.ops.decide import decide, decide_plain
    from tokenmonster_tpu_torch.ops.follow import follow, follow_plain
    from tokenmonster_tpu_torch.ops.match import match, match_plain
    from tokenmonster_tpu_torch.ops.scan import OVERLAP_SCAN, remap_matches
    mm = match(buf, n, tabs)
    m, mb = mm if tabs.has_space else (mm, None)
    if tabs.rank is not None:            # a trainer candidate's (REMAP)
        m = remap_matches(m, tabs.rank)
        mb = None if mb is None else remap_matches(mb, tabs.rank)
    ctl, tok = decide(m, mb, buf, n, tabs)
    meta = tabs.meta.contiguous()
    args = (ctl, tok, n, chunk, lanes, OVERLAP_SCAN, t_rec)
    calls = {
        "match": (lambda: match(buf, n, tabs),
                  lambda: prev.match(buf, n, tabs),
                  lambda: match_plain(buf, n, tabs)),
        "decide": (lambda: decide(m, mb, buf, n, tabs),
                   lambda: prev.decide(m, mb, buf, n, tabs, meta),
                   lambda: decide_plain(m, mb, buf, n, tabs)),
        "follow": (lambda: follow(*args), lambda: prev.follow(*args),
                   lambda: follow_plain(*args)),
    }
    if downstream:
        recs, toks, _done = follow(*args)
        _f, keep, _sn, ok, s, e = stitch.stitched_keep(recs, 0, lanes - 2,
                                                       False)
        if not bool(ok):
            raise RuntimeError("the dispatch did not sync")
        counts = keep.sum(0)
        q = (counts.cumsum(0) - counts - s).int()
        s, e = s.int(), e.clamp(max=t_rec - 1).int()
        cargs = (recs, toks, s, e, q, t_rec * lanes)
        calls["compact"] = (lambda: stitch.compact(*cargs),
                            lambda: prev.compact(*cargs),
                            lambda: stitch.compact_plain(*cargs))
    return calls


def measure(smoke, calls: dict, shape: str, card: str) -> dict:
    import torch
    out = {}
    for name, (cur, prev, plain) in calls.items():
        want = plain()
        err = max(smoke.max_abs_err(cur(), want),
                  smoke.max_abs_err(prev(), want))
        torch.cuda.synchronize()
        smoke.require(err == 0, f"{name} ({shape}): max_abs_err {err}")
        out[name] = {"max_abs_err": err}
        for key, queued in (("ms", False), ("device_ms", True)):
            runs = [smoke.cuda_ms(fn, queued=queued)
                    for fn in (cur, prev, prev, cur)]
            a, b, c, d = runs
            out[name][key] = (a + d) / 2
            out[name][f"previous_{key}"] = (b + c) / 2
            out[name][f"{key}_runs"] = runs
            how = ("the card alone" if queued
                   else "back to back from the host")
            print(f"{name} ({shape}, {how}): current {(a + d) / 2:.4f} ms, "
                  f"previous {(b + c) / 2:.4f} ms (in turns: {a:.4f}, "
                  f"{b:.4f}, {c:.4f}, {d:.4f}), max_abs_err 0 [{card}]",
                  flush=True)
    return out


def _build_previous(build) -> dict:
    """{commit: library}: every previous design built with nvcc, all at
    once, beside the current kernels."""
    procs = {}
    for commit in sorted(set(PREVIOUS.values())):
        src = os.path.join(OUT, commit, "tm_kernels.cu")
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"no sources in {os.path.dirname(src)}; run 'extract' in a "
                "git checkout first")
        so = os.path.join(OUT, commit, f"lib_{os.getpid()}.so")
        procs[commit] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        build.load_library()
        for commit, (so, proc) in procs.items():
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"design {commit}: nvcc failed:\n{log}")
    finally:
        for _so, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {commit: so for commit, (so, _proc) in procs.items()}


def time_designs(names: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("previous_kernels: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from tokenmonster_tpu_torch.core.vocab import Vocab
    from tokenmonster_tpu_torch.corpus import main_dispatch, stdlib_text
    from tokenmonster_tpu_torch.ops import _build
    from tokenmonster_tpu_torch.train.score_helpers import \
        candidate_runtime_state

    card = _card()
    print(card)
    libs = _build_previous(_build)
    prev = Previous(libs)
    for so in libs.values():
        os.remove(so)
    dev = torch.device("cuda", 0)

    def chosen(calls: dict) -> dict:
        return {k: v for k, v in calls.items() if k in names}

    core = Vocab.load(os.path.join(ROOT, smoke.VOCAB))
    raw, _dropped = stdlib_text(core, smoke.MAIN_BYTES)
    tk, buf, n = main_dispatch(core, raw, dev, smoke.CHUNK, smoke.LANES)
    result = {"card": card, "previous": PREVIOUS, "shapes": {}}
    result["shapes"]["main"] = measure(smoke, chosen(triples(
        prev, buf, n, tk.tables, smoke.CHUNK, smoke.LANES, tk._t_rec(False),
        True)), "main", card)

    if set(names) - {"compact"}:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        work = tempfile.mkdtemp(prefix="previous_kernels_",
                                dir=os.path.join(ROOT, "build"))
        try:
            t = smoke.trainer_inputs(dev, card, work)
            tabs = candidate_runtime_state(t.sc._sup, t.candidate())
            result["shapes"]["trainer"] = measure(smoke, chosen(triples(
                prev, t.buf, t.n, tabs, t.tk.chunk, smoke.LANES, t.t_rec,
                False)), "trainer", card)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result))
    return 0


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _import_tree(alias: str, root: str):
    """The port's package of the tree at ``root``, imported as ``alias``
    (its modules import each other relatively, so two trees' packages live
    side by side in one process, each with its own kernel and native
    libraries under its own ``build/``)."""
    import importlib.util
    pkg = os.path.join(root, "tokenmonster_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


class _Tree:
    """One tree's side of ``paths``: its tokenizer with ``chip_smoke.py``'s
    4 MiB staged, and its trainer scorer armed on the shared pool."""

    def __init__(self, alias: str, smoke, raw: bytes, tok_path: str,
                 train_raw: bytes, dev):
        import importlib

        def sub(name):
            return importlib.import_module(f"{alias}.{name}")
        self.smoke, self.dev = smoke, dev
        self.train_raw, self.tok_path = train_raw, tok_path
        pkg = sys.modules[alias]
        core = sub("core.vocab").Vocab.load(os.path.join(ROOT, smoke.VOCAB))
        self.raw = raw
        self.vocab = pkg.load(os.path.join(ROOT, smoke.VOCAB), device=dev)
        self.vocab.route = "device"
        self.vocab.tokenize(raw)
        self.tk = self.vocab._tpu
        self.norm = core.normalize(raw)
        self.native = sub("native").NativeVocab(core)
        self.staged = self.tk.stage(self.norm)
        self.tk.tokenize_staged(self.staged)

        self.port = port = sub("train.trainvocab")
        dic = sub("train.getalltokens").load_tokens_file(tok_path)
        capcode, norm_flag = dic["using_capcode"], dic["norm_flag"]
        self.text = sub("core.vocab").normalize_and_capcode(
            train_raw, capcode, sub("core.normalize").Normalizer(norm_flag))
        self.pool = port.superset_pool(tok_path)
        self.sc = port.GpuCandidateScorer(dic["charset"], capcode, norm_flag,
                                          device=dev)
        self.sc.set_specials([])
        self.sc.prepare(self.pool)
        cc = sub("core.capcode")
        self.singles = sorted({t for t in dic["tokens"] if len(t) == 1}
                              | {bytes([b]) for b in (cc.DELETE_TOKEN,
                                                      cc.CHARACTER_TOKEN,
                                                      cc.WORD_TOKEN)})
        self._mask = sub("train.score_helpers").candidate_runtime_state
        self._score = sub("parallel.score").score_strips

    def round_s(self, work: str) -> float:
        """Seconds per round of a seeded two-round ``train_vocab`` on the
        smoke's trainer configuration, the superset's arm left out."""
        import time
        from unittest import mock

        import torch
        port = self.port
        arm = []

        class Timed(port.GpuCandidateScorer):
            def prepare(self, *args, **kw):
                t0 = time.perf_counter()
                super().prepare(*args, **kw)
                torch.cuda.synchronize()
                arm.append(time.perf_counter() - t0)

        smoke, rounds = self.smoke, 2
        cfg = port.TrainConfig(vocab_size=smoke.TRAIN_VOCAB, workers=2,
                               fast=True, seed=smoke.TRAIN_SEED,
                               max_rounds=rounds, backend="cuda")
        out = tempfile.mkdtemp(dir=work)
        t0 = time.perf_counter()
        with mock.patch.object(port, "GpuCandidateScorer", Timed):
            port.train_vocab(self.train_raw, self.tok_path, out, cfg,
                             device=self.dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shutil.rmtree(out, ignore_errors=True)
        return (wall - sum(arm)) / rounds

    def chain(self):
        tk = self.tk
        tk._run_staged(self.staged, False, tk.tables, tk._compact, {})

    def e2e(self):
        self.vocab.tokenize(self.raw)

    def host(self):
        self.native.tokenize(self.norm)

    def candidate(self, tokens: list, wall_ms) -> tuple:
        """(masking ms, score ms) of the candidate of ``tokens``."""
        cand = self.sc.build(tokens)
        tabs = []
        mask = wall_ms(lambda: tabs.append(self._mask(self.sc._sup, cand)))
        score = wall_ms(lambda: self._score(
            self.sc._sup.tokenizer, tabs[0], [self.text], len(cand.reverse)))
        return mask, score


def time_paths() -> int:
    import random
    import statistics
    import time

    import torch
    if not torch.cuda.is_available():
        print("previous_kernels: torch sees no CUDA card", file=sys.stderr)
        return 1
    parent = os.path.join(OUT, PARENT, "tree")
    if not os.path.exists(os.path.join(parent, "tokenmonster_tpu_torch")):
        raise FileNotFoundError(f"no tree in {parent}; run 'extract' in a "
                                "git checkout first")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import tokenmonster_tpu_torch  # noqa: F401  (the current tree's)
    from tokenmonster_tpu_torch.core.vocab import Vocab
    from tokenmonster_tpu_torch.corpus import stdlib_text
    from tokenmonster_tpu_torch.train.getalltokens import (get_all_tokens,
                                                           save_tokens_file)
    _import_tree("tm_parent", parent)

    def wall_ms(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    card = _card()
    print(card)
    dev = torch.device("cuda", 0)
    raw, _dropped = stdlib_text(Vocab.load(os.path.join(ROOT, smoke.VOCAB)),
                                smoke.MAIN_BYTES)
    train_raw, _dropped = stdlib_text(None, smoke.TRAIN_BYTES)
    work = tempfile.mkdtemp(prefix="paths_", dir=OUT)
    try:
        tok_path = os.path.join(work, "pool.tok")
        save_tokens_file(tok_path, *get_all_tokens(
            train_raw, "balanced", charset=1, normalization="nfd",
            using_capcode=2, min_occur_total=smoke.TRAIN_MIN_OCCUR))
        trees = {"current": _Tree("tokenmonster_tpu_torch", smoke, raw,
                                  tok_path, train_raw, dev),
                 "parent": _Tree("tm_parent", smoke, raw, tok_path,
                                 train_raw, dev)}
        print(f"the trees armed: {len(trees['current'].norm)} normalized "
              f"bytes staged, a superset of "
              f"{len(trees['current'].sc._sup.vocab.tokens)} entries",
              flush=True)

        runs = {k: {"current": [], "parent": []}
                for k in ("chain_ms", "e2e_ms", "native_ms", "mask_ms",
                          "score_ms", "round_s")}

        def turns(i: int) -> list:
            order = ["current", "parent"]
            return order if i % 2 == 0 else order[::-1]

        for key, fn, count in (("chain_ms", "chain", CHAIN_RUNS),
                               ("e2e_ms", "e2e", E2E_RUNS),
                               ("native_ms", "host", E2E_RUNS)):
            for i in range(count):
                for which in turns(i):
                    runs[key][which].append(
                        wall_ms(getattr(trees[which], fn)))
        cur = trees["current"]
        multi = [t for t in cur.pool if len(t) > 1]
        rng = random.Random(smoke.TRAIN_SEED)
        for i in range(CANDIDATES + 1):           # the first one warms up
            rng.shuffle(multi)
            tokens = cur.singles + multi[:smoke.TRAIN_VOCAB
                                         - len(cur.singles)]
            for which in turns(i):
                mask, score = trees[which].candidate(tokens, wall_ms)
                if i:
                    runs["mask_ms"][which].append(mask)
                    runs["score_ms"][which].append(score)
        for i in range(ROUND_RUNS):
            for which in turns(i):
                runs["round_s"][which].append(trees[which].round_s(work))
        for tree in trees.values():
            smoke.require(tree.tk.host_fallbacks == 0,
                          "a timed call fell back")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    result = {"card": card, "parent": PARENT, "runs": runs}
    sizes = {"chain_ms": len(cur.norm), "e2e_ms": len(raw),
             "native_ms": len(cur.norm)}
    for key, r in runs.items():
        c, p = (statistics.median(r[w]) for w in ("current", "parent"))
        diff = statistics.median(a - b for a, b in zip(r["current"],
                                                       r["parent"]))
        result[key] = {"current": c, "parent": p, "paired_difference": diff}
        line = (f"{key}: current {c:.3f}, parent {p:.3f}, median of the "
                f"{len(r['current'])} paired differences {diff:+.3f} "
                f"(current {min(r['current']):.3f}-{max(r['current']):.3f}, "
                f"parent {min(r['parent']):.3f}-{max(r['parent']):.3f})")
        if key in sizes:
            n = sizes[key]
            line += (f"; {n / c / 1e3:.1f} against {n / p / 1e3:.1f} MB/s "
                     f"over {n} bytes")
        print(f"{line} [{card}]", flush=True)
    print(json.dumps(result))
    return 0


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[1] == "extract":
        return extract()
    if len(argv) == 2 and argv[1] == "paths":
        return time_paths()
    if len(argv) >= 2 and argv[1] == "time" and set(argv[2:]) <= set(PREVIOUS):
        return time_designs(argv[2:] or list(PREVIOUS))
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv))
