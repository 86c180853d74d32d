"""Vocabulary distillation trainer: the trainvocab pipeline.

Copy of ``tokenmonster_tpu/train/trainvocab.py`` (the reference master loop,
training/trainvocab.go :1831-2293, worker :505-1345) with this package's
scorers:
  - "native": the C++ host tokenizer's scoring pass (tm_tokenize_score),
    threads; ``CandidateScorer``.
  - "cuda":   candidates scored on the device by ``GpuCandidateScorer``
    (a subclass of ``CandidateScorer``), armed once on a superset of every
    token the run can use.
The JAX package's "tpu" backend (its mesh-sharded Pallas fast path over
every local device) is the "cuda" backend here: asking for "tpu" raises
and says so.  "cuda" scores on every visible card unless ``device`` names
one ("cuda:k") or a list of scoring slots (``["cuda:0", "cuda:1"]``,
``["cpu", "cpu"]``); in a run of several processes joined by
``parallel/multihost.py::init_distributed`` each rank scores its share on
its own card and the sums are all-reduced: every rank makes the same
deletions from the same seed (rank 0's, where the config has none), and
only rank 0 writes files.  Its VMEM arming is not copied.  Its REMAP
mode is copied as the one mode of every superset (the JAX
package arms it only for supersets whose planes its kernels cannot
hold): each candidate is matched on the superset's masked match tables
and decided, followed and resolved on tables of its own size, so
supersets of 2^20 entries or more (the reference configuration's pool of
about 800,000 candidates expands to about 1.2 M) score as any other.

    from tokenmonster_tpu_torch.train.trainvocab import TrainConfig, train_vocab
    best = train_vocab(data, "pool.tok", "results/",
                       TrainConfig(vocab_size=32000, fast=True),
                       device="cuda")

``TrainConfig.backend`` is "cuda" unless the caller asks for "native".

``GpuCandidateScorer`` places the hash tables of the superset once
(``prepare``) and scores each candidate vocabulary by masking that
placement to it (``train/score_helpers.py``) and running the kernels over
the strips (``parallel/score.py``).  Scores, token counts and missing-byte
sets equal the native scorer's exactly, so a seeded run makes the native
backend's deletions and writes the same files.

The asynchronous Go worker pool is realised as streamed rounds over a
ThreadPoolExecutor: worker threads keep scoring later candidates while the
master consumes earlier results in submission order, so pruning overlaps
candidate scoring; the algorithm's decisions are sequenced identically to
the reference's select loop.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import tempfile
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import capcode as cc
from ..core.normalize import Normalizer
from ..core.vocab import Vocab, normalize_and_capcode
from ..utils.runes import decode_utf8
from ..core.tokenmeta import DOES_NOT_EXIST, is_alphanum_tm
from ..ops import tables
from ..ops.hashmatch import build_hashmatch
from ..ops.scan import GpuTokenizer
from ..parallel import multihost
from ..parallel.score import Slot, score_slots, score_strips
from .getalltokens import load_tokens_file, save_tokens_with_scores
from .score_helpers import (Superset, candidate_host_state,
                            candidate_runtime_state)

log = logging.getLogger("tokenmonster_tpu_torch.trainvocab")

MAXINT = 1 << 62


@dataclass
class TrainConfig:
    vocab_size: int = 0
    workers: int = 2
    percentage: int = 15
    midway_target: int = 0
    keep_trying: int = 1000
    strips: int = 100
    fast: bool = False
    include_256_bytes: bool = False
    include_128_bytes: bool = False
    include_utf8_bytes: bool = False
    include_ascii_bytes: bool = False
    include_extended_bytes: bool = False
    include_missing_bytes: bool = False
    exclude_other_bytes: bool = False
    special_tokens: list = field(default_factory=list)
    backend: str = "cuda"           # the device; "native" scores on the host
    seed: int | None = None
    max_rounds: int | None = None   # extension: bound total rounds (tests)


class CandidateScorer:
    """Builds a per-candidate index and scores the corpus with it."""

    def __init__(self, charset, using_capcode, norm_flag, backend="native"):
        self.charset = charset
        self.using_capcode = using_capcode
        self.norm_flag = norm_flag
        self.backend = backend

    def build(self, token_list):
        """token_list: singles + tokens + specials (pre-encoded bytes)."""
        v = Vocab()
        specials = [t for t in token_list if t in self._special_set]
        regular = [t for t in token_list if t not in self._special_set]
        v._generate(tokens=regular,
                    special_tokens_encoded=specials,
                    charset=self.charset, normalize_string="",
                    using_capcode=self.using_capcode, level=5, reserve=0,
                    reset_token_ids=True)
        v.normalizer = Normalizer(self.norm_flag)
        return v

    _special_set: set = frozenset()

    def set_specials(self, specials):
        self._special_set = frozenset(specials)

    def score(self, cand: Vocab, datasets: list[bytes]):
        """Returns (scores int64[max_id], tokens_in_text, missing_list)."""
        n_ids = len(cand.reverse)
        scores = np.zeros(n_ids + 1, np.int64)
        tokens_in_text = 0
        missing_bytes = set()
        if self.backend == "native":
            from .. import native
            nv = native.NativeVocab(cand)
            mask = np.zeros(256, np.uint8)
            for data in datasets:
                nt, _miss = nv.tokenize_score(data, scores, mask)
                tokens_in_text += nt
            missing_bytes |= {int(b) for b in np.nonzero(mask)[0]}
        else:
            raise ValueError(f"unknown backend {self.backend}")
        return scores[:n_ids], tokens_in_text, missing_bytes

    def _find_missing(self, cand, data):
        missing = set()
        for b in set(data):
            if bytes([b]) not in cand.dictionary.index:
                missing.add(b)
        return missing


BACKENDS = ("native", "cuda")
CHUNK = 2048      # bytes per lane, as the JAX trainer scores
CHECKPOINTS = ("interval_", "finalrun_", "doublevocab_")


class GpuCandidateScorer(CandidateScorer):
    """``CandidateScorer`` with ``backend="cuda"``: the CUDA kernels on a
    CUDA ``device``, their plain PyTorch versions on ``"cpu"``.

    ``prepare(superset_tokens)`` builds the superset vocabulary and its
    hash placement once, in REMAP mode; ``score(cand, datasets)`` then
    scores any
    candidate built from a subset of it, with ``CandidateScorer.score``'s
    contract.  A candidate that does not fit the superset raises.  Every
    byte is scored on the device: a junction whose lanes share no state is
    repaired there (``parallel/score.py``), counted in ``repairs``.
    With ``pool`` (as ``train_vocab`` builds it), ``set_specials`` also
    prepares ``pool`` plus the specials.  ``score`` may run from several
    threads: each call builds its own candidate tables.

    ``device``: the scoring slots (``multihost.local_devices``): "cuda" is
    every visible card, "cuda:k" one, a list one slot per entry.  With
    several slots, or in a process group of several ranks (``world``),
    each slot arms its own copy of the superset's tables from the one
    placement and every candidate is split over the slots of every rank
    (``parallel/score.py::score_slots``); the scores equal one device's."""

    def __init__(self, charset, using_capcode, norm_flag, backend="cuda",
                 device="cuda", pool=None):
        if backend != "cuda":
            raise ValueError(f"GpuCandidateScorer scores with backend "
                             f"'cuda', not {backend!r}")
        super().__init__(charset, using_capcode, norm_flag, backend)
        self.devices = multihost.local_devices(device)
        self.device = self.devices[0]
        self.rank, self.world = multihost.process_info()
        self._slots = None
        self.repairs = 0
        self._pool = pool
        self._sup = None
        self._count_lock = threading.Lock()

    def set_specials(self, specials):
        specials = frozenset(specials)
        if self._sup is not None and specials != self._special_set:
            raise ValueError("specials differ from those the prepared "
                             "superset was built with")
        super().set_specials(specials)
        if self._pool is not None:
            self.prepare(list(self._pool) + sorted(specials))
            self._pool = None

    def prepare(self, superset_tokens, hashmatch_tables=None):
        """Build the superset vocabulary from ``superset_tokens`` (singles,
        tokens and specials, encoded) and carry its kernel tables to the
        device.  ``hashmatch_tables``: a placement of that vocabulary to
        share one build (this package's ``HashMatchTables`` or the JAX
        package's, converted by ``tables.from_reference_tables``); None
        builds it here.  The superset is armed in REMAP mode: its match
        tables only, masked per candidate, each match word mapped to the
        candidate's index, and decide, follow and ids on candidate-sized
        tables, so token words' 20-bit indices hold supersets of 2^20
        entries or more too."""
        v_sup = self.build(list(superset_tokens))
        if hashmatch_tables is None:
            hashmatch_tables = build_hashmatch(
                v_sup.tokens, space_prefix=tables.space_prefix(v_sup))
        hashmatch_tables = tables.from_reference_tables(hashmatch_tables)
        tks = [GpuTokenizer(v_sup, chunk=CHUNK, device=d,
                            hashmatch_tables=hashmatch_tables,
                            match_only=True) for d in self.devices]
        self._sup = Superset(
            vocab=v_sup,
            index={bytes(t): i for i, t in enumerate(v_sup.tokens)},
            hashmatch=hashmatch_tables, tokenizer=tks[0])
        if len(tks) > 1 or self.world > 1:
            for d in self.devices:     # the slots' streams see the tables
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            self._slots = [Slot(tk) for tk in tks]
        log.info("cuda trainer armed on %s (rank %d of %d): superset %d "
                 "tokens, delete=%s, remap=True",
                 ", ".join(map(str, self.devices)), self.rank, self.world,
                 len(v_sup.tokens), v_sup.delete_token != DOES_NOT_EXIST)

    def score(self, cand, datasets: list[bytes]):
        """(scores int64 [n_ids], tokens in text, set of missing byte
        values) of ``cand`` over ``datasets``."""
        if self._sup is None:
            raise RuntimeError("GpuCandidateScorer.prepare was not called")
        n_ids = len(cand.reverse)
        if self._slots is None:
            tabs = candidate_runtime_state(self._sup, cand)
            scores, n_tokens, miss_mask, repairs = score_strips(
                self._sup.tokenizer, tabs, datasets, n_ids)
        else:
            scores, n_tokens, miss_mask, repairs = score_slots(
                self._slots, candidate_host_state(self._sup, cand),
                datasets, n_ids, self.rank, self.world)
        with self._count_lock:
            self.repairs += repairs
        return scores, n_tokens, {int(b) for b in np.nonzero(miss_mask)[0]}


def _checkpoint_paths(dictionary_path) -> list:
    """The .tok files ``train_vocab`` may read its pool from: the file
    itself, or every checkpoint of a directory it resumes from."""
    if not os.path.isdir(dictionary_path):
        return [dictionary_path]
    return sorted(os.path.join(dictionary_path, n)
                  for n in os.listdir(dictionary_path)
                  if n.startswith(CHECKPOINTS) and n.endswith(".tok"))


def superset_pool(dictionary_path) -> list[bytes]:
    """Every token but the specials that ``train_vocab`` can put in a
    candidate when it trains from ``dictionary_path``: the tokens of the
    .tok file (of every checkpoint, for a directory), each one's form with
    the "D " delete prefix stripped where the master loop strips it, and
    all 256 single bytes."""
    pool = {bytes([b]) for b in range(256)}
    for path in _checkpoint_paths(dictionary_path):
        dic = load_tokens_file(path)
        capcode = dic["using_capcode"]
        delete = {2: cc.DELETE_TOKEN, 1: cc.NO_CAPCODE_DELETE_TOKEN}.get(
            capcode)
        for tok in dic["tokens"]:
            tok = bytes(tok)
            pool.add(tok)
            if len(tok) > 2 and tok[1] == 0x20 and tok[0] == delete:
                r, _n = decode_utf8(tok, 2)
                if is_alphanum_tm(r, capcode):
                    pool.add(tok[2:])
    return sorted(pool, key=lambda t: (len(t), t))


def _worker_divider(remaining, vocab_size, midway_target, fast):
    """trainvocab.go:1192-1249."""
    if fast:
        table = [(vocab_size + vocab_size // 4, 200),
                 (vocab_size + vocab_size // 2, 150),
                 (vocab_size * 2, 100),
                 (midway_target // 6, 100), (midway_target // 4, 100),
                 (midway_target // 2, 100), (midway_target, 50),
                 (midway_target * 3 // 2, 40), (midway_target * 2, 30),
                 (midway_target * 4, 20), (midway_target * 10, 10)]
        default = 10
    else:
        table = [(vocab_size + vocab_size // 4, 2000),
                 (vocab_size + vocab_size // 2, 1500),
                 (vocab_size * 2, 1000),
                 (midway_target // 6, 400), (midway_target // 4, 300),
                 (midway_target // 2, 200), (midway_target, 150),
                 (midway_target * 3 // 2, 100), (midway_target * 2, 80),
                 (midway_target * 4, 40), (midway_target * 10, 20)]
        default = 10
    if remaining == 0:
        return 10
    for bound, div in table:
        if remaining < bound:
            return div
    return default


def _final_phase_cap(temp, in_top_percent, fast, zero_removed):
    """trainvocab.go:1908-1947."""
    for bound, v in ((25, 2), (50, 3), (100, 4), (200, 5), (300, 6),
                     (400, 8), (500, 10), (750, 15), (1000, 20), (2000, 30),
                     (2500, 40), (3000, 50)):
        if temp < bound:
            cap = v
            break
    else:
        cap = 100
    if in_top_percent:
        cap += 4
    if fast:
        cap *= 2
    return cap + zero_removed


def _fnv_vocab_hash(sorted_tokens):
    """trainvocab.go:2265-2279 (modified FNV-1a over the sorted vocab)."""
    h = 14695981039346656037
    mask = (1 << 64) - 1
    for key in sorted_tokens:
        for c in key:
            h = ((h ^ (c + 11)) * 1099511628211) & mask
        h = ((h ^ 11400714819323198485) * 1099511628211) & mask
    return h


def _select_deletions(cand: Vocab, scores, vocab_size, remaining_plus,
                      midway_target, fast, special_set, work_type):
    """Worker deletion-vote selection (trainvocab.go:1180-1320).

    scores: int64[max_id]; returns list of token bytes (worst first), or for
    work_type 1 the best tokens (best first)."""
    id_to_token = cand.reverse
    ids = [i for i, t in enumerate(id_to_token) if t is not None]
    order = sorted(ids, key=lambda i: (scores[i], i))
    if work_type == 1:
        result = []
        for i in reversed(order):
            t = id_to_token[i]
            if len(t) <= 1 or t in special_set:
                continue
            result.append(t)
        return result

    divider = _worker_divider(remaining_plus, vocab_size, midway_target, fast)
    length = max(2, min(vocab_size // divider, vocab_size - 1))
    result = []
    k = 0
    for i in order:
        if len(result) >= length:
            break
        k += 1
        t = id_to_token[i]
        if len(t) == 1 or t in special_set:
            continue
        result.append(t)
    # append all remaining zero-score tokens (trainvocab.go:1277-1295)
    for i in order[k:]:
        if scores[i] > 0:
            break
        t = id_to_token[i]
        if len(t) == 1 or t in special_set:
            continue
        result.append(t)
    return result


def train_vocab(dataset: bytes, dictionary_path, results_dir,
                config: TrainConfig, device="cuda"):
    """Run the distillation training loop.  Returns the best .tok path.
    With ``config.backend == "cuda"`` every candidate is scored by a
    ``GpuCandidateScorer`` on ``device`` ("cuda": the kernels on every
    visible card; "cuda:k" one card; "cpu": their plain PyTorch versions;
    a list: one scoring slot each), armed on ``superset_pool`` of the
    pool plus the loop's specials.

    In a process group of several ranks (``parallel/multihost.py``) every
    rank calls it with the same arguments: the scorer splits each
    candidate over the ranks and all-reduces its sums, so every rank makes
    the same deletions, from rank 0's seed where ``config`` has none.  Only
    rank 0 writes to ``results_dir``; the others keep the files the loop
    reads back in a temporary directory, and return rank 0's path."""
    cfg = config
    if cfg.backend not in BACKENDS:
        raise ValueError(f"backend {cfg.backend!r} is not one of {BACKENDS}; "
                         "the JAX package's mesh-sharded 'tpu' backend is "
                         "the 'cuda' backend here, which scores on every "
                         "visible card (or the devices given)")
    rank, world = multihost.process_info()
    if world > 1 and cfg.seed is None:
        seed = random.SystemRandom().randrange(1 << 62) if rank == 0 else 0
        cfg = dataclasses.replace(
            cfg, seed=int(multihost.all_reduce_sum(np.array([seed]))[0]))
    if rank == 0:
        return _train_vocab(dataset, dictionary_path, results_dir, cfg,
                            device)
    with tempfile.TemporaryDirectory(prefix=f"tm_rank{rank}_") as scratch:
        best = _train_vocab(dataset, dictionary_path, scratch, cfg, device)
    return best and os.path.join(results_dir, os.path.basename(best))


def _train_vocab(dataset: bytes, dictionary_path, results_dir,
                 cfg: TrainConfig, device):
    """``train_vocab``'s loop, writing to ``results_dir``."""
    if cfg.backend == "cuda":
        multihost.local_devices(device)    # raises before any work
        pool = superset_pool(dictionary_path)
    rng = random.Random(cfg.seed)
    os.makedirs(results_dir, exist_ok=True)

    # Resume support (trainvocab.go:1395-1411, 1609-1642): a directory input
    # resumes from its latest checkpoint.  Token counts shrink monotonically
    # during pruning, so "latest" = the file with the *smallest* numeric
    # suffix (lexicographic order is wrong: interval_995 sorts after
    # interval_1002).  The token list is loaded from that checkpoint, while
    # doublevocab_*/finalrun_* — like the reference — additionally restore
    # the 2x-vocab resurrection snapshot and the final-run filename rather
    # than replacing newer interval_ progress.
    resume_double_path = None
    resume_finalrun_path = None
    if os.path.isdir(dictionary_path):
        def _suffix(name, prefix):
            try:
                return int(name[len(prefix):-len(".tok")])
            except ValueError:
                return None

        def _best(prefix):
            hits = []
            for n in os.listdir(dictionary_path):
                if n.startswith(prefix) and n.endswith(".tok"):
                    s = _suffix(n, prefix)
                    if s is not None:
                        hits.append((s, n))
            if not hits:
                return None
            return os.path.join(dictionary_path, min(hits)[1])

        resume_double_path = _best("doublevocab_")
        resume_finalrun_path = _best("finalrun_")
        best_ckpt = (_best("interval_") or resume_finalrun_path
                     or resume_double_path)
        if best_ckpt is None:
            raise FileNotFoundError(
                f"no interval_/finalrun_/doublevocab_ .tok in "
                f"{dictionary_path}")
        dictionary_path = best_ckpt
        log.info("resuming from checkpoint %s", dictionary_path)

    dic = load_tokens_file(dictionary_path)
    using_capcode = dic["using_capcode"]
    charset = dic["charset"]
    norm_flag = dic["norm_flag"]
    level = dic["level"]
    tokens = list(dic["tokens"])
    if dic.get("specials"):
        cfg.special_tokens = list(cfg.special_tokens) + list(dic["specials"])

    vocab_size = cfg.vocab_size
    if vocab_size <= 0:
        raise ValueError("vocab_size required")
    midway_target = cfg.midway_target
    keep_trying = cfg.keep_trying
    if cfg.fast:
        midway_target = midway_target or (vocab_size * 2 + vocab_size // 4)
        keep_trying = 275 if keep_trying == 1000 else keep_trying
    midway_target = midway_target or vocab_size * 6

    # normalize corpus once (trainvocab.go:1657-1665)
    normalizer = Normalizer(norm_flag)
    filedata = normalize_and_capcode(bytes(dataset), using_capcode, normalizer)
    data_len = len(filedata)

    # strips (trainvocab.go:1668-1695)
    strips = 20 if data_len < 10 * 1024 * 1024 else cfg.strips
    bytes_per_worker = data_len * cfg.percentage // 100
    bytes_per_strip = bytes_per_worker // max(1, strips)
    bytes_per_strip += 4 - (bytes_per_strip % 4)
    offset = data_len // max(1, strips)
    worker_strips = []
    if offset + bytes_per_strip > data_len or cfg.percentage >= 100 or data_len < 24000:
        worker_strips = [[filedata] for _ in range(cfg.workers)]
    else:
        for _w in range(cfg.workers):
            frm = rng.randrange(max(1, offset))
            ws = []
            for _s in range(strips):
                if frm + bytes_per_strip > data_len:
                    frm = (frm + bytes_per_strip) - data_len
                ws.append(filedata[frm:frm + bytes_per_strip])
                frm += offset
            worker_strips.append(ws)

    # specials handling (trainvocab.go:1737-1749)
    special_tokens = []
    for sp in cfg.special_tokens:
        sp = bytes(sp)
        spn = normalize_and_capcode(sp, using_capcode, normalizer)
        special_tokens.append(spn)
    special_set = set(special_tokens)
    tokens = [t for t in tokens
              if not any(sp in t for sp in special_tokens)]

    # separate singles; strip "D " prefixes (trainvocab.go:1751-1790)
    include_bytes = [False] * 256
    from ..core.vocab import (_gen_128, _gen_256, _gen_ascii, _gen_extended,
                              _gen_utf8)
    if cfg.include_256_bytes:
        _gen_256(include_bytes, using_capcode)
    if cfg.include_128_bytes:
        _gen_128(include_bytes, using_capcode)
    if cfg.include_utf8_bytes:
        _gen_utf8(include_bytes, using_capcode)
    if cfg.include_ascii_bytes:
        _gen_ascii(include_bytes, using_capcode)
    if cfg.include_extended_bytes:
        _gen_extended(include_bytes, using_capcode, normalizer)
    unique = set()
    for tok in tokens:
        if len(tok) == 0:
            continue
        if len(tok) == 1:
            if not cfg.exclude_other_bytes:
                include_bytes[tok[0]] = True
            continue
        if len(tok) >= 2 and tok[1] == 0x20:
            if ((tok[0] == cc.DELETE_TOKEN and using_capcode == 2)
                    or (using_capcode == 1
                        and tok[0] == cc.NO_CAPCODE_DELETE_TOKEN)):
                if len(tok) > 2:
                    r, _n = decode_utf8(tok, 2)
                    if is_alphanum_tm(r, using_capcode):
                        tok = tok[2:]
        if len(tok) > 1:
            unique.add(tok)
    tokens = sorted(unique, key=lambda t: (len(t), t))
    if using_capcode == 2:
        for b in (cc.DELETE_TOKEN, cc.CHARACTER_TOKEN, cc.WORD_TOKEN):
            include_bytes[b] = True
    elif using_capcode == 1:
        include_bytes[cc.NO_CAPCODE_DELETE_TOKEN] = True
    single_chars = [bytes([i]) for i in range(256) if include_bytes[i]]

    vocab_diff = len(single_chars) + len(special_tokens)
    vocab_size_effective = vocab_size - vocab_diff
    if vocab_size_effective <= 0:
        raise ValueError("vocab size too small for singles + specials")

    if cfg.backend == "cuda":
        scorer = GpuCandidateScorer(charset, using_capcode, norm_flag,
                                    cfg.backend, device=device, pool=pool)
    else:
        scorer = CandidateScorer(charset, using_capcode, norm_flag,
                                 cfg.backend)
    scorer.set_specials(special_set)

    header = {"using_capcode": using_capcode, "charset": charset,
              "norm_flag": norm_flag, "level": level}

    # ---- master state ----
    remaining = len(tokens)
    reached_midway = remaining <= midway_target
    within_vocab_x2 = remaining <= vocab_size * 2
    reached_vocab = False
    best = MAXINT
    best1percent = MAXINT
    no_new_best = 0
    zero_removed = 0
    dicts_within_1pct: list[tuple[int, str]] = []
    unique_file_number = 0
    vocabs_tried = set()
    double_tokens: list[bytes] = []
    double1: list[bytes] = []
    double2: list[bytes] = []
    counter_multi_deletes: dict[bytes, int] = {}
    final_run_filename = None
    # restore checkpoint side-state (reference trainvocab.go:1617-1637:
    # doublevocab_ refills doubletokens, finalrun_ restores the final-run
    # filename — without replacing the interval_ dictionary loaded above)
    if resume_double_path is not None:
        double_tokens = [t for t in load_tokens_file(
            resume_double_path)["tokens"] if len(t) > 1]
        within_vocab_x2 = True
    if resume_finalrun_path is not None:
        final_run_filename = resume_finalrun_path
        reached_vocab = True
    interval10 = 0
    last_interval = None
    justreset = False
    add_tokens_flag = False
    round_no = 0
    worker_cycle = 0

    def save_checkpoint(name, toks, scores=None):
        """Write a resumable checkpoint.  The reference saves the master
        token list together with specials and single-byte tokens
        (trainvocab.go:2173, 2005, 2082) so that resuming from the file
        reconstructs the full candidate state — the loader folds dictionary
        singles back into include_bytes."""
        path = os.path.join(results_dir, name)
        full = (list(toks) if scores is not None
                else list(toks) + list(special_tokens) + single_chars)
        save_tokens_with_scores(path, header, full, scores,
                                special_tokens if scores is not None else None)
        return path

    log.info("training: %d candidate tokens -> vocab %d (effective %d)",
             remaining, vocab_size, vocab_size_effective)

    while True:
        round_no += 1
        if cfg.max_rounds is not None and round_no > cfg.max_rounds:
            log.info("max_rounds reached")
            break

        # --- build candidate vocabularies (master :2217-2290) ---
        jobs = []
        shuffles = 0
        no_more_vocabs = False
        while not jobs:
            if shuffles == 5000 or (shuffles > 0
                                    and remaining <= vocab_size_effective):
                if justreset:
                    log.info("all near vocabularies have been tested")
                    no_more_vocabs = None  # terminal
                    break
                no_more_vocabs = True
                break
            rng.shuffle(tokens)
            shuffles += 1
            i = 0
            for _ in range(10):
                to = i + vocab_size_effective
                if to > len(tokens):
                    break
                cand_tokens = (single_chars + tokens[i:to] + special_tokens)
                i = to
                key = sorted(cand_tokens, key=lambda t: (len(t), t))
                h = _fnv_vocab_hash(key) if within_vocab_x2 else None
                if h is not None and h in vocabs_tried:
                    continue
                if h is not None:
                    vocabs_tried.add(h)
                jobs.append((cand_tokens, 0))
                if len(jobs) >= cfg.workers:
                    break
        if no_more_vocabs is None:
            break

        # workType 1 jobs (master :2183-2215)
        if add_tokens_flag:
            add_tokens_flag = False
            if len(double_tokens) >= vocab_size_effective:
                rng.shuffle(double_tokens)
                half1 = double_tokens[:vocab_size_effective]
                to2 = vocab_size_effective * 2
                half2 = double_tokens[vocab_size_effective:to2]
                if len(double_tokens) < to2:
                    half2 = half2 + double_tokens[:to2 - len(double_tokens)]
                jobs.append((single_chars + half1 + special_tokens, 1))
                jobs.append((single_chars + half2 + special_tokens, 1))

        # --- score the candidates (the worker pool) ---
        # Candidates are evaluated thread-parallel (the C++ scorer releases
        # the GIL), results processed in submission order so every master
        # decision is deterministic.
        tokens_to_remove: dict[bytes, int] = {}
        has_tokens_to_remove = False

        def _evaluate(job):
            cand_tokens, work_type = job[0], job[1]
            widx = job[2]
            cand = scorer.build(cand_tokens)
            # the full dataset is used after midway for normal scoring jobs
            # (trainvocab.go:916-922; workType-1 jobs always use strips)
            use_full = (reached_midway and work_type == 0)
            datasets = [filedata] if use_full else worker_strips[widx]
            return cand, use_full, scorer.score(cand, datasets)

        jobs_w = []
        for cand_tokens, work_type in jobs:
            jobs_w.append((cand_tokens, work_type,
                           worker_cycle % max(1, len(worker_strips))))
            worker_cycle += 1
        # Asynchronous rounds (VERDICT r3 #4, trainvocab.go:1831-2293):
        # worker threads keep scoring later candidates WHILE the master
        # consumes earlier results (the streamed map below yields in
        # submission order, so master decisions stay deterministic).  For
        # the cuda backend two threads pipeline candidate build + table
        # masking (host numpy) against device scoring.
        from concurrent.futures import ThreadPoolExecutor
        _pool = None
        # ranks of a process group score each candidate together, so they
        # score candidates one at a time, in the same order
        if len(jobs_w) > 1 and multihost.process_info()[1] == 1:
            workers_n = (min(4, len(jobs_w)) if cfg.backend == "native"
                         else 2)
            _pool = ThreadPoolExecutor(max_workers=workers_n)
            evaluated = _pool.map(_evaluate, jobs_w)
        else:
            evaluated = (_evaluate(j) for j in jobs_w)

        for (cand_tokens, work_type, _w), (cand, use_full, score_result) \
                in zip(jobs_w, evaluated):
            scores, tokens_in_text, missing = score_result
            remaining_plus = 0 if reached_vocab else remaining + vocab_diff
            votes = _select_deletions(
                cand, scores, vocab_size, remaining_plus, midway_target,
                cfg.fast, special_set, work_type)

            if work_type == 1:
                if not double1:
                    double1 = votes
                else:
                    double2 = votes
                continue

            if cfg.include_missing_bytes and missing:
                for b in missing:
                    if bytes([b]) not in single_chars:
                        single_chars.append(bytes([b]))
                single_chars.sort()
                vocab_diff = len(single_chars) + len(special_tokens)
                vocab_size_effective = vocab_size - vocab_diff

            # best tracking (master :1859-1886)
            if within_vocab_x2 and use_full:
                if tokens_in_text < best:
                    best = tokens_in_text
                    best1percent = best + best // 100
                    no_new_best = 0
                    log.info("new best score %d", best)
                    dicts_within_1pct = [
                        (t, f) for (t, f) in dicts_within_1pct
                        if t <= best1percent or not _try_remove(f)]
                else:
                    no_new_best += 1
                if tokens_in_text < best1percent:
                    fname = os.path.join(
                        results_dir,
                        f"{tokens_in_text}_{unique_file_number}.tok")
                    unique_file_number += 1
                    # tokens the candidate build dropped (e.g. beyond the
                    # 40-byte key cap) have no dictionary entry: score 0
                    saved_tokens = sorted(set(cand_tokens),
                                          key=lambda t: (len(t), t))
                    didx = cand.dictionary.index
                    score_arr = [
                        (float(scores[cand.id[didx[t]]]) / max(1, data_len))
                        if t in didx else 0.0
                        for t in saved_tokens]
                    save_tokens_with_scores(
                        fname, header, saved_tokens, score_arr,
                        special_tokens)
                    dicts_within_1pct.append((tokens_in_text, fname))

            if reached_vocab:
                if no_new_best >= keep_trying:
                    log.info("finished: no new best in %d runs", no_new_best)
                    if _pool is not None:
                        # stop remaining queued candidates before the final
                        # scoring pass (they'd contend for the device and
                        # keep the process alive after the decision to stop)
                        _pool.shutdown(wait=False, cancel_futures=True)
                    return _finish(dicts_within_1pct, best, best1percent,
                                   data_len)
                if best != tokens_in_text and votes:
                    temp = remaining - vocab_size_effective
                    cap = _final_phase_cap(temp, tokens_in_text > best1percent,
                                           cfg.fast, zero_removed)
                    cap = min(cap, len(votes))
                    for t in votes[:cap]:
                        tokens_to_remove[t] = tokens_to_remove.get(t, 0) + 1
                        counter_multi_deletes[t] = (
                            counter_multi_deletes.get(t, 0)
                            + (remaining - vocab_size_effective))
                    has_tokens_to_remove = True
            else:
                if best != tokens_in_text:
                    for t in votes:
                        tokens_to_remove[t] = tokens_to_remove.get(t, 0) + 1
                    has_tokens_to_remove = True

        if _pool is not None:
            _pool.shutdown()

        # --- prune (master default branch :1962-2177) ---
        if has_tokens_to_remove or remaining < vocab_size_effective or no_more_vocabs:
            before = len(tokens)
            tokens = [t for t in tokens if t not in tokens_to_remove]
            removed = before - len(tokens)
            zero_removed = zero_removed + 1 if removed == 0 else 0
            remaining = len(tokens)
            log.info("round %d: deleted %d; remaining %d%s", round_no,
                     removed, remaining + vocab_diff,
                     " [final]" if reached_vocab else
                     (" [x2]" if within_vocab_x2 else
                      (" [midway]" if reached_midway else "")))
            if remaining <= midway_target and not reached_midway:
                save_checkpoint(f"midwaypoint_{remaining + vocab_diff}.tok",
                                tokens)
                reached_midway = True
            if remaining <= vocab_size * 2 and not within_vocab_x2:
                save_checkpoint(f"doublevocab_{remaining + vocab_diff}.tok",
                                tokens)
                double_tokens = list(tokens)
                within_vocab_x2 = True
                add_tokens_flag = True
            justreset = False
            if remaining < vocab_size_effective or no_more_vocabs:
                # final-phase reset (master :2018-2160)
                unique_final: set[bytes] = set()
                if final_run_filename:  # subsequent resets
                    prev = load_tokens_file(final_run_filename)
                    for b in prev["tokens"]:
                        if len(b) > 1 and b not in special_set:
                            if counter_multi_deletes.get(b, 0) < 4000:
                                unique_final.add(b)
                    unique_final.update(tokens)
                else:
                    for t_count, fname in dicts_within_1pct:
                        if t_count < best1percent:
                            d = load_tokens_file(fname)
                            for b in d["tokens"]:
                                if len(b) > 1 and b not in special_set:
                                    unique_final.add(b)
                    no_new_best = 0
                    tokens = sorted(unique_final, key=lambda t: (len(t), t))
                    final_run_filename = save_checkpoint(
                        f"finalrun_{len(tokens) + vocab_diff}.tok", tokens)
                # resurrection from the 2x snapshot (master :2161-2155)
                n_res = max(0, (len(unique_final) - vocab_size_effective) // 3)
                added = 0
                for src_list in (double1, double2):
                    added = 0
                    for b in src_list:
                        if (len(b) > 1 and b not in special_set
                                and b not in unique_final
                                and counter_multi_deletes.get(b, 0) < 1000):
                            unique_final.add(b)
                            added += 1
                            if added >= n_res:
                                break
                double1, double2 = [], []
                add_tokens_flag = True
                tokens = sorted(unique_final, key=lambda t: (len(t), t))
                reached_vocab = True
                justreset = True
                remaining = len(tokens)
                log.info("determining best combination of %d tokens",
                         remaining + vocab_diff)
            if (not reached_vocab
                    and remaining > vocab_size_effective
                    + vocab_size_effective // 50):
                interval10 += 1
                if interval10 == 10:
                    if last_interval:
                        _try_remove(last_interval)
                    last_interval = save_checkpoint(
                        f"interval_{remaining + vocab_diff}.tok", tokens)
                    interval10 = 0

    return _finish(dicts_within_1pct, best, best1percent, data_len)


def _try_remove(path):
    try:
        os.remove(path)
    except OSError:
        pass
    return True


def _finish(dicts_within_1pct, best, best1percent, data_len):
    best_path = None
    for t, f in dicts_within_1pct:
        if t > best1percent:
            _try_remove(f)
        elif t == best:
            best_path = f
    if best != MAXINT and best > 0:
        log.info("best tokenized %d bytes with %d tokens (%.3f chr/tok)",
                 data_len, best, data_len / best)
    return best_path
