"""Vocabulary distillation with candidates scored on the device.

Port of the JAX trainer's fast path (``tokenmonster_tpu/train/
trainvocab.py``: ``CandidateScorer.prepare_pallas``/``_score_tpu_pallas``
and the master loop's arming of it) for one CUDA card.  The master loop is
the reference's ``train_vocab``, run unchanged; only its scorer differs:

    from tokenmonster_tpu.train.trainvocab import TrainConfig
    from tokenmonster_tpu_torch.train.trainvocab import train_vocab
    best = train_vocab(data, "pool.tok", "results/",
                       TrainConfig(vocab_size=32000, fast=True,
                                   backend="cuda"), device="cuda")

``GpuCandidateScorer`` places the hash tables of a superset of every token
the run can use once (``prepare``) and scores each candidate vocabulary by
masking that placement to it (``train/score_helpers.py``) and running the
kernels over the strips (``parallel/score.py``).  Scores, token counts and
missing-byte sets equal the native scorer's exactly, so a seeded run makes
the native backend's deletions.
"""

from __future__ import annotations

import os
import threading

import numpy as np

import tokenmonster_tpu.train.trainvocab as _ref
from tokenmonster_tpu.core import capcode as cc
from tokenmonster_tpu.core.tokenmeta import is_alphanum_tm
from tokenmonster_tpu.ops.hashmatch import build_hashmatch
from tokenmonster_tpu.train.getalltokens import load_tokens_file
from tokenmonster_tpu.train.trainvocab import CandidateScorer
from tokenmonster_tpu.utils.runes import decode_utf8

from ..ops import tables
from ..ops.scan import GpuTokenizer, check_device
from ..parallel.score import score_strips
from .score_helpers import Superset, candidate_runtime_state

CHUNK = 2048      # bytes per lane, as the JAX trainer scores
CHECKPOINTS = ("interval_", "finalrun_", "doublevocab_")


class GpuCandidateScorer(CandidateScorer):
    """``CandidateScorer`` with ``backend="cuda"``: the CUDA kernels on a
    CUDA ``device``, their plain PyTorch versions on ``"cpu"``.

    ``prepare(superset_tokens)`` builds the superset vocabulary and its
    hash placement once; ``score(cand, datasets)`` then scores any
    candidate built from a subset of it, with ``CandidateScorer.score``'s
    contract.  A candidate that does not fit the superset raises.  Every
    byte is scored on the device: a junction whose lanes share no state is
    repaired there (``parallel/score.py``), counted in ``repairs``.
    With ``pool`` (as ``train_vocab`` builds it), ``set_specials`` also
    prepares ``pool`` plus the specials.  ``score`` may run from several
    threads: each call builds its own candidate tables."""

    def __init__(self, charset, using_capcode, norm_flag, backend="cuda",
                 device="cuda", pool=None):
        if backend != "cuda":
            raise ValueError(f"GpuCandidateScorer scores with backend "
                             f"'cuda', not {backend!r}")
        super().__init__(charset, using_capcode, norm_flag, backend)
        self.device = check_device(device)
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
        device.  ``hashmatch_tables``: the JAX package's numpy placement of
        that vocabulary, to share one build; None builds it here."""
        v_sup = self.build(list(superset_tokens))
        if len(v_sup.tokens) >= tables.MAX_ENTRIES:
            raise NotImplementedError(
                f"superset of {len(v_sup.tokens)} entries: token words pack "
                "20-bit dictionary indices, so supersets of 2^20 entries or "
                "more are not supported yet")
        if hashmatch_tables is None:
            hashmatch_tables = build_hashmatch(
                v_sup.tokens, space_prefix=tables.space_prefix(v_sup))
        tk = GpuTokenizer(v_sup, chunk=CHUNK, device=self.device,
                          hashmatch_tables=hashmatch_tables)
        self._sup = Superset(
            vocab=v_sup,
            index={bytes(t): i for i, t in enumerate(v_sup.tokens)},
            hashmatch=hashmatch_tables, tokenizer=tk)

    def score(self, cand, datasets: list[bytes]):
        """(scores int64 [n_ids], tokens in text, set of missing byte
        values) of ``cand`` over ``datasets``."""
        if self._sup is None:
            raise RuntimeError("GpuCandidateScorer.prepare was not called")
        n_ids = len(cand.reverse)
        tabs = candidate_runtime_state(self._sup, cand)
        scores, n_tokens, miss_mask, repairs = score_strips(
            self._sup.tokenizer, tabs, datasets, n_ids)
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


_seam = threading.Lock()


def train_vocab(dataset: bytes, dictionary_path, results_dir,
                config: _ref.TrainConfig, device="cuda"):
    """``tokenmonster_tpu.train.trainvocab.train_vocab`` with every
    candidate scored by a ``GpuCandidateScorer`` on ``device``
    (``config.backend`` must be "cuda").  Returns the best .tok path.

    The reference loop builds its scorer through its module's name
    ``CandidateScorer``; that name is the one seam, bound to this port's
    scorer for the duration of the call (under a lock, so concurrent
    calls serialize) and restored afterwards.  The scorer is armed on
    ``superset_pool(dictionary_path)`` plus the loop's specials."""
    if config.backend != "cuda":
        raise ValueError(f"backend {config.backend!r}: this train_vocab "
                         "scores on the device (backend 'cuda'); the native "
                         "backend is tokenmonster_tpu.train.trainvocab's")
    device = check_device(device)
    pool = superset_pool(dictionary_path)

    def make_scorer(charset, using_capcode, norm_flag, backend):
        return GpuCandidateScorer(charset, using_capcode, norm_flag, backend,
                                  device=device, pool=pool)

    with _seam:
        _ref.CandidateScorer = make_scorer
        try:
            return _ref.train_vocab(dataset, dictionary_path, results_dir,
                                    config)
        finally:
            _ref.CandidateScorer = CandidateScorer
