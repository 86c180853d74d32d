"""REMAP mode of the trainer's scorer on the port, tolerance 0 (every
output is an integer): the superset keeps its match tables only, and each
candidate is decided, followed and resolved on tables of its own size,
its match words mapped to candidate indices
(``ops/scan.py::remap_matches``), so supersets of 2^20 entries or more
score too.  The port has this one mode; the JAX package arms it with
``TM_TRAINER_META_CAP_MB=0`` on small pools.

- ``candidate_runtime_state`` against the JAX helper's REMAP state: rank,
  the live prefix of the planes and ids3, the masked match tables;
- ``GpuCandidateScorer(device="cpu").score`` against the JAX Pallas
  scorer in REMAP mode (interpret mode) and the native scorer, on the
  pool and strips of ``tests/test_pallas_scorer.py``, on
  ``torch_cases.zero_step_vocab`` and through a forced junction repair;
- a seeded ``train_vocab(backend="cuda", device="cpu")`` against the JAX
  loop's ``backend="native"``;
- the mode's refusals: a candidate's tables of the wrong shape, a
  placement whose index fields cannot hold the superset.
"""

import logging
import os

import numpy as np
import pytest
import torch

from tokenmonster_tpu.core.vocab import Vocab
from tokenmonster_tpu.train import score_helpers as jhelpers
from tokenmonster_tpu.train import trainvocab as ref
from tokenmonster_tpu.train.getalltokens import (get_all_tokens,
                                                 load_tokens_file,
                                                 save_tokens_file)
from tokenmonster_tpu_torch.ops import tables
from tokenmonster_tpu_torch.ops.scan import remap_matches
from tokenmonster_tpu_torch.train import score_helpers
from tokenmonster_tpu_torch.train import trainvocab as port
from tokenmonster_tpu_torch.train.trainvocab import GpuCandidateScorer

from test_torch_score import POOL, SINGLES, _pool_strips
from torch_cases import (VOCABS, ZERO_STEP_TEXT, ZERO_STEP_TOKENS, candidate,
                         drop_sets, native_score, text_for, with_unk,
                         zero_step_vocab)
from torch_cases import jax_native  # noqa: F401 (autouse fixture)


def _scorer(v, cls=GpuCandidateScorer, **kw):
    sc = cls(v.charset, v.using_capcode, v.normalizer.flag, **kw)
    sc.set_specials([])
    return sc


def _jax_remap_scorer(monkeypatch, v, tokens, cls=ref.CandidateScorer):
    """The JAX package's Pallas scorer armed in REMAP mode on ``tokens``."""
    monkeypatch.setenv("TM_TRAINER_META_CAP_MB", "0")
    jsc = _scorer(v, cls, backend="tpu")
    assert jsc.prepare_pallas(tokens)
    assert jsc._pal["remap"] is True
    return jsc


def test_remap_matches_equals_the_jax_formula():
    """``idx = m >> 6; m' = rank[idx] << 6 | m & 63``, 0 staying 0, as
    ``tokenmonster_tpu/parallel/score.py`` remaps before decide; indices
    up to the placement's 21 bits."""
    rng = np.random.default_rng(0)
    n_sup = (1 << 21) - 2
    rank = rng.integers(0, 1 << 20, n_sup).astype(np.int32)
    idx = rng.integers(0, n_sup, 5000)
    m = (idx << 6 | rng.integers(1, 64, idx.size)).astype(np.int64)
    m[::7] = 0
    m = m.astype(np.uint32)
    want = np.where(m == 0, m, (rank[m >> 6].astype(np.uint32) << 6)
                    | (m & 63))
    got = remap_matches(torch.from_numpy(m.view(np.int32)),
                        torch.from_numpy(rank))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("name", ["capcode", "plain", "unk", "utf16"])
def test_candidate_state_equals_jax_remap(name, monkeypatch):
    """The REMAP candidate's tables are the JAX helper's arrays: its rank,
    the live prefix of its planes and ids3 (the JAX package pads their
    rows to a power of two, zeros past the prefix), the masked match
    tables and its delete id."""
    unk = name == "unk"
    v = VOCABS[name]()
    tokens = list(v.tokens)
    sc = _scorer(v, with_unk(GpuCandidateScorer) if unk
                 else GpuCandidateScorer, device="cpu")
    sc.prepare(tokens)
    sup = sc._sup
    assert sup.tokenizer.tables.match_only
    monkeypatch.setenv("TM_TRAINER_META_CAP_MB", "0")
    pal = {"v_sup": sup.vocab, "tabs": sup.hashmatch, "remap": True,
           "has_delete": sup.vocab.delete_token != 0xFFFFFF,
           "sup_index": sup.index}
    for drops in drop_sets(v, 5):
        cand = candidate(sc, tokens, drops, unk)
        ct = score_helpers.candidate_runtime_state(sup, cand)
        tabs_args, se, planes, bb, ids3f, del_tok, rank = \
            jhelpers.candidate_runtime_state(pal, cand)
        n_c, n_cls = len(cand.tokens), len(sup.hashmatch.classes)
        np.testing.assert_array_equal(ct.rank.numpy(), np.asarray(rank))
        assert ct.rank.shape == (len(sup.vocab.tokens),)
        planes = np.asarray(planes).reshape(2, -1)
        w = ct.meta.shape[1]
        assert w == tables.meta_width(n_c) and w >= n_c
        np.testing.assert_array_equal(ct.meta.numpy(), planes[:, :w])
        assert not planes[:, w:].any()
        ids3f = np.asarray(ids3f).reshape(-1, 3)
        np.testing.assert_array_equal(ct.ids3.numpy().view(np.uint32),
                                      ids3f[:n_c])
        assert not ids3f[n_c:].any()
        np.testing.assert_array_equal(ct.bb.numpy(),
                                      np.asarray(bb).reshape(-1))
        fields = np.concatenate([np.asarray(a).reshape(-1)
                                 for a in tabs_args[:n_cls]])
        np.testing.assert_array_equal(ct.fields.numpy(), fields)
        np.testing.assert_array_equal(
            ct.single.numpy(), np.asarray(tabs_args[2 * n_cls]).ravel())
        if ct.has_space:
            np.testing.assert_array_equal(
                ct.space_single.numpy(),
                np.asarray(tabs_args[2 * n_cls + 1]).ravel())
        np.testing.assert_array_equal(ct.scalars.numpy(), se)
        assert ct.delete_token == del_tok
        assert ct.entries.shape[1] == w


def test_remap_scorer_equals_jax_remap_and_native(monkeypatch):
    """The pool and strips of ``tests/test_pallas_scorer.py``: REMAP mode
    on the port, the JAX Pallas scorer in REMAP mode and native agree."""
    v, strips = _pool_strips()
    jsc = _jax_remap_scorer(monkeypatch, v, POOL + SINGLES)
    sc = _scorer(v, device="cpu")
    sc.prepare(POOL + SINGLES, hashmatch_tables=jsc._pal["tabs"])
    assert sc._sup.tokenizer.tables.match_only
    for drops in ([], [b" quick", b"the", b" hello"],
                  [b" the", b"ing", b"er", b" of", b" to", b"  "]):
        cand = sc.build([t for t in POOL if t not in drops] + SINGLES)
        s, n_tok, miss = sc.score(cand, strips)
        js, jt, jm = jsc.score(cand, strips)
        ns, nt, nm = native_score(cand, strips)
        assert s.dtype == np.int64 and s.shape == (len(cand.reverse),)
        np.testing.assert_array_equal(s, np.asarray(js))
        np.testing.assert_array_equal(s, ns)
        assert n_tok == jt == nt, drops
        assert miss == jm == nm == {0xF7, 0xFE}, drops
    assert jsc.tpu_compiles == 1       # every JAX score took the fast path
    assert sc.repairs == 0


@pytest.mark.parametrize("name", ["capcode", "unk", "utf16"])
def test_remap_scorer_on_torch_cases_equals_native(name):
    """Drop sets of the other vocabularies (both fd rows, an unk id,
    UTF-16) over strips with bytes the candidates lack."""
    unk = name == "unk"
    v = VOCABS[name]()
    tokens = list(v.tokens)
    sc = _scorer(v, with_unk(GpuCandidateScorer) if unk
                 else GpuCandidateScorer, device="cpu")
    sc.prepare(tokens)
    strips = [text_for(name, v, size, seed=size) for size in (1500, 3001)]
    for drops in drop_sets(v, 11):
        cand = candidate(sc, tokens, drops, unk)
        got, want = sc.score(cand, strips), native_score(cand, strips)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:], len(drops)


def test_remap_zero_advance_step_scored_exactly():
    """The zero-advance step of ``torch_cases.zero_step_vocab`` (the
    alternative " " at fd 1) through candidate-sized tables."""
    sc = _scorer(zero_step_vocab(), device="cpu")
    sc.prepare(ZERO_STEP_TOKENS)
    for toks in (ZERO_STEP_TOKENS, [t for t in ZERO_STEP_TOKENS
                                    if t != b"tim"]):
        cand = sc.build(toks)
        strips = [ZERO_STEP_TEXT, b"out\xc2"]
        got, want = sc.score(cand, strips), native_score(cand, strips)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] and got[2] == {0xC2}
        assert got[0][cand.reverse.index(b"u")] == 31


@pytest.mark.parametrize("capcode", [0, 2])
def test_remap_junction_repair_equals_native(capcode):
    """A junction whose lanes share no state (after an "x", a run of "a"
    with tokens "aa", "a", "x") is repaired on the device in REMAP mode
    too: the repair lane's chain goes through the rank gather, and the
    scores equal native's.  The superset holds a token the candidate
    lacks, so ranks differ from superset indices."""
    toks = [b"aa", b"a", b"x", b"xa"]
    v = Vocab()
    v._generate(tokens=toks, charset=1, normalize_string="none",
                using_capcode=capcode, level=5, reset_token_ids=True)
    strips = [b"x" + b"a" * 3000, b"xaaxa" * 50]
    sc = _scorer(v, device="cpu")
    sc.prepare(toks)
    cand = sc.build([b"aa", b"a", b"x"])
    assert len(cand.tokens) < len(sc._sup.vocab.tokens)
    s, n_tok, miss = sc.score(cand, strips)
    want = native_score(cand, strips)
    assert sc.repairs == 1
    np.testing.assert_array_equal(s, want[0])
    assert (n_tok, miss) == want[1:]


SEED_TEXT = (b"The quick brown fox jumps over the lazy dog. The dog sleeps "
             b"while the fox runs through the forest; every morning the sun "
             b"rises over the mountains and the birds sing their songs. ")
LOGGERS = ("tokenmonster_tpu.trainvocab", "tokenmonster_tpu_torch.trainvocab")


def test_train_vocab_in_remap_mode_equals_native(tmp_path, caplog,
                                                 monkeypatch):
    """A seeded run to its end with the scorer in REMAP mode: every round's
    deletions, every file and the best vocabulary equal the JAX loop's with
    ``backend="native"``."""
    corpus = SEED_TEXT * 40
    counter, char_table, header = get_all_tokens(
        corpus, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=10, min_occur_singles=1, chunk_size=1 << 20,
        micro_chunks=1, add_extra_tokens=False)
    tok = str(tmp_path / "all.tok")
    save_tokens_file(tok, counter, char_table, header)
    armed = []

    class Remap(GpuCandidateScorer):
        def prepare(self, superset_tokens, hashmatch_tables=None):
            super().prepare(superset_tokens, hashmatch_tables)
            armed.append(self._sup.tokenizer.tables.match_only)

    monkeypatch.setattr(port, "GpuCandidateScorer", Remap)
    kw = dict(vocab_size=120, workers=2, fast=True, seed=7, keep_trying=5)
    rounds = {}
    for backend in ("native", "cuda"):
        caplog.clear()
        out = str(tmp_path / backend)
        with caplog.at_level(logging.INFO, logger=LOGGERS[0]), \
                caplog.at_level(logging.INFO, logger=LOGGERS[1]):
            if backend == "native":
                best = ref.train_vocab(corpus, tok, out, ref.TrainConfig(
                    backend="native", **kw))
            else:
                best = port.train_vocab(corpus, tok, out, port.TrainConfig(
                    backend="cuda", **kw), device="cpu")
        rounds[backend] = ([r.getMessage() for r in caplog.records
                            if r.getMessage().startswith("round ")], best)
    assert armed == [True]
    (rn, best_n), (rc, best_c) = rounds["native"], rounds["cuda"]
    assert rc == rn and len(rn) > 5 and "deleted 0;" not in rn[0]
    names = sorted(os.listdir(tmp_path / "native"))
    assert names == sorted(os.listdir(tmp_path / "cuda"))
    for n in names:
        assert ((tmp_path / "native" / n).read_bytes()
                == (tmp_path / "cuda" / n).read_bytes()), n
    assert os.path.basename(best_c) == os.path.basename(best_n)
    assert (sorted(load_tokens_file(best_c)["tokens"])
            == sorted(load_tokens_file(best_n)["tokens"]))


def test_remap_refusals(monkeypatch):
    """A REMAP candidate's tables must have its mode's shapes (superset
    positions' planes and ids raise too); a superset at the entry limit
    arms; a placement whose index fields cannot hold idx+1 of every entry
    raises."""
    v = VOCABS["capcode"]()
    tokens = list(v.tokens)
    sc = _scorer(v, device="cpu")
    sc.prepare(tokens)
    sup = sc._sup
    cand = candidate(sc, tokens, drop_sets(v, 5)[1], False)
    good = score_helpers.candidate_runtime_state(sup, cand)
    base = sup.tokenizer.tables
    assert base.match_only and base.meta is None and base.ids3 is None
    flat = tables.flat_tables(sup.hashmatch)
    scalars = tables.smem_scalars(sup.hashmatch)
    planes, bb = tables.build_meta_planes(cand)
    ids = tables.ids3(cand)
    rank = good.rank.numpy()
    n_sup = len(sup.vocab.tokens)
    at_sup = np.zeros((n_sup, 3), np.uint32)
    for bad, what in (((planes.reshape(2, -1), bb, ids, rank[:-1]), "rank"),
                      ((planes.reshape(2, -1), bb, ids[:-1], rank), "ids3"),
                      ((planes.reshape(2, -1), bb, at_sup, rank), "ids3"),
                      ((np.zeros((2, tables.meta_width(n_sup) + 1024),
                                 np.int32), bb, ids, rank), "meta"),
                      ((planes.reshape(2, -1), bb, ids,
                        rank.astype(np.int64)), "rank")):
        with pytest.raises(ValueError, match=what):
            tables.CandidateTables(base, cand, flat, scalars, *bad)

    monkeypatch.setattr(tables, "MAX_ENTRIES", len(tokens))
    sc = _scorer(v, device="cpu")
    sc.prepare(tokens)
    assert sc._sup.tokenizer.tables.match_only
    got = sc.score(cand, [b"the quick brown fox"])
    want = native_score(cand, [b"the quick brown fox"])
    np.testing.assert_array_equal(got[0], want[0])
    monkeypatch.setattr(tables, "IDX_BITS", 5)
    with pytest.raises(NotImplementedError, match="index fields"):
        sc.prepare(tokens)
