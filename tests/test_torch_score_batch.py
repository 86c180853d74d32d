"""The trainer's score chain as the JAX package runs it, on the CPU: a
candidate's strips staged 16 a device call (``GpuTokenizer.stage_batch``),
each batch through ``parallel/score.py::_batch_sums`` on the candidate's
tables at fixed shapes (``CandidateTables`` padded to its row bucket, its
unk and delete ids read from ``literals``), sums over the strips that
held, one read-back a candidate, a strip that did not hold repaired alone
op by op.  Against the JAX package's ``CandidateScorer(backend="tpu")``
after ``prepare_pallas``, whose ``make_pallas_score_step`` scores 16
strips a call here (20 strips outnumber the 8 virtual devices; interpret
mode), and against native ``tm_tokenize_score``.  The captured path
(``_run_captured``: static inputs, the graph's lock, a candidate's tables
copied in) runs on the CPU with a stand-in whose replay runs the captured
body on the inputs as they stand.  Tolerance 0: every score is an
integer.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_score_batch.py -q
"""

import sys
import threading

import numpy as np
import pytest
import torch

from tokenmonster_tpu.core.vocab import Vocab
from tokenmonster_tpu.train import trainvocab as ref
from tokenmonster_tpu_torch.ops import scan, tables
from tokenmonster_tpu_torch.parallel import score
from tokenmonster_tpu_torch.train import trainvocab as port
from tokenmonster_tpu_torch.train.score_helpers import candidate_runtime_state
from tokenmonster_tpu_torch.train.trainvocab import GpuCandidateScorer

from torch_cases import (VOCABS, candidate, drop_sets, native_score,
                         text_for, with_unk)
from torch_cases import jax_native  # noqa: F401 (autouse fixture)

CHUNK, LANES = 32, 32     # a strip of more than 31 * 32 bytes: two dispatches
# 20 strips of unequal length: one empty, one of two dispatches, and a
# last batch of 4 (16 + 4); each at most 2,048 bytes, so the JAX scorer's
# geometry is one dispatch of 2 lanes
SIZES = [700, 0, 1900, *range(180, 1000, 50)][:20]


@pytest.fixture(autouse=True)
def small_geometry(monkeypatch):
    """Lanes of 32 bytes, 32 lanes a dispatch."""
    monkeypatch.setattr(port, "CHUNK", CHUNK)
    monkeypatch.setattr(scan, "MAX_LANES", LANES)


def _scorer(v, cls=GpuCandidateScorer, **kw):
    sc = cls(v.charset, v.using_capcode, v.normalizer.flag, **kw)
    sc.set_specials([])
    return sc


def _strips(name, v, sizes=SIZES):
    return [text_for(name, v, size, seed=i) if size else b""
            for i, size in enumerate(sizes)]


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]


class _ReplayGraph(scan._Graph):
    """A stand-in for a captured graph on the CPU: its replay runs the
    captured body on its static inputs as they stand."""

    def capture(self, body, stream):
        self.body, self.launches = body, {}

    def replay(self):
        return self.body(self.inputs)

    def release(self):
        pass


@pytest.fixture
def captured(monkeypatch):
    """The CPU takes the card's path: every batch a replay of a graph."""
    monkeypatch.setattr(scan, "_Graph", _ReplayGraph)
    monkeypatch.setattr(score, "_run_eager", score._run_captured)


_JAX = {}


def _jax_scorer(v, mode):
    """The JAX trainer's scorer on ``v``, prepared once a module and mode
    ("masked", or "remap": ``TM_TRAINER_META_CAP_MB=0``), each geometry
    compiled once."""
    if mode not in _JAX:
        jsc = _scorer(v, ref.CandidateScorer, backend="tpu")
        with pytest.MonkeyPatch.context() as mp:
            if mode == "remap":
                mp.setenv("TM_TRAINER_META_CAP_MB", "0")
            assert jsc.prepare_pallas(list(v.tokens))
        assert jsc._pal["remap"] == (mode == "remap")
        _JAX[mode] = jsc
    return _JAX[mode]


@pytest.mark.parametrize("mode", ["masked", "remap"])
def test_batches_equal_jax_batch16_and_native(mode):
    """A vocabulary with a delete token: three candidates over the 20
    strips, 16 a device call, equal to the JAX package's batch-16 Pallas
    scorer (on its masked superset planes, or in its REMAP mode) and to
    native; the JAX scorer compiled once and took its fast path."""
    v = VOCABS["capcode"]()
    tokens = list(v.tokens)
    jsc = _jax_scorer(v, mode)
    sc = _scorer(v, device="cpu")
    sc.prepare(tokens, hashmatch_tables=jsc._pal["tabs"])
    strips = _strips("capcode", v)
    tk = sc._sup.tokenizer
    assert [len(tk._plan(len(s))[1]) for s in strips if s].count(2) == 1
    assert score.batch_size(sum(map(bool, strips))) == 16 < len(strips) < 32
    saw_missing = False
    for drops in drop_sets(v, 11):
        cand = candidate(sc, tokens, drops, False)
        got = sc.score(cand, strips)
        _assert_equal(got, jsc.score(cand, strips))
        _assert_equal(got, native_score(cand, strips))
        saw_missing |= bool(got[2])
    assert saw_missing
    assert jsc.tpu_compiles == 1
    assert sc.repairs == 0 and sc.eager_scores == dict.fromkeys(
        score.EAGER_CAUSES, 0)


@pytest.mark.parametrize("name", ["plain", "unk", "utf16", "capcode"])
def test_batches_equal_native_and_op_by_op(name):
    """Each vocabulary (without a delete token, with an unk token kept at
    the superset's id while the candidates' indices move, charset 2):
    the batched scores equal native's and the strips scored one by one,
    op by op (``score_strips``)."""
    v = VOCABS[name]()
    unk = name == "unk"
    tokens = list(v.tokens)
    sc = _scorer(v, with_unk(GpuCandidateScorer) if unk
                 else GpuCandidateScorer, device="cpu")
    sc.prepare(tokens)
    strips = _strips(name, v)
    for drops in drop_sets(v, 5, k=2):
        cand = candidate(sc, tokens, drops, unk)
        tabs = candidate_runtime_state(sc._sup, cand)
        assert tabs is not None
        assert tabs.has_unk == unk and int(tabs.literals[1]) == unk
        got = sc.score(cand, strips)
        _assert_equal(got, native_score(cand, strips))
        s, nt, mm, _r = score.score_strips(sc._sup.tokenizer, tabs, strips,
                                           len(cand.reverse))
        np.testing.assert_array_equal(got[0], s)
        assert got[1] == nt and got[2] == {int(b) for b in np.nonzero(mm)[0]}


def test_candidate_tables_at_their_bucket():
    """A candidate's planes, ids and decide table are padded to the power
    of two of rows its entries need (at least 8: the JAX package's REMAP
    bucket), zero past them; candidates of realtext-1024 with and without
    drops fall in two buckets, each scored equal to native."""
    v = VOCABS["realtext1024"]()
    tokens = list(v.tokens)
    sc = _scorer(v, device="cpu")
    sc.prepare(tokens)
    strips = _strips("realtext1024", v, [600, 1500, 300])
    multi = [t for t in tokens if len(t) > 1]
    widths = []
    for drops in ([], multi[:400]):
        cand = candidate(sc, tokens, drops, False)
        n = len(cand.tokens)
        tabs = candidate_runtime_state(sc._sup, cand)
        w = tables.bucket_width(n)
        widths.append(w)
        assert w >= n and w // 128 >= 8 and (w // 128) & (w // 128 - 1) == 0
        assert tuple(tabs.meta.shape) == (2, w)
        assert tuple(tabs.ids3.shape) == (w, 3)
        assert tuple(tabs.entries.shape) == (2, w, 4)
        assert not tabs.meta[:, n:].any() and not tabs.ids3[n:].any()
        _assert_equal(sc.score(cand, strips), native_score(cand, strips))
    assert widths == [2048, 1024]


def test_empty_rows_and_dispatches_add_nothing():
    """match, decide, follow and the stitch at n = 0, last lane 0, final 1
    (a strip's dispatches past its own, the rows past the strips): every
    such dispatch holds and adds nothing, so a batch of 3 strips in 16
    rows sums what the strips do one by one."""
    v = VOCABS["capcode"]()
    sc = _scorer(v, device="cpu")
    sc.prepare(list(v.tokens))
    cand = candidate(sc, list(v.tokens), drop_sets(v, 2)[1], False)
    tabs = candidate_runtime_state(sc._sup, cand)
    tk = sc._sup.tokenizer
    strips = _strips("capcode", v, [1900, 400, 90])
    staged = tk.stage_batch(strips, 16)
    assert staged.counts == [2, 1, 1] and staged.text.shape[:2] == (16, 2)
    assert (staged.host_scalars[3:] == (0, 0, 1)).all()
    assert (staged.host_scalars[1:3, 1] == (0, 0, 1)).all()
    cap = score.ids_cap(len(tk.vocab.reverse))
    scores, n_tok, miss, flags, recs, starts = score._batch_sums(
        tk, tabs, staged.text, staged.scalars, staged.lanes, cap)
    assert flags.all() and tuple(flags.shape) == (16, 2, 2)
    assert tuple(recs.shape[:2]) == (16, 2) and not recs[3:].any()
    assert not recs[1:3, 1].any()
    s, nt, mm, _r = score.score_strips(tk, tabs, strips, cap)
    np.testing.assert_array_equal(scores.numpy(), s)
    assert int(n_tok) == nt and np.array_equal(miss.numpy(), mm)


@pytest.mark.parametrize("n,rows", [(1, 1), (2, 2), (3, 4), (9, 16),
                                    (16, 16), (20, 16), (100, 16)])
def test_batch_rows(n, rows):
    """A candidate of 16 strips or more is scored 16 a device call, its
    last batch padded with empty rows, as the JAX trainer batches; one of
    fewer strips in the power of two of rows that holds them."""
    assert score.batch_size(n) == rows


def _run_vocab():
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                normalize_string="none", using_capcode=2, level=5,
                reset_token_ids=True)
    return v


@pytest.mark.parametrize("path", ["eager", "captured"])
def test_junction_repair_inside_a_batch(request, path):
    """Tokens "aa", "a", "x": after an "x", a run of "a" puts lanes out of
    the text's phase, so two strips of a batch do not hold; each is
    scored again alone, op by op, repaired from its own view of the
    batch's staging and its record grids, and the candidate equals
    native, the strips that held counted once."""
    if path == "captured":
        request.getfixturevalue("captured")
    v = _run_vocab()
    sc = _scorer(v, device="cpu")
    sc.prepare(list(v.tokens))
    cand = sc.build(list(v.tokens))
    strips = [b"xaaxa" * 40, b"x" + b"a" * 1500, b"axa" * 100,
              b"x" + b"a" * 700 + b"xaaxa" * 9, b"aax" * 50]
    assert len(sc._sup.tokenizer._plan(len(strips[1]))[1]) == 2
    got = sc.score(cand, strips)
    _assert_equal(got, native_score(cand, strips))
    assert sc.repairs >= 2 and sc.eager_scores["repair"] == 2


def test_captured_path_equals_eager(captured):
    """The card's path on the CPU: each batch loaded into a graph's static
    inputs and replayed, another candidate's tables copied in before its
    first replay; scores equal the eager path's and native's, one graph
    a (lanes, dispatches, batch, bucket, ids) key."""
    v = VOCABS["capcode"]()
    tokens = list(v.tokens)
    sc = _scorer(v, device="cpu")
    sc.prepare(tokens)
    tk = sc._sup.tokenizer
    strips = _strips("capcode", v)
    cap = score.ids_cap(len(tk.vocab.reverse))
    for drops in drop_sets(v, 13):
        cand = candidate(sc, tokens, drops, False)
        tabs = candidate_runtime_state(sc._sup, cand)
        got = sc.score(cand, strips)
        _assert_equal(got, native_score(cand, strips))
        eager = score.score_strips(tk, tabs, strips, len(cand.reverse))
        np.testing.assert_array_equal(got[0], eager[0])
    width = tables.bucket_width(len(tokens))
    assert sorted(tk._graphs) == [("score", LANES, 1, 16, width, cap),
                                  ("score", LANES, 2, 16, width, cap)]
    assert tk.captures == 2


def test_two_threads_replay_one_graph(captured):
    """Two threads score different candidates at once on one superset
    tokenizer, both through one graph a key (the lock held from load to
    the read of the outputs, switching threads every few microseconds):
    each candidate's scores equal its own scored alone."""
    v = VOCABS["capcode"]()
    tokens = list(v.tokens)
    sc = _scorer(v, device="cpu")
    sc.prepare(tokens)
    strips = _strips("capcode", v)
    cands = [candidate(sc, tokens, d, False) for d in drop_sets(v, 17)[1:]]
    alone = [sc.score(c, strips) for c in cands]
    assert not np.array_equal(alone[0][0], alone[1][0])
    results = [[] for _ in cands]

    def work(i):
        for _ in range(3):
            results[i].append(sc.score(cands[i], strips))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(cands))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for want, got in zip(alone, results):
        assert len(got) == 3
        for g in got:
            _assert_equal(g, want)
    assert sc._sup.tokenizer.captures == 2


def test_op_by_op_paths_are_counted(monkeypatch):
    """What stays op by op is counted by cause: a candidate on its own
    tables (one a call), a split strip's shares (two slots, one strip)
    and none for a candidate on the superset over whole strips."""
    v = VOCABS["capcode"]()
    tokens = list(v.tokens)
    sc = _scorer(v, device="cpu")
    sc.prepare(tokens)
    strips = _strips("capcode", v, [900, 1900])
    sc.score(candidate(sc, tokens, [], False), strips)
    assert sc.eager_scores == {"own_tables": 0, "split_share": 0,
                               "repair": 0}
    lacking = sc.build(tokens + [b"zz top"])
    _assert_equal(sc.score(lacking, strips), native_score(lacking, strips))
    assert sc.eager_scores["own_tables"] == sc.own_table_scores == 1
    two = _scorer(v, device=["cpu", "cpu"])
    two.prepare(tokens)
    cand = candidate(two, tokens, drop_sets(v, 3)[1], False)
    _assert_equal(two.score(cand, strips[1:]),
                  native_score(cand, strips[1:]))
    assert two.eager_scores["split_share"] == 2
    assert two.eager_scores["own_tables"] == 0
