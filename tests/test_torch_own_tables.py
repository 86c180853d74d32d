"""The trainer's scorer on a candidate's own tables, on the CPU (the plain
kernel versions), tolerance 0 (every output is an integer).

``GpuCandidateScorer(device="cpu").score`` scores a candidate that no
prepared superset fits on a hash placement of its own, uploaded as full
``DeviceTables``: where no superset was prepared, where the superset lacks
one of its tokens, has another unk id, delete config or charset or
dictionary order, and after the specials changed.  Each case equals
- the JAX ``CandidateScorer(backend="tpu")`` with no superset prepared
  (its exact XLA scorer; ``_score_tpu``), or with the same superset
  prepared, which falls back to that scorer for the same candidates;
- the port's native scorer (``tm_tokenize_score``);
- where the candidate fits a superset, the port's REMAP path.
Also: a strip over several dispatches, a junction repaired on the device,
the zero-advance step, candidates at token words of S = 21 and S = 22
(``tables.MAX_ENTRIES`` lowered; the latter on a placement of 22-bit
index fields), two scoring slots, and two gloo processes.  The JAX scorer
reaches the JAX package's native library: every test loads it
race-safely first (``torch_cases.heal_jax_native``)."""

import dataclasses

import numpy as np
import pytest

import tokenmonster_tpu_torch.ops.hashmatch as phm
from tokenmonster_tpu.train import score_helpers as jhelpers
from tokenmonster_tpu.train import trainvocab as ref
from tokenmonster_tpu_torch.core.vocab import Vocab
from tokenmonster_tpu_torch.ops import tables
from tokenmonster_tpu_torch.ops.scan import GpuTokenizer
from tokenmonster_tpu_torch.train import score_helpers
from tokenmonster_tpu_torch.train import trainvocab as port
from tokenmonster_tpu_torch.train.trainvocab import GpuCandidateScorer

import torch_multidevice_cases as cases
from torch_cases import (VOCABS, ZERO_STEP_TEXT, ZERO_STEP_TOKENS, candidate,
                         drop_sets, native_score, offset_placement, text_for,
                         with_unk, zero_step_vocab)
from torch_cases import jax_native  # noqa: F401 (autouse fixture)

RANK_TIMEOUT_S = 300


def _scorer(v, cls, **kw):
    sc = cls(v.charset, v.using_capcode, v.normalizer.flag, **kw)
    sc.set_specials([])
    return sc


def _held(got, cand, strips, *others):
    """``got`` (scores, token count, missing set) equals native's and each
    of ``others``' (a JAX or port scorer) for ``cand`` over ``strips``."""
    want = [native_score(cand, strips)]
    want += [sc.score(cand, strips) for sc in others]
    for s, n_tok, miss in want:
        np.testing.assert_array_equal(got[0], np.asarray(s))
        assert got[1] == n_tok and got[2] == miss


@pytest.fixture
def own_shifts(monkeypatch):
    """The token-word shift and index-field width of every tokenizer the
    trainer arms on a candidate's own tables (not a superset's match-only
    tables)."""
    seen = []

    class Recording(GpuTokenizer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            if not self.tables.match_only:
                seen.append((self.tables.w3_shift, self.tables.idx1_bits))

    monkeypatch.setattr(port, "GpuTokenizer", Recording)
    return seen


@pytest.mark.parametrize("name", ["capcode", "plain", "unk", "utf16"])
def test_unprepared_scorer_equals_jax_exact_native_and_remap(name,
                                                             own_shifts):
    """Capcode 2 with the delete token, capcode 0 without it, with an unk
    token, and UTF-16 (charset 2): three drop sets over two strips with
    bytes the candidates lack and an empty one, scored by a scorer never
    prepared, against the JAX exact scorer never prepared, native, and the
    port's scorer prepared on the whole vocabulary (REMAP mode)."""
    v = VOCABS[name]()
    unk = name == "unk"
    tokens = list(v.tokens)
    jsc = _scorer(v, with_unk(ref.CandidateScorer) if unk
                  else ref.CandidateScorer, backend="tpu")
    cls = with_unk(GpuCandidateScorer) if unk else GpuCandidateScorer
    own = _scorer(v, cls, device="cpu")
    remap = _scorer(v, cls, device="cpu")
    remap.prepare(tokens)
    strips = [text_for(name, v, size, seed=size) for size in (1500, 3001)]
    strips.append(b"")
    saw_missing = False
    for drops in drop_sets(v, 7):
        cand = candidate(remap, tokens, drops, unk)
        got = own.score(cand, strips)
        _held(got, cand, strips, jsc, remap)
        saw_missing |= bool(got[2])
    assert saw_missing or name == "utf16"
    assert jsc._pal is None and jsc.tpu_compiles >= 1
    assert own.own_table_scores == 3 and remap.own_table_scores == 0
    assert [s for s, _bits in own_shifts] == [20] * 3 and own.repairs == 0


def _misfit(kind, sc, v, tokens):
    """A candidate the superset ``sc`` (prepared on ``tokens``) does not
    fit, of ``kind``, or ("fits") one it fits."""
    drop = next(t for t in v.tokens if len(t) > 1)
    sub = [t for t in tokens if t != drop]
    if kind == "fits":
        return sc.build(sub)
    if kind == "missing_token":
        return sc.build(sub + [b"zebra quartz"])
    if kind == "unk":
        cand = sc.build(sub)
        assert cand.enable_unk_token()
        return cand
    if kind == "delete":                    # capcode 0: no delete token
        return port.CandidateScorer(v.charset, 0, v.normalizer.flag).build(sub)
    if kind == "charset":
        return port.CandidateScorer(0, v.using_capcode,
                                    v.normalizer.flag).build(sub)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["fits", "missing_token", "unk", "delete",
                                  "charset", "order"])
def test_prepared_superset_that_does_not_fit(kind):
    """A superset prepared in both packages: the port's fit test says "does
    not fit" (None) exactly where the JAX ``candidate_runtime_state``
    does, and the candidate is scored on its own tables, equal to the JAX
    scorer (which falls back to its exact scorer there) and native.
    "order": both supersets' dictionary indices reversed, so no candidate
    keeps the superset's order."""
    v = VOCABS["capcode"]()
    tokens = [t for t in v.tokens if t != b" zebras"]
    jsc = _scorer(v, ref.CandidateScorer, backend="tpu")
    assert jsc.prepare_pallas(tokens)
    sc = _scorer(v, GpuCandidateScorer, device="cpu")
    sc.prepare(tokens, hashmatch_tables=jsc._pal["tabs"])
    cand = _misfit("fits" if kind == "order" else kind, sc, v, tokens)
    if kind == "order":
        n = len(sc._sup.index)
        rev = {t: n - 1 - i for t, i in sc._sup.index.items()}
        sc._sup = dataclasses.replace(sc._sup, index=rev)
        jsc._pal["sup_index"] = rev
    fits = kind == "fits"
    assert (score_helpers.candidate_host_state(sc._sup, cand) is None) \
        == (jhelpers.candidate_runtime_state(jsc._pal, cand) is None) \
        == (not fits)
    strips = [text_for("capcode", v, 2500, seed=3), b"Zebra quartz \x01"]
    compiles = jsc.tpu_compiles
    _held(sc.score(cand, strips), cand, strips, jsc)
    assert sc.own_table_scores == (0 if fits else 1) and sc.repairs == 0
    # the JAX scorer's fast path compiles its Pallas step, its exact
    # scorer an XLA step: one or the other, once
    assert jsc.tpu_compiles == compiles + 1


def test_specials_changed_after_arming():
    """``set_specials`` with a new set keeps the armed superset, as the JAX
    package's does: candidates that hold the new specials take their own
    tables (the JAX scorer its exact scorer), the rest stay in REMAP
    mode."""
    v = VOCABS["capcode"]()
    tokens = list(v.tokens)
    jsc = _scorer(v, ref.CandidateScorer, backend="tpu")
    assert jsc.prepare_pallas(tokens)
    sc = GpuCandidateScorer(v.charset, v.using_capcode, v.normalizer.flag,
                            device="cpu", pool=tokens)
    sc.set_specials([])                       # prepares the pool
    armed = sc._sup
    strips = [text_for("capcode", v, 2000, seed=6) + b"<s> the <s>", b"<s>"]
    plain = sc.build(tokens)
    _held(sc.score(plain, strips), plain, strips, jsc)
    sc.set_specials([b"<s>"])
    jsc.set_specials([b"<s>"])
    assert sc._sup is armed
    special = sc.build(tokens + [b"<s>"])
    assert b"<s>" not in armed.index
    _held(sc.score(special, strips), special, strips, jsc)
    assert sc.own_table_scores == 1
    _held(sc.score(plain, strips), plain, strips, jsc)
    assert sc.own_table_scores == 1


def _run_vocab(capcode: int):
    """Tokens "aa", "a" and "x": after an "x", no lane inside a run of "a"
    shares a state with the text's chain."""
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                normalize_string="none", using_capcode=capcode, level=5,
                reset_token_ids=True)
    return v


def test_strip_over_several_dispatches(monkeypatch):
    """Lanes of 32 bytes: a 40 kB strip chains three dispatches on the
    candidate's own tables."""
    monkeypatch.setattr(port, "CHUNK", 32)
    v = VOCABS["capcode"]()
    tokens = list(v.tokens)
    jsc = _scorer(v, ref.CandidateScorer, backend="tpu")
    sc = _scorer(v, GpuCandidateScorer, device="cpu")
    remap = _scorer(v, GpuCandidateScorer, device="cpu")
    remap.prepare(tokens)
    strip = text_for("capcode", v, 40000, seed=9)
    assert len(remap._sup.tokenizer._plan(len(strip))[1]) == 3
    cand = candidate(sc, tokens, drop_sets(v, 3)[1], False)
    got = sc.score(cand, [strip])
    _held(got, cand, [strip], jsc, remap)
    assert got[2] and sc.own_table_scores == 1 and sc.repairs == 0


@pytest.mark.parametrize("capcode", [0, 2])
def test_junction_repaired_on_the_device(monkeypatch, capcode):
    """Lanes of 32 bytes: a run of "a" through three dispatches fails every
    junction, bridge lanes included; the own-tables path repairs them on
    the device, equal to native, the JAX exact scorer (which sends the
    strip to native) and REMAP mode with the same repairs."""
    monkeypatch.setattr(port, "CHUNK", 32)
    v = _run_vocab(capcode)
    tokens = list(v.tokens)
    jsc = _scorer(v, ref.CandidateScorer, backend="tpu")
    sc = _scorer(v, GpuCandidateScorer, device="cpu")
    remap = _scorer(v, GpuCandidateScorer, device="cpu")
    remap.prepare(tokens)
    cand = sc.build(tokens)
    strips = [b"x" + b"a" * 40000 + b"xaaxa" * 20]
    _held(sc.score(cand, strips), cand, strips, jsc, remap)
    assert 3 <= sc.repairs == remap.repairs <= 30
    assert sc.own_table_scores == 1 and remap.own_table_scores == 0


def test_zero_advance_step():
    """Before a byte the candidate lacks, " ut" gives way to its
    alternative " ", which advances 0 bytes, on the candidate's own
    tables, equal to native and REMAP mode.  The JAX exact scorer clamps
    that step to one byte, a fault of the JAX device path (the port's
    decide has kept the step since it was found), so it is held to it only
    for the candidate without "tim", which never takes the step."""
    v = zero_step_vocab()
    sc = _scorer(v, GpuCandidateScorer, device="cpu")
    jsc = _scorer(v, ref.CandidateScorer, backend="tpu")
    remap = _scorer(v, GpuCandidateScorer, device="cpu")
    remap.prepare(ZERO_STEP_TOKENS)
    strips = [ZERO_STEP_TEXT, b"out\xc2"]
    for toks in (ZERO_STEP_TOKENS, [t for t in ZERO_STEP_TOKENS
                                    if t != b"tim"]):
        cand = sc.build(toks)
        got = sc.score(cand, strips)
        _held(got, cand, strips, remap)
        assert got[2] == {0xC2} and got[0][cand.reverse.index(b"u")] == 31
        if b"tim" not in toks:
            _held(got, cand, strips, jsc)
        else:
            assert jsc.score(cand, strips)[1] == got[1] - 31
    assert sc.own_table_scores == 2 and remap.own_table_scores == 0


def _wide_build(bits: int):
    """``build_hashmatch`` with index fields of ``bits`` bits."""
    def build(keys, indices=None, space_prefix=None):
        assert indices is None
        return offset_placement(phm, keys, 0, bits, space_prefix)
    return build


@pytest.mark.parametrize("shift", [21, 22])
@pytest.mark.parametrize("name", ["capcode", "unk"])
def test_candidate_of_wide_token_words(name, shift, monkeypatch,
                                       own_shifts):
    """A candidate at ``tables.MAX_ENTRIES`` (lowered to the vocabulary's
    size) takes the wide token word, S = 21; with ``W3_SHIFT_WIDE`` 22 and
    a placement of 22-bit index fields, as a candidate of more than 2^21
    entries has, S = 22.  A prepared superset at the limit does not fit
    it (REMAP candidates keep S = 20), so it is scored on its own tables,
    equal to the JAX exact scorer and native.  A candidate below the limit
    stays in REMAP mode, unless its unk id (the superset's) is past the
    limit: a literal id of the token words that needs S = 21 too."""
    v = VOCABS[name]()
    unk = name == "unk"
    tokens = list(v.tokens)
    monkeypatch.setattr(tables, "MAX_ENTRIES", len(tokens))
    if shift == 22:
        monkeypatch.setattr(tables, "W3_SHIFT_WIDE", 22)
        monkeypatch.setattr(port, "build_hashmatch", _wide_build(22))
    cls = with_unk(GpuCandidateScorer) if unk else GpuCandidateScorer
    jsc = _scorer(v, with_unk(ref.CandidateScorer) if unk
                  else ref.CandidateScorer, backend="tpu")
    own = _scorer(v, cls, device="cpu")
    sup = _scorer(v, cls, device="cpu")
    sup.prepare(tokens)
    strips = [text_for(name, v, size, seed=size) for size in (1700, 2900)]
    whole = candidate(sup, tokens, [], unk)
    assert tables.w3_shift(whole) == shift
    got = own.score(whole, strips)
    _held(got, whole, strips, jsc, sup)
    assert own_shifts[0][0] == shift
    assert (own_shifts[0][1] == 22) == (shift == 22)
    assert own.own_table_scores == sup.own_table_scores == 1
    small = candidate(sup, tokens, drop_sets(v, 4)[1], unk)
    small_shift = tables.w3_shift(small)
    assert small_shift == (shift if unk else 20)
    _held(own.score(small, strips), small, strips, jsc, sup)
    assert own_shifts[-1][0] == small_shift
    assert sup.own_table_scores == 1 + unk


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu"] * 3])
@pytest.mark.parametrize("case", ["own_whole", "own_split", "own_repair",
                                  "own_unk"])
def test_slots_on_own_tables_equal_one_device(case, devices):
    """``torch_multidevice_cases.own_table_cases`` over two and three "cpu"
    slots: whole strips, one strip split by dispatch, a split strip whose
    shares do not hold (scored again whole, with repairs), and a candidate
    whose unk id the prepared superset lacks; each slot arms the
    candidate's own tables from one placement, and the result equals one
    device's and native's."""
    one_sc, cand, strips = cases.own_table_cases("cpu")[case]
    two_sc, _cand, _strips = cases.own_table_cases(devices)[case]
    assert len(two_sc._slots) == len(devices) and one_sc._slots is None
    with cases.split_geometry():
        got, one = two_sc.score(cand, strips), one_sc.score(cand, strips)
    np.testing.assert_array_equal(got[0], one[0])
    assert got[1:] == one[1:]
    _held(got, cand, strips)
    assert two_sc.own_table_scores == one_sc.own_table_scores == 1
    assert two_sc.repairs == one_sc.repairs
    assert (two_sc.repairs > 0) == (case == "own_repair")


def test_slots_arm_own_tables_from_one_placement(monkeypatch):
    """Each call builds the candidate's placement once on the host; every
    slot holds its own copy of the tables."""
    built, armed = [], []
    real = port.build_hashmatch

    def counting(*args, **kw):
        built.append(1)
        return real(*args, **kw)

    class Recording(GpuTokenizer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            armed.append(self)

    monkeypatch.setattr(port, "build_hashmatch", counting)
    monkeypatch.setattr(port, "GpuTokenizer", Recording)
    sc, cand, strips = cases.own_table_cases(["cpu"] * 3)["own_split"]
    del built[:], armed[:]           # the other cases' supersets
    with cases.split_geometry():
        sc.score(cand, strips)
    assert len(built) == 1 and len(armed) == 3
    assert len({tk.tables.fields.data_ptr() for tk in armed}) == 3
    assert all(tk.tables.meta is not None and tk.tables.rank is None
               for tk in armed)


@pytest.fixture(scope="module")
def own_ranks(tmp_path_factory):
    """Two gloo processes (tests/torch_multihost_worker.py, mode "own")
    scoring ``own_table_cases``; each has its own timeout."""
    return cases.launch_ranks(tmp_path_factory.mktemp("own_ranks"), "cpu",
                              RANK_TIMEOUT_S, mode="own")


@pytest.mark.parametrize("case", ["own_whole", "own_split", "own_repair",
                                  "own_unk"])
def test_two_processes_on_own_tables_score_as_one(own_ranks, case):
    """Each candidate split over two ranks on its own tables and
    all-reduced: both ranks hold one process's scores, token count and
    missing set, and native's."""
    sc, cand, strips = cases.own_table_cases("cpu")[case]
    with cases.split_geometry():
        s, n_tok, miss = sc.score(cand, strips)
    _held((s, n_tok, miss), cand, strips)
    for got, _log in own_ranks:
        np.testing.assert_array_equal(got[case], s)
        meta = got[case + "_meta"]
        assert meta[0] == n_tok and list(meta[2:]) == sorted(miss)
        assert int(got[case + "_own"]) == 1
    # each rank repairs what it holds: the strip's first share is rank 0's
    assert own_ranks[0][0][case + "_meta"][1] == sc.repairs
    assert own_ranks[1][0][case + "_meta"][1] == 0


def test_train_vocab_stays_in_remap_mode(tmp_path, monkeypatch):
    """Every candidate of a seeded ``train_vocab`` run, to its end, fits
    the superset the loop prepares: its scorer scores none on own tables,
    and the run writes the native backend's files."""
    scorers = []

    class Recording(GpuCandidateScorer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            scorers.append(self)

    monkeypatch.setattr(port, "GpuCandidateScorer", Recording)
    cases.pool(str(tmp_path))
    cases.train(str(tmp_path / "cuda"), "cpu")
    cases.train(str(tmp_path / "native"), None, backend="native")
    assert len(scorers) == 1 and scorers[0]._sup is not None
    assert scorers[0].own_table_scores == 0
    names = sorted(p.name for p in (tmp_path / "native").iterdir())
    assert names and names == sorted(p.name for p in (tmp_path / "cuda").iterdir())
    for n in names:
        assert ((tmp_path / "native" / n).read_bytes()
                == (tmp_path / "cuda" / n).read_bytes()), n
