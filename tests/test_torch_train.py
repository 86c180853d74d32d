"""The trainer on the port: ``GpuCandidateScorer(device="cpu")`` (the plain
versions of the match, decide and follow kernels, the PyTorch score
epilogue) against the JAX ``CandidateScorer``'s Pallas path (interpret
mode) and the native scorer on the torch_cases vocabularies, its junction
repairs on the device and its refusals; and ``train_vocab(backend="cuda",
device="cpu")``, the port's own loop, against the JAX package's loop
with ``backend="native"``: the same deletions every round, the same files,
the same best vocabulary.  Tolerance 0 throughout.  The JAX scorer and
loop reach the JAX package's native library: every test here loads it
race-safely first (``torch_cases.heal_jax_native``)."""

import logging
import os
import shutil

import numpy as np
import pytest

from tokenmonster_tpu.core.vocab import Vocab
from tokenmonster_tpu.train import trainvocab as ref
from tokenmonster_tpu.train.getalltokens import (get_all_tokens,
                                                 load_tokens_file,
                                                 save_tokens_file)
from tokenmonster_tpu_torch.ops import tables
from tokenmonster_tpu_torch.ops.scan import GpuTokenizer
from tokenmonster_tpu_torch.train import trainvocab as port
from tokenmonster_tpu_torch.train.trainvocab import GpuCandidateScorer

from torch_cases import (VOCABS, ZERO_STEP_TEXT, ZERO_STEP_TOKENS, candidate,
                         drop_sets, heal_jax_native, native_score, text_for,
                         with_unk, zero_step_vocab)
from torch_cases import jax_native  # noqa: F401 (autouse fixture)

LOGGERS = ("tokenmonster_tpu.trainvocab", "tokenmonster_tpu_torch.trainvocab")


def _scorer(v, cls=GpuCandidateScorer, **kw):
    sc = cls(v.charset, v.using_capcode, v.normalizer.flag, **kw)
    sc.set_specials([])
    return sc


@pytest.mark.parametrize("name", ["capcode", "plain", "unk", "utf16"])
def test_scorer_equals_jax_pallas_and_native(name):
    """Three drop sets of each vocabulary over two strips (with bytes the
    candidates lack) and an empty one."""
    v = VOCABS[name]()
    unk = name == "unk"
    tokens = list(v.tokens)
    jsc = _scorer(v, with_unk(ref.CandidateScorer) if unk
                  else ref.CandidateScorer, backend="tpu")
    assert jsc.prepare_pallas(tokens)
    sc = _scorer(v, with_unk(GpuCandidateScorer) if unk
                 else GpuCandidateScorer, device="cpu")
    sc.prepare(tokens, hashmatch_tables=jsc._pal["tabs"])
    strips = [text_for(name, v, size, seed=size) for size in (1500, 3001)]
    strips.append(b"")
    saw_missing = False
    for drops in drop_sets(v, 7):
        cand = candidate(sc, tokens, drops, unk)
        s, n_tok, miss = sc.score(cand, strips)
        js, jt, jm = jsc.score(cand, strips)
        ns, nt, nm = native_score(cand, strips)
        np.testing.assert_array_equal(s, np.asarray(js))
        np.testing.assert_array_equal(s, ns)
        assert n_tok == jt == nt and miss == jm == nm, len(drops)
        saw_missing |= bool(miss)
    assert saw_missing
    assert jsc.tpu_compiles == 1       # every JAX score took the fast path
    assert sc.repairs == 0


def test_jax_native_healed_after_a_lost_race(monkeypatch):
    """A worker whose first JAX native load failed (a lost build race)
    caches the failure; healed, the JAX native scorer runs and equals the
    port's."""
    from tokenmonster_tpu import native as jnative
    v = VOCABS["capcode"]()
    monkeypatch.setattr(jnative, "_lib", "unavailable")
    with pytest.raises(RuntimeError, match="unavailable"):
        jnative.NativeVocab(v)
    assert heal_jax_native() is jnative.get_lib() is not None
    strips = [text_for("capcode", v, 2000, seed=3)]
    js, jt, jm = ref.CandidateScorer(v.charset, v.using_capcode,
                                     v.normalizer.flag).score(v, strips)
    ns, nt, nm = native_score(v, strips)
    np.testing.assert_array_equal(js, ns)
    assert jt == nt and jm == nm and jt > 0


def test_multi_dispatch_strip(monkeypatch):
    """Lanes of 32 bytes: a 40 kB strip chains three dispatches."""
    monkeypatch.setattr(port, "CHUNK", 32)
    v = VOCABS["capcode"]()
    sc = _scorer(v, device="cpu")
    sc.prepare(list(v.tokens))
    strip = text_for("capcode", v, 40000, seed=9)
    assert len(sc._sup.tokenizer._plan(len(strip))[1]) == 3
    cand = candidate(sc, list(v.tokens), drop_sets(v, 3)[1], False)
    got = sc.score(cand, [strip])
    want = native_score(cand, [strip])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2]
    assert sc.repairs == 0


def test_zero_advance_step_scored_exactly():
    """Before a byte the candidate lacks, " ut" gives way to its
    alternative " ", which advances 0 bytes: it covers no chars, counts as
    one token, and the "u" after it keeps its char."""
    sc = _scorer(zero_step_vocab(), device="cpu")
    sc.prepare(ZERO_STEP_TOKENS)
    cand = sc.build(ZERO_STEP_TOKENS)
    strips = [ZERO_STEP_TEXT, b"out\xc2"]
    got = sc.score(cand, strips)
    want = native_score(cand, strips)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2] == {0xC2}
    assert got[0][cand.reverse.index(b"u")] == 31
    assert sc.repairs == 0


def _run_vocab(capcode: int):
    """Tokens "aa", "a" and "x": after an "x", a run of "a" is tokenized in
    pairs from an odd position, and lanes that start inside the run at even
    ones stay out of phase with it to its end.  Capcode 2 adds the delete
    token's second fd row."""
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                normalize_string="none", using_capcode=capcode, level=5,
                reset_token_ids=True)
    return v


@pytest.mark.parametrize("capcode", [0, 2])
def test_junction_repaired_on_the_device(capcode):
    """The run's one junction shares no state: a repair lane follows the
    text's chain on from the left lane, and the strip is scored on the
    device, equal to native."""
    v = _run_vocab(capcode)
    sc = _scorer(v, device="cpu")
    sc.prepare(list(v.tokens))
    cand = sc.build(list(v.tokens))
    strips = [b"x" + b"a" * 3000, b"xaaxa" * 50]
    got = sc.score(cand, strips)
    assert sc.repairs == 1
    want = native_score(cand, strips)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_repairs_across_dispatches(monkeypatch):
    """Lanes of 32 bytes: a run of "a" through three dispatches fails every
    junction, bridge lanes included.  Repair lanes that double in span
    cover its 1,300-odd lanes in a few dozen repairs, equal to native."""
    monkeypatch.setattr(port, "CHUNK", 32)
    v = _run_vocab(0)
    sc = _scorer(v, device="cpu")
    sc.prepare(list(v.tokens))
    cand = sc.build(list(v.tokens))
    strip = b"x" + b"a" * 40000 + b"xaaxa" * 20
    assert len(sc._sup.tokenizer._plan(len(strip))[1]) == 3
    got = sc.score(cand, [strip])
    want = native_score(cand, [strip])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert 3 <= sc.repairs <= 30


def test_candidate_that_does_not_fit_raises():
    v = VOCABS["capcode"]()
    sc = _scorer(v, device="cpu")
    with pytest.raises(RuntimeError, match="prepare"):
        sc.score(sc.build(list(v.tokens)), [b"the"])
    drop = next(t for t in v.tokens if len(t) > 1)
    tokens = [t for t in v.tokens if t != drop]
    sc.prepare(tokens)
    with pytest.raises(ValueError, match="not in the prepared superset"):
        sc.score(sc.build(list(v.tokens)), [b"the"])
    unk = sc.build(tokens)
    assert unk.enable_unk_token()                # the superset has none
    with pytest.raises(ValueError, match="unk id"):
        sc.score(unk, [b"the"])
    with pytest.raises(ValueError, match="specials"):
        sc.set_specials([b"the"])
    with pytest.raises(ValueError, match="backend"):
        GpuCandidateScorer(1, 2, 0, backend="native", device="cpu")


def test_superset_of_2_20_entries_raises(monkeypatch):
    """Token words pack 20-bit dictionary indices: a superset of 2^20
    entries or more arms as any other, in REMAP mode (match tables only,
    its candidates decided on tables of their own size), and what still
    raises is a candidate at the limit, and a tokenizer of a vocabulary at
    the limit, before anything is built.  Shown with the limit lowered to
    this small pool."""
    assert tables.MAX_ENTRIES == 1 << 20
    v = VOCABS["plain"]()
    monkeypatch.setattr(tables, "MAX_ENTRIES", len(v.tokens))
    sc = _scorer(v, device="cpu")
    sc.prepare(list(v.tokens))
    assert sc._sup.tokenizer.tables.match_only
    assert sc._sup.tokenizer.tables.meta is None
    cand = candidate(sc, list(v.tokens), drop_sets(v, 3)[1], False)
    strips = [text_for("plain", v, 1500, seed=2)]
    got, want = sc.score(cand, strips), native_score(cand, strips)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    with pytest.raises(NotImplementedError, match="2\\^20"):
        sc.score(sc.build(list(v.tokens)), strips)
    with pytest.raises(NotImplementedError, match="item 14"):
        sc._sup.tokenizer.tokenize(strips[0])
    with pytest.raises(NotImplementedError, match="item 14"):
        GpuTokenizer(v, device="cpu")        # raises before any upload


SEED_TEXT = (b"The quick brown fox jumps over the lazy dog. The dog sleeps "
             b"while the fox runs through the forest; every morning the sun "
             b"rises over the mountains and the birds sing their songs. ")


@pytest.fixture(scope="module")
def pool_file(tmp_path_factory):
    corpus = SEED_TEXT * 40
    counter, char_table, header = get_all_tokens(
        corpus, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=10, min_occur_singles=1, chunk_size=1 << 20,
        micro_chunks=1, add_extra_tokens=False)
    path = tmp_path_factory.mktemp("pool") / "all.tok"
    save_tokens_file(path, counter, char_table, header)
    return corpus, str(path)


def _train(backend, corpus, dictionary, results, caplog, **cfg):
    """Run one backend; returns (best .tok path, its round log lines)."""
    caplog.clear()
    kw = dict(vocab_size=120, workers=2, fast=True, seed=7, keep_trying=5,
              backend=backend, **cfg)
    with caplog.at_level(logging.INFO, logger=LOGGERS[0]), \
            caplog.at_level(logging.INFO, logger=LOGGERS[1]):
        if backend == "native":
            best = ref.train_vocab(corpus, dictionary, results,
                                   ref.TrainConfig(**kw))
        else:
            best = port.train_vocab(corpus, dictionary, results,
                                    port.TrainConfig(**kw), device="cpu")
    rounds = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("round ")]
    return best, rounds


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


def test_train_vocab_equals_native(pool_file, tmp_path, caplog):
    """A seeded run to its end: the same deletions in every round, the
    same files byte for byte, the same best vocabulary; then a resume from
    that results directory, bounded to a few rounds, does the same."""
    corpus, tok = pool_file
    runs = {}
    for backend in ("native", "cuda"):
        runs[backend] = _train(backend, corpus, tok,
                               str(tmp_path / backend), caplog)
    (best_n, rounds_n), (best_c, rounds_c) = runs["native"], runs["cuda"]
    assert rounds_c == rounds_n and len(rounds_n) > 5
    assert "deleted 0;" not in rounds_n[0]
    names = _same_files(tmp_path / "native", tmp_path / "cuda")
    assert os.path.basename(best_c) == os.path.basename(best_n)
    assert (sorted(load_tokens_file(best_c)["tokens"])
            == sorted(load_tokens_file(best_n)["tokens"]))
    assert any(n.startswith("interval_") for n in names)

    resumed = {}
    for backend in ("native", "cuda"):
        src = tmp_path / f"resume_{backend}"
        shutil.copytree(tmp_path / "native", src)
        resumed[backend] = _train(backend, corpus, str(src), str(src),
                                  caplog, max_rounds=4)[1]
    assert resumed["cuda"] == resumed["native"] and resumed["cuda"]
    _same_files(tmp_path / "resume_native", tmp_path / "resume_cuda")


def test_train_vocab_defaults_to_the_device(pool_file, tmp_path,
                                            monkeypatch):
    """A default ``TrainConfig`` scores on the device: ``train_vocab``
    builds a ``GpuCandidateScorer`` and every candidate goes through it;
    the host scorer runs only when the caller asks for "native"."""
    corpus, tok = pool_file
    built, scored = [], []

    class Recording(GpuCandidateScorer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

        def score(self, cand, datasets):
            scored.append(cand)
            return super().score(cand, datasets)

    monkeypatch.setattr(port, "GpuCandidateScorer", Recording)
    cfg = port.TrainConfig(vocab_size=120, workers=2, fast=True, seed=7,
                           max_rounds=1)
    assert cfg.backend == "cuda"
    port.train_vocab(corpus, tok, str(tmp_path), cfg, device="cpu")
    assert len(built) == 1 and built[0].device.type == "cpu"
    assert len(scored) >= 1


def test_train_vocab_refuses_other_backends(pool_file, tmp_path):
    """The port's loop scores with "native" or "cuda"; the JAX package's
    mesh-sharded "tpu" backend is "cuda" here, and asking for it raises
    and says so.  The loop is the port's own:
    its scorers subclass the port's CandidateScorer, and no name of the
    JAX trainer module is rebound."""
    corpus, tok = pool_file
    for backend in ("tpu", "pallas"):
        with pytest.raises(ValueError, match="'cuda' backend here"):
            port.train_vocab(corpus, tok, str(tmp_path),
                             port.TrainConfig(vocab_size=120,
                                              backend=backend),
                             device="cpu")
    assert port.CandidateScorer is not ref.CandidateScorer
    assert issubclass(GpuCandidateScorer, port.CandidateScorer)
    assert not issubclass(GpuCandidateScorer, ref.CandidateScorer)
    assert not hasattr(port, "_seam")
