"""The port's copies of the JAX package's trainer layers against their
originals on the CPU, tolerance 0: the getalltokens pool file byte for byte
on a seeded corpus, the port's own ``train_vocab(backend="native")`` loop
(round log and every file written) against the JAX loop, and
``ops/tables.py::from_reference_tables`` (a JAX placement carried into the
port's class) against a fresh placement of the port's."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from tokenmonster_tpu.ops import hashmatch as jhm
from tokenmonster_tpu.train import getalltokens as jgat
from tokenmonster_tpu.train import trainvocab as jtv
from tokenmonster_tpu_torch.ops import hashmatch as thm
from tokenmonster_tpu_torch.ops import tables
from tokenmonster_tpu_torch.train import getalltokens as tgat
from tokenmonster_tpu_torch.train import trainvocab as ttv

from torch_cases import VOCABS
from torch_cases import jax_native  # noqa: F401 (autouse fixture)

CORPUS_WORDS = (b"the quick brown fox jumps over the lazy dog while The "
                b"Forest sleeps; every morning SUN rises over mountains and "
                b"birds sing their songs, caf\xc3\xa9 na\xc3\xafve 42 x2 "
                b"don't stop-believing \"quoted\" (paren) [list] {dict} "
                b"def f(x): return x * 2 # python\n").split(b" ")


def seeded_corpus(seed: int, n_words: int) -> bytes:
    rng = np.random.default_rng(seed)
    return b" ".join(CORPUS_WORDS[i]
                     for i in rng.integers(0, len(CORPUS_WORDS), n_words))


GAT_CASES = {
    "balanced-capcode2-nfd": dict(mode="balanced", using_capcode=2,
                                  normalization="nfd"),
    "clean-capcode1": dict(mode="clean", using_capcode=1,
                           normalization="none"),
    "unfiltered-capcode0-lower": dict(mode="unfiltered", using_capcode=0,
                                      normalization="lowercase"),
}


@pytest.mark.parametrize("case", list(GAT_CASES))
def test_getalltokens_file_equals_jax(case, tmp_path):
    corpus = seeded_corpus(1, 3000)
    kw = dict(GAT_CASES[case], charset=1, min_occur_total=4,
              min_occur_singles=1, chunk_size=1 << 14, micro_chunks=2)
    out = {}
    for name, gat in (("jax", jgat), ("port", tgat)):
        counter, char_table, header = gat.get_all_tokens(corpus, **kw)
        path = tmp_path / f"{name}.tok"
        gat.save_tokens_file(path, counter, char_table, header)
        out[name] = path.read_bytes()
    assert out["port"] == out["jax"] and len(out["port"]) > 1000
    assert tgat.load_tokens_file(tmp_path / "port.tok")["tokens"]


def test_getalltokens_device_sort_not_ported(monkeypatch):
    monkeypatch.setenv("TM_GAT_DEVICE", "1")
    with pytest.raises(NotImplementedError, match="item 11"):
        tgat.get_all_tokens(seeded_corpus(2, 500), "balanced",
                            min_occur_total=2)


@pytest.fixture(scope="module")
def pool_file(tmp_path_factory):
    corpus = seeded_corpus(3, 2500)
    counter, char_table, header = jgat.get_all_tokens(
        corpus, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=8, min_occur_singles=1, chunk_size=1 << 20,
        micro_chunks=1, add_extra_tokens=False)
    path = tmp_path_factory.mktemp("pool") / "all.tok"
    jgat.save_tokens_file(path, counter, char_table, header)
    return corpus, str(path)


def _rounds(caplog, logger, run):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        best = run()
    return best, [r.getMessage() for r in caplog.records
                  if r.getMessage().startswith("round ")]


def test_train_vocab_native_equals_jax_loop(pool_file, tmp_path, caplog):
    """The port's loop with its native scorer deletes what the JAX loop
    deletes, round by round, and writes the same files."""
    corpus, tok = pool_file
    kw = dict(vocab_size=100, workers=2, fast=True, seed=11, keep_trying=4,
              backend="native")
    best_j, rounds_j = _rounds(caplog, "tokenmonster_tpu.trainvocab",
                               lambda: jtv.train_vocab(
                                   corpus, tok, str(tmp_path / "jax"),
                                   jtv.TrainConfig(**kw)))
    best_t, rounds_t = _rounds(caplog, "tokenmonster_tpu_torch.trainvocab",
                               lambda: ttv.train_vocab(
                                   corpus, tok, str(tmp_path / "port"),
                                   ttv.TrainConfig(**kw)))
    assert rounds_t == rounds_j and len(rounds_j) > 5
    assert any(" deleted 0;" not in r for r in rounds_j)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and names
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes()), n
    assert os.path.basename(best_t) == os.path.basename(best_j)


def _fields_equal(a, b, cls):
    for f in dataclasses.fields(cls):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "classes":
            continue
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", ["capcode", "plain", "utf16",
                                  "realtext1024"])
def test_from_reference_tables_equals_port_placement(name):
    """A JAX placement, carried field by field into the port's class,
    equals the port's own placement of the same vocabulary, and so do the
    kernel tables made from each."""
    v = VOCABS[name]()
    pre = tables.space_prefix(v)
    ref = jhm.build_hashmatch(v.tokens, space_prefix=pre)
    got = tables.from_reference_tables(ref)
    own = thm.build_hashmatch(v.tokens, space_prefix=pre)
    assert isinstance(got, thm.HashMatchTables)
    assert tables.from_reference_tables(own) is own
    _fields_equal(got, own, thm.HashMatchTables)
    assert len(got.classes) == len(own.classes) > 0
    for c_got, c_own in zip(got.classes, own.classes):
        assert isinstance(c_got, thm.ClassTable)
        _fields_equal(c_got, c_own, thm.ClassTable)
    a = tables.upload_tables(v, ref)
    b = tables.upload_tables(v, own)
    for key, buf in b.state_dict().items():
        assert torch.equal(a.state_dict()[key], buf), key
    with pytest.raises(TypeError, match="placement"):
        tables.from_reference_tables(object())
