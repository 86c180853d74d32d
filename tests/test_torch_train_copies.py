"""The port's copies of the JAX package's trainer layers against their
originals on the CPU, tolerance 0: the getalltokens pool file byte for byte
on a seeded corpus, the port's own ``train_vocab(backend="native")`` loop
(round log and every file written) against the JAX loop, and
``ops/tables.py::from_reference_tables`` (a JAX placement carried into the
port's class) against a fresh placement of the port's; the corpus helpers
(``train/dataset_helpers.py``) and the vocabulary importers
(``train/imports.py``: GPT-2 ``vocab.json``, sentencepiece) on inputs the
tests write."""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from tokenmonster_tpu.ops import hashmatch as jhm
from tokenmonster_tpu.train import dataset_helpers as jdh
from tokenmonster_tpu.train import getalltokens as jgat
from tokenmonster_tpu.train import imports as jimp
from tokenmonster_tpu.train import trainvocab as jtv
from tokenmonster_tpu_torch.ops import hashmatch as thm
from tokenmonster_tpu_torch.ops import tables
from tokenmonster_tpu_torch.train import dataset_helpers as tdh
from tokenmonster_tpu_torch.train import getalltokens as tgat
from tokenmonster_tpu_torch.train import imports as timp
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
    """``TM_GAT_DEVICE=1`` sorts on the default card, with no host
    fallback: without a card it raises (tests/test_torch_device_sort.py
    runs the sort on the CPU by name)."""
    monkeypatch.setenv("TM_GAT_DEVICE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
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


LATIN = b"The quick brown fox. Caf\xc3\xa9 na\xc3\xafve r\xc3\xa9sum\xc3\xa9. " * 20
LATIN_CASES = {
    "greek-between": (LATIN + "Κείμενο στα ελληνικά ".encode() * 20 + LATIN,
                      50),
    "invalid-utf8": (LATIN + b"\xff\xfe broken \xc3" + LATIN, 50),
    "short-runs": (b"abc \xce\xb1 " * 300 + LATIN, 200),
    "cyrillic-long-run": ("Привет мир ".encode() * 50 + LATIN * 3, 10),
}


@pytest.mark.parametrize("case", list(LATIN_CASES))
def test_only_valid_latin_equals_jax(case):
    data, min_run = LATIN_CASES[case]
    got = tdh.only_valid_latin(data, min_run=min_run)
    assert got == jdh.only_valid_latin(data, min_run=min_run)
    assert b"quick" in got


@pytest.mark.parametrize("field,separator", [("text", b"\n"),
                                             ("body", b"\x00")])
def test_extract_text_equals_jax(tmp_path, field, separator):
    """The jsonl inputs of tests/test_aux.py, with a malformed line, an
    empty value and a non-string value, through both packages."""
    src = tmp_path / "a.jsonl"
    src.write_text(f'{{"{field}": "hello"}}\n{{"{field}": "world"}}\n'
                   f'{{"other": 1}}\nnot json\n\n{{"{field}": ""}}\n'
                   f'{{"{field}": 42}}\n{{"{field}": "caf\u00e9"}}\n')
    out = {}
    for name, mod in (("port", tdh), ("jax", jdh)):
        path = tmp_path / f"{name}.txt"
        n = mod.extract_text([src, src], path, field=field,
                             separator=separator)
        out[name] = (n, path.read_bytes())
    assert out["port"] == out["jax"] and out["port"][0] == 8


def test_sample_code_files_equals_jax(tmp_path):
    tree = tmp_path / "tree"
    rng = np.random.default_rng(4)
    for d, names in (("a", ["x.py", "y.go"]), ("a/b", ["long.rs", "n.txt"]),
                     ("c", ["z.c"])):
        (tree / d).mkdir(parents=True, exist_ok=True)
        for name in names:
            n_lines = int(rng.integers(5, 600))
            (tree / d / name).write_bytes(b"\n".join(
                b"line %d of %s" % (i, name.encode()) for i in range(n_lines)))
    out = {}
    for name, mod in (("port", tdh), ("jax", jdh)):
        path = tmp_path / f"{name}.txt"
        n = mod.sample_code_files(tree, path, per_dir=1, mid_lines=200)
        out[name] = (n, path.read_bytes())
    assert out["port"] == out["jax"] and out["port"][0] == 3


def _vocab_bytes(v, path) -> bytes:
    v.save(str(path))
    return path.read_bytes()


GPT2_TOKENS = ["!", "a", "b", "c", "Ġ", "Ċ", "ĉ", "č", "Ġthe", "Ġquick",
               "ing", "Ġb", "rown", "ĠĠ", "Ċ Ċ", "é", "Ã©", "<|endoftext|>"]


def test_gpt2_byte_decoder_equals_jax():
    assert timp.gpt2_byte_decoder() == jimp.gpt2_byte_decoder()
    assert sorted(timp.gpt2_byte_decoder().values()) == list(range(256))


@pytest.mark.parametrize("full", [True, False])
def test_import_gpt2_json_equals_jax(tmp_path, full):
    """A small GPT-2 ``vocab.json`` written by the test (byte-level
    alphabet, a plain token, the end-of-text special) through both
    importers: the same vocabulary file and the same ids."""
    path = tmp_path / "vocab.json"
    path.write_text(json.dumps({t: i for i, t in enumerate(GPT2_TOKENS)}),
                    encoding="utf-8")
    got = timp.import_gpt2_json(path, full_byte_decode=full)
    want = jimp.import_gpt2_json(path, full_byte_decode=full)
    assert (_vocab_bytes(got, tmp_path / "port.vocab")
            == _vocab_bytes(want, tmp_path / "jax.vocab"))
    text = b"the quick brown\n\n\tcaf\xc3\xa9 <|endoftext|>"
    ids, missing = got.tokenize(text)
    want_ids, want_missing = want.tokenize(text)
    np.testing.assert_array_equal(ids, want_ids)
    assert missing == want_missing


SP_PIECES = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
             ("<0x41>", -1.0, 6), ("<0x0A>", -1.1, 6), ("▁the", -2.0, 1),
             ("▁quick", -3.0, 1), ("▁fox", -3.5, 1), ("qu", -4.0, 1),
             ("ick", -4.5, 1), ("th", -5.0, 1), ("e", -6.0, 1),
             ("t", -6.2, 1), ("h", -6.3, 1), ("i", -6.4, 1), ("c", -6.5, 1),
             ("k", -6.6, 1), ("▁", -6.7, 1), ("<user>", 0.0, 4)]


def _sp_varint(v: int) -> bytes:
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _sp_model(path):
    """A sentencepiece ModelProto as tests/test_sentencepiece.py builds it:
    pieces (field 1: piece, score, type), then an unknown field to skip."""
    import struct
    blob = b""
    for piece, score, ptype in SP_PIECES:
        body = (b"\x0a" + _sp_varint(len(piece.encode())) + piece.encode()
                + b"\x15" + struct.pack("<f", score)
                + b"\x18" + _sp_varint(ptype))
        blob += b"\x0a" + _sp_varint(len(body)) + body
    path.write_bytes(blob + b"\x12\x03abc")
    return path


def test_read_sentencepiece_model_equals_jax(tmp_path):
    path = _sp_model(tmp_path / "tokenizer.model")
    got = timp.read_sentencepiece_model(path)
    assert got == jimp.read_sentencepiece_model(path)
    assert [g[0] for g in got] == [p[0] for p in SP_PIECES]


def test_import_sentencepiece_model_equals_jax(tmp_path):
    path = _sp_model(tmp_path / "tokenizer.model")
    got = timp.import_sentencepiece_model(path)
    want = jimp.import_sentencepiece_model(path)
    assert (_vocab_bytes(got, tmp_path / "port.vocab")
            == _vocab_bytes(want, tmp_path / "jax.vocab"))
    ids, missing = got.tokenize(b" the quick fox A")
    want_ids, want_missing = want.tokenize(b" the quick fox A")
    np.testing.assert_array_equal(ids, want_ids)
    assert missing == want_missing


def test_import_sentencepiece_tokens_equals_jax(tmp_path):
    """The token-list importer on tests/test_aux.py's list."""
    toks = ["<unk>", "▁the", "▁quick", "▁brown", "fox", "qu", "ick", "the",
            "▁", "t", "h", "e", "q", "u", "i", "c", "k", "b", "r", "o", "w",
            "n", "f", "x", " "]
    enc = [t.encode() for t in toks]
    got = timp.import_sentencepiece_tokens(enc)
    want = jimp.import_sentencepiece_tokens(enc)
    assert (_vocab_bytes(got, tmp_path / "port.vocab")
            == _vocab_bytes(want, tmp_path / "jax.vocab"))
    tid, found = got.token_to_id(b" the")
    assert found and tid == toks.index("▁the")
