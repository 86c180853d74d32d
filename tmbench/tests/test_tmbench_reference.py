"""The plain reference on the CPU: its vocabulary loader, normalization
and resumable loop against the program's host path (which only these
tests import beside it), pieces spliced against the whole, normalization
in pieces against the whole, and the greedy control reading far from
it."""

import os

import numpy as np
import pytest

from tmbench.frozen.corpus import stdlib_text
from tmbench.harness.cells import ROOT
from tmbench.reference import pool as rp
from tmbench.reference.core.vocab import Vocab
from tmbench.reference.scan import ids_of, scan

VOCAB = os.path.join(ROOT, "examples", "realtext-32000-fast.vocab")


@pytest.fixture(scope="module")
def vocab():
    return Vocab.load(VOCAB)


@pytest.fixture(scope="module")
def text(vocab):
    raw, _dropped = stdlib_text(None, 60 << 10)
    return raw[:60 << 10], vocab.normalize(raw[:60 << 10])


@pytest.fixture(scope="module")
def program():
    from tokenmonster_tpu_torch.core.vocab import Vocab as Program
    return Program.load(VOCAB)


def test_loader_and_normalization_equal_the_programs(vocab, program, text):
    raw, norm = text
    for name in ("flag", "nwords", "index1", "index2", "len1", "len2", "id",
                 "id1", "id2", "begin_byte"):
        assert np.array_equal(getattr(vocab, name), getattr(program, name)), \
            name
    assert vocab.tokens == program.tokens
    assert (vocab.max_token_length, vocab.delete_token, vocab.unk_token,
            vocab.charset, vocab.using_capcode, vocab.normalizer.flag) == (
        program.max_token_length, program.delete_token, program.unk_token,
        program.charset, program.using_capcode, program.normalizer.flag)
    odd = "Ünïcödé ÀB CD Straße ǅ HELLO World's O'Neil\n".encode() * 20
    assert vocab.normalize(raw) == norm == program.normalize(raw)
    assert vocab.normalize(odd) == program.normalize(odd)


def test_scan_equals_the_programs_host_tokenizer(vocab, program, text):
    from tokenmonster_tpu_torch.core.tokenizer import tokenize
    _raw, norm = text
    ids, missing = tokenize(program, norm)
    ev = scan(vocab, norm)
    assert np.array_equal(ids_of(ev), ids)
    assert int(ev.miss.sum()) == missing
    assert ev.pos[-1] == len(norm)


def test_scan_counts_missing_bytes_as_the_tokenizer_does(vocab, program):
    from tokenmonster_tpu_torch.core.tokenizer import tokenize
    data = vocab.normalize(b"plain text \xff\xfe then more\n")
    ids, missing = tokenize(program, data)
    ev = scan(vocab, data)
    assert missing > 0
    assert np.array_equal(ids_of(ev), ids) and int(ev.miss.sum()) == missing


@pytest.mark.parametrize("workers", [0, 2])
def test_pieces_spliced_equal_the_whole(vocab, text, monkeypatch, workers):
    raw, norm = text
    monkeypatch.setattr(rp, "PIECE", 8 << 10)
    whole = scan(vocab, norm)
    with rp.Reference(workers) as ref:
        assert ref.normalize([raw], vocab.normalizer.flag,
                             vocab.using_capcode) == [norm]
        got = ref.events(VOCAB, [norm, norm[:5000]])
    assert np.array_equal(got[0].pos, whole.pos)
    assert np.array_equal(ids_of(got[0]), ids_of(whole))
    assert np.array_equal(ids_of(got[1]), ids_of(scan(vocab, norm[:5000])))


def test_normalize_each_line_equals_the_vocabulary(vocab, text):
    raw, _norm = text
    lines = raw.splitlines(keepends=True)[:200]
    with rp.Reference(0) as ref:
        got = ref.normalize_each(lines, vocab.normalizer.flag,
                                 vocab.using_capcode)
    assert got == [vocab.normalize(x) for x in lines]


def test_control_reads_far_from_the_reference(vocab, text):
    _raw, norm = text
    exact, greedy = ids_of(scan(vocab, norm)), ids_of(scan(vocab, norm,
                                                          greedy=True))
    m = min(len(exact), len(greedy))
    assert int((exact[:m] != greedy[:m]).sum()) > 100

