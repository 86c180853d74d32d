"""The port's own copies of the JAX package's framework-free layers against
their originals on the CPU, tolerance 0: normalisation, capcode encode and
decode, ``core.vocab.Vocab.load`` of both in-repo vocabularies (tokens,
ids, the host oracle's ids and the decode of a seeded text), the native
library's ``tokenize`` and ``tm_tokenize_score``, and the user API."""

import os

import numpy as np
import pytest

from tokenmonster_tpu import api as japi
from tokenmonster_tpu import native as jnative
from tokenmonster_tpu.core import capcode as jcc
from tokenmonster_tpu.core import normalize as jnorm
from tokenmonster_tpu.core.vocab import Vocab as JVocab
from tokenmonster_tpu_torch import api as tapi
from tokenmonster_tpu_torch import native as tnative
from tokenmonster_tpu_torch.core import capcode as tcc
from tokenmonster_tpu_torch.core import normalize as tnorm
from tokenmonster_tpu_torch.core.vocab import Vocab as TVocab

from torch_cases import EXAMPLES, VOCABS, text_for
from torch_cases import jax_native  # noqa: F401 (autouse fixture)

VOCAB_FILES = ["realtext-1024-fast.vocab", "realtext-32000-fast.vocab"]
FLAGS = ["none", "nfd", "lowercase", "accents", "quotemarks", "collapse",
         "trim", "leadingspace", "unixlines",
         "nfd lowercase accents quotemarks collapse unixlines"]
PIECES = ["The", " quick", " BROWN", " fox", " Ünïcödé", " café", "“quoted”",
          " ‘it’s’", "  ", "\t", "\r\n", "\n", " naïve", " ÉCOLE",
          " x2", " 42", " İstanbul", " Σίσυφος", " ﬁne", " ½", " ", "McDonald"]


def seeded_text(seed: int, n_pieces: int = 600) -> bytes:
    rng = np.random.default_rng(seed)
    return "".join(PIECES[i] for i in rng.integers(0, len(PIECES),
                                                   n_pieces)).encode()


@pytest.mark.parametrize("flags", FLAGS)
def test_normalize_equals_jax(flags):
    for seed in range(3):
        raw = seeded_text(seed)
        want = jnorm.Normalizer(flags).normalize(raw)
        got = tnorm.Normalizer(flags).normalize(raw)
        assert got == want
        assert tnorm.Normalizer(flags).flag == jnorm.Normalizer(flags).flag


@pytest.mark.parametrize("kind", ["capcode", "nocapcode"])
def test_capcode_encode_decode_equals_jax(kind):
    enc = {"capcode": (jcc.encode, tcc.encode),
           "nocapcode": (jcc.no_capcode_encode, tcc.no_capcode_encode)}[kind]
    dec = {"capcode": (jcc.decode, tcc.decode),
           "nocapcode": (jcc.no_capcode_decode, tcc.no_capcode_decode)}[kind]
    for seed in range(3):
        raw = seeded_text(10 + seed)
        want = enc[0](raw)
        got = enc[1](raw)
        assert got == want and got != raw
        assert dec[1](got) == dec[0](want)


@pytest.mark.parametrize("name", VOCAB_FILES)
def test_vocab_load_equals_jax(name):
    """Every array of the loaded vocabulary, the ids and decode of a seeded
    text by the host oracle, and its normalisation."""
    path = os.path.join(EXAMPLES, name)
    jv, tv = JVocab.load(path), TVocab.load(path)
    assert list(map(bytes, tv.tokens)) == list(map(bytes, jv.tokens))
    for attr in ("id", "id1", "id2", "flag", "nwords", "index1", "index2",
                 "len1", "len2", "begin_byte"):
        np.testing.assert_array_equal(getattr(tv, attr), getattr(jv, attr),
                                      err_msg=attr)
    for attr in ("charset", "using_capcode", "level", "max_token_length",
                 "delete_token", "unk_token", "vocab_size"):
        assert getattr(tv, attr) == getattr(jv, attr), attr
    assert tv.normalizer.flag == jv.normalizer.flag
    raw = seeded_text(20, 300)
    assert tv.normalize(raw) == jv.normalize(raw)
    tids, tmiss = tv.tokenize(raw)
    jids, jmiss = jv.tokenize(raw)
    np.testing.assert_array_equal(tids, jids)
    assert tmiss == jmiss and len(tids) > 0
    assert tv.decode(tids) == jv.decode(jids)


@pytest.mark.parametrize("name", list(VOCABS) + ["realtext32000"])
def test_native_tokenize_and_score_equal_jax(name):
    """The port's native library (its own build of the same C++) against
    the JAX package's: ids, missing counts, per-id scores, token counts and
    missing-byte masks on seeded texts."""
    if name == "realtext32000":
        v = JVocab.load(os.path.join(EXAMPLES, "realtext-32000-fast.vocab"))
        data = v.normalize(seeded_text(30, 2000))
    else:
        v = VOCABS[name]()
        data = text_for(name, v, 6000, seed=5)
    tn, jn = tnative.NativeVocab(v), jnative.NativeVocab(v)
    assert not tnative.library_path().startswith(
        os.path.dirname(jnative.__file__))
    for threads in (1, 4):
        tids, tmiss = tn.tokenize(data, threads=threads)
        jids, jmiss = jn.tokenize(data, threads=threads)
        np.testing.assert_array_equal(tids, jids)
        assert tmiss == jmiss and len(tids) > 0
    n_ids = len(v.reverse) + 1
    ts, js = np.zeros(n_ids, np.int64), np.zeros(n_ids, np.int64)
    tm, jm = np.zeros(256, np.uint8), np.zeros(256, np.uint8)
    assert tn.tokenize_score(data, ts, tm) == jn.tokenize_score(data, js, jm)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tm, jm)
    assert ts.sum() > 0


def test_api_vocab_equals_jax():
    """The port's user API on its native route (small inputs, route
    "auto") equals the JAX package's: ids, dtype, decode, counts and the
    dictionary view, and so do the ids of its multiprocess-safe
    client."""
    path = os.path.join(EXAMPLES, "realtext-1024-fast.vocab")
    jv, tv = japi.load(path), tapi.load(path, device="cpu")
    texts = [seeded_text(40 + i, 80).decode() for i in range(3)]
    for t in texts:
        got, want = tv.tokenize(t), jv.tokenize(t)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert tv.decode(got) == jv.decode(want)
        assert tv.tokenize_count(t) == jv.tokenize_count(t)
    assert tv.last_route == "native"
    assert tv.get_dictionary() == jv.get_dictionary()
    assert (tv.vocab_size, tv.capcode(), tv.charset(), tv.mode(),
            tv.normalization()) == (jv.vocab_size, jv.capcode(),
                                    jv.charset(), jv.mode(),
                                    jv.normalization())
    remote = tapi.load_multiprocess_safe(path, device="cpu")  # its server
    try:
        np.testing.assert_array_equal(remote.tokenize(texts[0]),
                                      jv.tokenize(texts[0]))
    finally:
        remote._server.close()
