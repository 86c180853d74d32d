"""Shared inputs of the tokenmonster_tpu_torch tests: the vocabularies the
port is held on, texts for them made from seeded numpy, the hash-match
tables both packages are given, ``heal_jax_native``, which loads the
JAX package's native library safely before a test reaches it, and the
trainer tests' small pool (``pool_file``)."""

import fcntl
import os
import time
import types

import numpy as np
import pytest
import torch

from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode
from tokenmonster_tpu.ops.hashmatch import build_hashmatch
from tokenmonster_tpu_torch import native as tnative
from tokenmonster_tpu_torch.train.trainvocab import CandidateScorer
from tokenmonster_tpu_torch.ops.decide import decide
from tokenmonster_tpu_torch.ops.match import match
from tokenmonster_tpu_torch.ops.tables import (W3_SHIFT_WIDE, decide_entries,
                                              meta_width, space_prefix,
                                              upload_tables)

OVERLAP = 128     # OVERLAP_SCAN of both packages
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")

ENGLISH = (
    b"The quick brown fox jumps over the lazy dog. Pack my box with five "
    b"dozen liquor jugs. How vexingly quick daft zebras jump! The five "
    b"boxing wizards jump quickly. Sphinx of black quartz, judge my vow. "
    b"int main() { printf(\"hello world\\n\"); return 0; } // C code\n"
    b"def f(x):\n    return x * 2  # python\n"
)

SEED_TEXT = (b"The quick brown fox jumps over the lazy dog. The dog sleeps "
             b"while the fox runs through the forest; every morning the sun "
             b"rises over the mountains and the birds sing their songs. ")


@pytest.fixture(scope="module")
def pool_file(tmp_path_factory):
    """(corpus, path) of the trainer tests' small seeded run: the port's
    getalltokens pool of ``SEED_TEXT`` * 40 (capcode 2, NFD, balanced)."""
    from tokenmonster_tpu_torch.train.getalltokens import (get_all_tokens,
                                                           save_tokens_file)
    corpus = SEED_TEXT * 40
    counter, char_table, header = get_all_tokens(
        corpus, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=10, min_occur_singles=1, chunk_size=1 << 20,
        micro_chunks=1, add_extra_tokens=False)
    path = tmp_path_factory.mktemp("pool") / "all.tok"
    save_tokens_file(path, counter, char_table, header)
    return corpus, str(path)


U16_WORDS = ["jump", "ser", "er", "s", "ing", "box", "vow", "judge", "ge",
             "in", "rve", "serve", "inger"]


def plain_vocab():
    """Capcode 0, no delete token: the one-row path."""
    v = Vocab()
    v._generate(
        tokens=[b" the", b"the", b" quick", b"quick", b" brown", b" fox",
                b"he", b"er", b"e", b"t", b" ", b"o", b"x", b" jumps",
                b" over", b" lazy", b" dog", b"s", b"ing", b"\n", b".",
                b"q", b"u", b"i", b"c", b"k", b"b", b"r", b"w", b"n"],
        charset=1, normalize_string="none", using_capcode=0,
        level=5, reserve=8, reset_token_ids=True)
    return v


def capcode_vocab():
    """Capcode 2 with a delete token: both forward-delete rows."""
    v = Vocab()
    v._generate(
        tokens=[b" hello", b" world", b"hello", b"hell", b"he", b" he",
                b" the", b"the", b" quick", b"quick", b" brown", b" fox",
                b" jump", b"jumps", b" over", b" lazy", b" dog", b"ing",
                b" box", b" liquor", b" five", b" judge", b" my", b" vow",
                b"er", b" ju", b"mp", b" zebras", b"s ", b"e ", b"d ",
                b" return", b"return", b" int", b"int", b" main", b"main",
                b"() {", b"; }", b" printf", b"(\"", b"\\n\"); ", b" x",
                b" def", b" f(x):", b"    ", b" * 2", b" #", b" python",
                b"  ", b"   ", b"    ", b"\n"],
        charset=1, normalize_string="none", using_capcode=2,
        level=5, reserve=8, reset_token_ids=True)
    return v


def utf16_vocab():
    """UTF-16 charset with a delete token: lil_off 2."""
    def u16(s):
        return s.encode("utf-16-le")
    toks = [u16(t) for t in ["jump", " jump", "ser", " ser", "er", " er",
                             "s", "ing", " box", "boxing", " vow", " jumps",
                             " judge", "judgeing", " inger", " serve",
                             "rve", " in", "ge", " ge", "box", "vow",
                             " vowing"]]
    singles = [u16(c) for c in "abcdefghijklmnopqrstuvwxyz ."]
    v = Vocab()
    v._generate(tokens=toks + singles + [b"\x7f"], charset=2,
                normalize_string="none", using_capcode=1, level=5,
                reset_token_ids=True)
    return v


# Pairs of keys whose full 32-bit poly hashes are equal (found by search):
# a placement keeps one of each pair in its hash table and the other as an
# overflow key, compared byte by byte.
HASH_TWINS = [(b"znDeo1", b"oq6MQK"), (b"YJdx4D", b"ygIqmL"),
              (b"V9Lw1.xj", b"jCXld7o.")]
LONG_KEYS = [b"The quick brown fox jumps over the lazy!", b"x" * 40,
             b"0123456789" * 4, b"The quick brown fox jumps"]


def edge_vocab(capcode: int):
    """Keys at the edges of the match kernel: overflow keys (HASH_TWINS),
    keys of the longest length (40 bytes, LONG_KEYS) and their prefixes,
    and the printable single bytes.  Capcode 1 adds its delete token
    (0x7f), so the space-stripped entries share the classes."""
    singles = [bytes([b]) for b in range(32, 127 + (capcode == 1))]
    toks = [k for pair in HASH_TWINS for k in pair] + LONG_KEYS
    toks += [b" " + k for k in toks] + [b"The", b" quick", b"xx", b"xxxx"]
    v = Vocab()
    v._generate(tokens=toks + singles + [b"\n"], charset=1,
                normalize_string="none", using_capcode=capcode, level=5,
                reset_token_ids=True)
    return v


def edge_text(size: int, seed: int) -> bytes:
    """``size`` bytes of the edge vocabulary's keys and of their near
    misses (one byte changed), seeded, at every offset."""
    rng = np.random.default_rng(seed)
    keys = [k for pair in HASH_TWINS for k in pair] + LONG_KEYS
    parts, total = [], 0
    while total < size:
        k = bytearray(keys[rng.integers(len(keys))])
        if rng.random() < 0.3:
            k[rng.integers(len(k))] = 0x61 + int(rng.integers(26))
        sep = b" " * int(rng.integers(0, 3))
        parts.append(bytes(k) + sep)
        total += len(parts[-1])
    return b"".join(parts)[:size]


def unk_vocab():
    """The capcode-0 vocabulary with an unk token: misses emit unk."""
    v = plain_vocab()
    assert v.enable_unk_token()
    return v


def realtext_vocab(size: int):
    return Vocab.load(os.path.join(EXAMPLES, f"realtext-{size}-fast.vocab"))


VOCABS = {
    "plain": plain_vocab,
    "capcode": capcode_vocab,
    "utf16": utf16_vocab,
    "unk": unk_vocab,
    "realtext1024": lambda: realtext_vocab(1024),
}


def text_for(name: str, vocab, size: int, seed: int = 0,
             misses: bool = True) -> bytes:
    """``size`` bytes of normalized text for vocabulary ``name``: English
    and code pieces drawn with seeded numpy and, with ``misses``, a few
    control bytes no test vocabulary has (unk emissions for "unk",
    fallbacks for the vocabularies without unk)."""
    rng = np.random.default_rng(seed)
    if name == "utf16":
        parts = []
        while sum(map(len, parts)) < size:
            parts.append(U16_WORDS[rng.integers(len(U16_WORDS))])
            if rng.random() < 0.5:
                parts.append(" ")
        return "".join(parts).encode("utf-16-le")[:size // 2 * 2]
    words = ENGLISH.split(b" ")
    parts = []
    while sum(map(len, parts)) < size + 64:
        parts.append(words[rng.integers(len(words))])
    for at in rng.integers(0, len(parts), 3 if misses else 0):
        parts[at] = parts[at] + b"\x01\x02"
    raw = b" ".join(parts)
    if vocab.using_capcode == 0:
        return raw[:size]
    return normalize_and_capcode(raw, vocab.using_capcode,
                                 vocab.normalizer)[:size]


def hashmatch_tables(vocab):
    """The JAX package's match tables for ``vocab`` (one build, shared by
    both packages in a test)."""
    return build_hashmatch(vocab.tokens, space_prefix=space_prefix(vocab))


def decisions(name, n_bytes, N, misses=True):
    """(ctl, tok) int32 decision words of a seeded text, via the port's
    match and decide stages (held equal to the JAX ones elsewhere)."""
    v = VOCABS[name]()
    dt = upload_tables(v, hashmatch_tables(v), "cpu")
    data = text_for(name, v, n_bytes, seed=4, misses=misses)
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    n = len(data)
    if dt.has_space:
        m, mb = match(buf, n, dt)
    else:
        m, mb = match(buf, n, dt), None
    ctl, tok = decide(m, mb, buf, n, dt)
    return ctl, tok, n


WIDE_OFFSET = 1 << 20


def wide_tables(dt, off: int = WIDE_OFFSET, w3_shift: int = W3_SHIFT_WIDE):
    """``dt``'s decide and id tables with S = ``w3_shift`` and every
    dictionary index moved up by ``off`` (below it, entries of zero
    planes): what decide and id resolution read for the same text in a
    vocabulary of more than ``off`` entries, so ``off = 2^20`` sets every
    index's bit 20.  Match words go with them through ``wide_matches``."""
    n, dev = dt.meta.shape[1], dt.meta.device
    meta = torch.zeros((2, meta_width(off + n)), dtype=torch.int32,
                       device=dev)
    meta[:, off:off + n] = dt.meta
    ids3 = torch.zeros((off + dt.ids3.shape[0], 3), dtype=torch.int32,
                       device=dev)
    ids3[off:] = dt.ids3
    out = types.SimpleNamespace(**{k: getattr(dt, k) for k in (
        "bb", "has_delete", "has_unk", "unk_token", "delete_token",
        "literals", "lil_off", "has_space")})
    out.meta, out.ids3, out.w3_shift = meta, ids3, w3_shift
    out.entries = decide_entries(meta, 2 if dt.has_delete else 1)
    return out


def wide_matches(m, off: int = WIDE_OFFSET):
    """Match words (int32) with their indices moved up by ``off``."""
    return None if m is None else torch.where(m != 0, m + (off << 6), m)


def wide_words(ctl, tok, off: int, w3_shift: int):
    """Token words of S = 20 (``tok``, with their decisions ``ctl``) as a
    vocabulary of more than ``off`` entries has them at S = ``w3_shift``:
    every token's index moved up by ``off`` (a literal id and a word with
    no token are not), the w3 field moved to the new shift."""
    t = tok.long() & 0xFFFFFFFF
    idx, w3 = t & ((1 << 20) - 1), (t >> 20) & 3
    moved = (((ctl.long() >> 7) & 1) != 0) & (w3 != 3)
    return (torch.where(moved, idx + off, idx) | (w3 << w3_shift)).to(
        torch.int32)


def offset_placement(hm, keys, off: int, idx1_bits: int,
                     space_prefix: bytes | None = None):
    """A hash placement of ``keys`` built with the hash-match module ``hm``
    (the port's ``ops/hashmatch.py`` or the JAX package's) as its
    ``build_hashmatch`` builds one, with every dictionary index moved up by
    ``off`` and packed in ``idx1_bits``-bit fields, one
    ``build_class_table`` per length class: the placement a vocabulary of
    more than ``off`` entries has for these keys, at a small one's size."""
    single = np.full(256, -1, np.int32)
    space_single = np.full(256, -1, np.int32) if space_prefix else None
    space_empty = -1
    by_len = {}

    def slot(k):
        return by_len.setdefault(len(k), {}).setdefault(k, [k, -1, -1])

    for i, k in enumerate(keys, off):
        k = bytes(k)
        if len(k) == 1:
            single[k[0]] = i
        elif len(k) >= 2:
            slot(k)[1] = i
        if space_prefix is not None and k.startswith(space_prefix):
            rest = k[len(space_prefix):]
            if not rest:
                space_empty = i
            elif len(rest) == 1:
                space_single[rest[0]] = i
            else:
                slot(rest)[2] = i
    n_idx = 2 if space_prefix is not None else 1
    classes = [hm.build_class_table(ln, list(e.values()), n_idx=n_idx,
                                    idx1_bits=idx1_bits)
               for ln, e in sorted(by_len.items())]
    return hm.HashMatchTables(
        classes=classes, single=single,
        max_len=max((len(bytes(k)) for k in keys), default=0),
        n_keys=len(keys), has_space=space_prefix is not None,
        space_single=space_single, space_empty=space_empty,
        lil_off=len(space_prefix) if space_prefix else 1)


def u32(t):
    return t.numpy().view(np.uint32)


def native_ids(v, data):
    """(ids u32, missing) of the port's native tokenizer."""
    ids, missing = tnative.NativeVocab(v).tokenize(data)
    return np.asarray(ids, np.uint32), missing


def native_score(v, datasets):
    """(scores int64 [n_ids], tokens in text, missing set) of the port's
    native trainer scorer (``tm_tokenize_score``): its
    ``CandidateScorer(backend="native").score``, which raises when the
    library cannot be built."""
    tnative.load_native()
    return CandidateScorer(v.charset, v.using_capcode,
                           v.normalizer.flag).score(v, datasets)


JAX_NATIVE_LOCK = os.path.join(ROOT, "build", "tokenmonster_tpu_native.lock")
JAX_NATIVE_WAIT_S = 300   # longest wait for another process's build


def heal_jax_native():
    """The JAX package's native library, loaded however this process's
    first ``tokenmonster_tpu.native.get_lib`` went.  That loader compiles
    every process to one shared temporary file and caches a failure for
    the process's lifetime, so a test worker that lost a build race to
    another would see "native library unavailable" in every later call
    (the JAX scorer's ``NativeVocab``, the JAX trainer loop).  Here the
    load runs under an ``fcntl`` lock; a failed (or cached failed) load is
    retried once, after any other builder's temporary file is gone.
    Raises RuntimeError when the library still cannot be loaded."""
    from tokenmonster_tpu import native as jnative
    build_dir = os.path.join(os.path.dirname(jnative.__file__), "_build")
    os.makedirs(os.path.dirname(JAX_NATIVE_LOCK), exist_ok=True)
    with open(JAX_NATIVE_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        lib = jnative.get_lib()
        if lib is None:
            tmp = os.path.join(build_dir, "tm_native.so.tmp")
            deadline = time.monotonic() + JAX_NATIVE_WAIT_S
            while os.path.exists(tmp) and time.monotonic() < deadline:
                time.sleep(0.2)
            with jnative._lock:
                jnative._lib = None
            lib = jnative.get_lib()
    if lib is None:
        raise RuntimeError(f"the JAX package's native library is "
                           f"unavailable: {build_dir} holds no loadable "
                           "tm_native.so and g++ could not build it")
    return lib


@pytest.fixture(autouse=True)
def jax_native():
    """Autouse in every test file that imports it: those files reach the
    JAX package's native library (its scorer, loop, api or getalltokens),
    so each test first loads it with ``heal_jax_native``."""
    heal_jax_native()


def with_unk(scorer_cls):
    """``scorer_cls`` whose ``build`` enables the unk token: the superset
    it prepares carries one, and candidates made from that superset's
    vocabulary by deleting tokens (``_generate(delete_tokens=...)``, which
    keeps every id) keep its unk id."""
    class UnkScorer(scorer_cls):
        def build(self, token_list):
            v = super().build(token_list)
            assert v.enable_unk_token()
            return v
    return UnkScorer


def candidate(scorer, tokens, drops, unk: bool):
    """A candidate vocabulary: ``tokens`` less ``drops``, built the way the
    trainer builds one (``scorer.build``); with ``unk``, the superset
    vocabulary with ``drops`` deleted, so its unk id stays the superset's.
    """
    if not unk:
        return scorer.build([t for t in tokens if t not in set(drops)])
    v = scorer.build(tokens)
    v._generate(delete_tokens=list(drops))
    return v


def drop_sets(v, seed: int, k: int = 3):
    """``k`` seeded drop sets of about a fifth of ``v``'s multi-byte tokens
    each (the first is empty: the whole superset)."""
    rng = np.random.default_rng(seed)
    multi = [bytes(t) for t in v.tokens if len(t) > 1]
    out = [[]]
    for _ in range(k - 1):
        pick = rng.random(len(multi)) < 0.2
        out.append([t for t, p in zip(multi, pick) if p])
    return out


def port_ctl(ctl, tok, meta):
    """The JAX decide kernel's ctl words (u32) as the port's decide writes
    them.  The JAX kernel clamps every advance to at least one byte; at fd 1
    the port advances an alternative branch (w3 1 or 2) whose alternative
    is one byte long, the virtual space alone, by 0 bytes, as the native
    tokenizer does.  ``tok``: the JAX tok words; ``meta``: the meta planes
    (2, R*128) the decide read."""
    ctl = np.array(ctl, np.uint32)
    if ctl.ndim == 1:
        return ctl
    tok = np.asarray(tok, np.uint32)[1]
    w3 = (tok >> 20) & 3
    f0 = np.asarray(meta)[0][np.minimum(tok & 0xFFFFF,
                                        meta.shape[1] - 1)].astype(np.uint32)
    alt_len = np.where(w3 == 1, (f0 >> 16) & 0xFF, (f0 >> 24) & 0xFF)
    zero = ((w3 == 1) | (w3 == 2)) & (alt_len == 1)
    assert ((ctl[1][zero] & 63) == 1).all()
    ctl[1][zero] -= 1
    return ctl


ZERO_STEP_TOKENS = [b" ", b"D", b"o", b"t", b"u", b"time", b" ut", b"tim"]
ZERO_STEP_TEXT = (b"out\xc2" + b"time" * 2) * 30


def zero_step_vocab(unk: bool = False):
    """Capcode 2 with a delete token, where "o" then " ut" is a forward-
    delete branch and, before the missing byte after "ut", " ut" gives way
    to its alternative " ", the virtual space alone: that step advances 0
    bytes (o, D, " ", u, t on "out\\xc2").  ``ZERO_STEP_TEXT`` holds it 30
    times.
    ``ZERO_STEP_TOKENS`` are its tokens as the trainer builds them."""
    v = Vocab()
    v._generate(tokens=ZERO_STEP_TOKENS, charset=1, normalize_string="none", using_capcode=2,
                level=5, reset_token_ids=True)
    if unk:
        assert v.enable_unk_token()
    return v
