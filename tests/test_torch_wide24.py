"""Vocabularies of 2^21 - 1 entries or more on the CPU (the plain kernel
versions), tolerance 0: placement index fields of 22 to 24 bits through
match, token words at S = 22 to 24 through decide, follow, compact and id
resolution, the slice through ``GpuTokenizer`` and ``load``, and the
trainer on a superset whose placement has 22-bit fields.

Such tables are hundreds of MB, so each stage is held on a small
vocabulary made to look large: its placement built with every index moved
up (``torch_cases.offset_placement``, in both packages), its decisions'
token words repacked at a wider shift with their indices moved up
(``torch_cases.wide_words``), or, for decide at S = 22, its tables moved
up by 2^21 (``torch_cases.wide_tables``).  The JAX package's match kernel
takes index fields of any width; its decide, follow and compact kernels
keep S = 20, so their words are unpacked field by field at each shift.
The slice and the trainer run with the port's module constants lowered
(``tables.MAX_ENTRIES``, ``tables.W3_SHIFT_WIDE``) and the placement
built with 22-bit fields, as ``tests/test_torch_wide.py`` lowers
``tables.MAX_ENTRIES``.
"""

import logging
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tokenmonster_tpu
import tokenmonster_tpu_torch
from tokenmonster_tpu.ops import hashmatch as jhm
from tokenmonster_tpu.ops import pallas_decide, pallas_match
from tokenmonster_tpu.ops.pallas_decide import make_decide_kernel
from tokenmonster_tpu.ops.pallas_match import make_match_kernel
from tokenmonster_tpu.ops.pallas_stitch import (device_stitch_compact,
                                                make_compact_kernel)
from tokenmonster_tpu.ops.scan import TpuTokenizer
from tokenmonster_tpu.train import trainvocab as ref
from tokenmonster_tpu.train.getalltokens import (get_all_tokens,
                                                 save_tokens_file)
from tokenmonster_tpu_torch.native import NativeVocab
from tokenmonster_tpu_torch.ops import hashmatch as phm
from tokenmonster_tpu_torch.ops import stitch as tstitch
from tokenmonster_tpu_torch.ops import tables
from tokenmonster_tpu_torch.ops.decide import decide, resolve_device
from tokenmonster_tpu_torch.ops.follow import follow
from tokenmonster_tpu_torch.ops.match import match_plain
from tokenmonster_tpu_torch.ops.scan import GpuTokenizer
from tokenmonster_tpu_torch.train import trainvocab as port
from tokenmonster_tpu_torch.train.score_helpers import candidate_runtime_state

from torch_cases import (ENGLISH, EXAMPLES, OVERLAP, VOCABS, candidate,
                         drop_sets, hashmatch_tables, native_score,
                         offset_placement, port_ctl, text_for, u32,
                         wide_matches, wide_tables, wide_words)
from torch_cases import jax_native  # noqa: F401 (autouse fixture)

N = 2048
CHUNK, L, T_REC = 32, 128, 256
# (index field bits, the largest dictionary index of the placement)
FIELDS = [(22, (1 << 21) - 1), (23, 1 << 22), (24, (1 << 24) - 3)]


def _fields(words, S):
    """(idx, w3) of token words (any int array) packed at shift ``S``."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    return w & ((1 << S) - 1), (w >> S) & 3


def _placements(v, bits: int, top: int):
    """The JAX and the port placement of ``v`` with its largest index at
    ``top``, fields of ``bits`` bits, and the offset."""
    off = top - (len(v.tokens) - 1)
    sp = tables.space_prefix(v)
    return (offset_placement(jhm, v.tokens, off, bits, sp),
            offset_placement(phm, v.tokens, off, bits, sp), off)


@pytest.mark.parametrize("name", ["plain", "capcode"])
def test_offset_placement_at_offset_0_is_the_build(name):
    """The helper with no offset, at the width ``build_hashmatch`` picks,
    places as ``build_hashmatch`` does."""
    v = VOCABS[name]()
    sp = tables.space_prefix(v)
    want = phm.build_hashmatch(v.tokens, space_prefix=sp)
    got = offset_placement(phm, v.tokens, 0, want.classes[0].idx1_bits, sp)
    for a, b in zip(tables.flat_tables(got), tables.flat_tables(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tables.smem_scalars(got),
                                  tables.smem_scalars(want))


@pytest.mark.parametrize("bits,top", FIELDS)
@pytest.mark.parametrize("name", ["plain", "capcode"])
def test_wide_placement_equals_in_both_packages(name, bits, top):
    """Both packages' placements at 22 to 24 index bits (44 to 48 with the
    space-stripped index, which spill into the second field word): the
    flat tables, scalars and descriptors equal."""
    v = VOCABS[name]()
    jt, pt, _off = _placements(v, bits, top)
    assert pt.classes[0].idx1_bits == bits
    jflat = pallas_match.flat_tables(jt)
    pflat = tables.flat_tables(pt)
    assert len(jflat) == len(pflat)
    for a, b in zip(jflat, pflat):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(pallas_match.smem_scalars(jt)),
                                  tables.smem_scalars(pt))
    dt = tables.DeviceTables(v, pt, match_only=True)
    assert dt.idx1_bits == bits


@pytest.mark.parametrize("bits,top", FIELDS)
@pytest.mark.parametrize("name", ["plain", "capcode", "utf16"])
def test_match_at_wide_fields_equals_jax(name, bits, top):
    """M (and Mb) of the port's plain match on placements of 22 to 24
    index bits, indices up to 2^24 - 3, against the JAX match kernel
    (interpret mode) and the JAX host oracle."""
    v = VOCABS[name]()
    jt, pt, off = _placements(v, bits, top)
    dt = tables.DeviceTables(v, pt, match_only=True)
    data = text_for(name, v, N - 200, seed=5)
    buf = np.zeros(N, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    n = len(data)
    got = match_plain(torch.from_numpy(buf), n, dt)
    want = make_match_kernel(jt, interpret=True)(jnp.asarray(buf), n)
    got, want = ((got, want) if dt.has_space else ((got,), (want,)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32(g), np.asarray(w))
    m = u32(got[0])
    np.testing.assert_array_equal(m[:n], pallas_match.reference_match(
        jt, data))
    idx = m[m != 0] >> 6
    assert idx.min() >= off and idx.max() <= top
    if bits > 22:                 # every index past the old 21-bit fields
        assert (idx >= 1 << 21).all()


@pytest.mark.parametrize("name", ["capcode", "unk", "utf16"])
def test_decide_at_s22_equals_jax_kernel(name):
    """ctl bit for bit; tok's idx and w3 fields, unpacked at 22 and at
    20, equal, each dictionary index moved up by 2^21 (a literal id is
    not)."""
    off = 1 << 21
    v = VOCABS[name]()
    tabs = hashmatch_tables(v)
    dt = tables.upload_tables(v, tabs, "cpu")
    wide = wide_tables(dt, off, 22)
    data = text_for(name, v, N - 200, seed=1)
    buf = np.zeros(N, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    n = len(data)
    jm = make_match_kernel(tabs, interpret=True)(jnp.asarray(buf), n)
    if tabs.has_space:
        jargs = jm
        m, mb = (torch.from_numpy(np.array(a).view(np.int32)) for a in jm)
    else:
        jargs = (jm,)
        m, mb = torch.from_numpy(np.array(jm).view(np.int32)), None
    want = make_decide_kernel(v, interpret=True)(*jargs, jnp.asarray(buf), n)
    ctl, tok = decide(wide_matches(m, off), wide_matches(mb, off),
                      torch.from_numpy(buf), n, wide)
    np.testing.assert_array_equal(u32(ctl),
                                  port_ctl(want[0], want[1], dt.meta.numpy()))
    idx, w3 = _fields(u32(tok), 22)
    j_idx, j_w3 = _fields(np.asarray(want[1]), 20)
    np.testing.assert_array_equal(w3, j_w3)
    lit = j_w3 == 3
    found = (torch.stack([m, mb]) if mb is not None else m).numpy() != 0
    np.testing.assert_array_equal(idx[~lit], j_idx[~lit] + off * found[~lit])
    if dt.has_unk:
        np.testing.assert_array_equal(idx[lit], j_idx[lit])
    assert (w3 >= 2).any() and (idx >= off).any()     # bits 21 and 23 set


CASES = {
    # name, text bytes, start0, last_lane, final
    "chained": ("realtext1024", L * CHUNK + 400, 3, L - 2, False),
    "unk": ("unk", L * CHUNK - 40, 0, None, True),
}


@pytest.mark.parametrize("S", [22, 23, 24])
@pytest.mark.parametrize("case", sorted(CASES))
def test_follow_compact_resolve_at_wide_shifts_equal_jax(case, S):
    """Token words at S = 22, 23 and 24 with every index moved up by
    2^(S - 1), so the index field's top bit is set: followed, compacted and
    resolved against the 20-bit path and the JAX compact kernel (interpret
    mode) field for field, the delete marker at bit S + 2 where the JAX
    word has it at 22, and the same emitted ids as the JAX
    ``resolve_tokens``."""
    off = 1 << (S - 1)
    name, n_bytes, start0, last_lane, final = CASES[case]
    v = VOCABS[name]()
    dt = tables.upload_tables(v, hashmatch_tables(v), "cpu")
    data = text_for(name, v, min(n_bytes, 6144 - 600), seed=4, misses=True)
    buf = torch.zeros(6144, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    n = len(data)
    mm = match_plain(buf, n, dt)
    m, mb = mm if dt.has_space else (mm, None)
    if last_lane is None:
        last_lane = -(-n // CHUNK) - 1
    ctl, tok = decide(m, mb, buf, n, dt)
    narrow = follow(ctl, tok, n, CHUNK, L, OVERLAP, T_REC)
    got = follow(ctl, wide_words(ctl, tok, off, S), n, CHUNK, L, OVERLAP,
                 T_REC, S)
    assert torch.equal(got[0], narrow[0]) and int(got[2]) == 1
    recs = narrow[0]
    live = (u32(recs) & 0xF) != 0
    idx, w3 = _fields(u32(got[1]), S)
    j_idx, j_w3 = _fields(u32(narrow[1]), 20)
    np.testing.assert_array_equal(w3, j_w3)
    moved = live & (j_w3 != 3)
    np.testing.assert_array_equal(idx[moved], j_idx[moved] + off)
    np.testing.assert_array_equal(idx[~live], 0)

    out_cap = T_REC * L
    r, t = u32(recs), u32(narrow[1])
    toks_aug = t | (((r >> 2) & 1) << 22)
    want = device_stitch_compact(
        jnp.asarray(r), jnp.asarray(toks_aug.T.copy()).reshape(
            L * (T_REC // 128), 128),
        jnp.int32(start0), jnp.int32(last_lane), jnp.bool_(final),
        make_compact_kernel(L, T_REC, out_cap // 128, interpret=True),
        out_cap)
    out = tstitch.device_stitch_compact(got[0], got[1], start0, last_lane,
                                        final, out_cap, S)
    for w, g in zip(want[1:], out[1:5]):
        assert int(g) == int(w)
    count = int(out[1])
    o, jo = u32(out[0]).astype(np.int64), np.asarray(want[0]).astype(np.int64)
    np.testing.assert_array_equal(o[count:], 0)
    np.testing.assert_array_equal(jo[count:], 0)
    o, jo = o[:count], jo[:count]
    np.testing.assert_array_equal((o >> (S + 2)) & 1, (jo >> 22) & 1)
    assert o.max() < 1 << (S + 3)
    idx, w3 = _fields(o & ~(1 << (S + 2)), S)
    j_idx, j_w3 = _fields(jo & ~(1 << 22), 20)
    np.testing.assert_array_equal(w3, j_w3)
    np.testing.assert_array_equal(idx[w3 != 3], j_idx[w3 != 3] + off)
    if bool(out[4]):                     # every kept record emits
        ids3 = torch.zeros((off + dt.ids3.shape[0], 3), dtype=torch.int32)
        ids3[off:] = dt.ids3
        wide = types.SimpleNamespace(ids3=ids3, w3_shift=S,
                                     has_delete=dt.has_delete,
                                     delete_token=dt.delete_token)
        ids = resolve_device(out[0][:count], wide).numpy()
        np.testing.assert_array_equal(
            ids, pallas_decide.resolve_tokens(v, jo.astype(np.uint32)))
        if case == "unk":
            assert (ids == v.unk_token).any()
        if name == "realtext1024":       # forward-delete branches taken
            assert ((o >> (S + 2)) & 1).any() and (ids == v.delete_token).any()


def _vocab(n: int, unk: int | None = None, dele: int | None = None):
    none = 0xFFFFFF
    return types.SimpleNamespace(tokens=range(n), unk_token=none
                                 if unk is None else unk,
                                 delete_token=none if dele is None else dele)


@pytest.mark.parametrize("n,unk,dele,S", [
    ((1 << 20) - 1, None, None, 20), ((1 << 20) - 1, 1 << 20, None, 21),
    (1 << 20, None, None, 21), (1 << 21, None, (1 << 21) - 1, 21),
    ((1 << 21) + 1, None, None, 22), (1000, (1 << 22) + 5, None, 23),
    ((1 << 23) + 1, None, None, 24), ((1 << 24) - 2, None, 0xFFFFFE, 24),
])
def test_w3_shift_is_the_fewest_bits(n, unk, dele, S):
    """S is 20 where the JAX Pallas engine serves the vocabulary, else the
    fewest bits from 21 that hold every dictionary index (n - 1) and the
    unk and delete ids, up to 24; a placement holds up to 2^24 - 2
    entries, the most a vocabulary of 24-bit ids has."""
    assert tables.w3_shift(_vocab(n, unk, dele)) == S
    tables.check_placement(n)
    assert tables.placement_limit() == (1 << 24) - 2
    with pytest.raises(NotImplementedError, match="24 bits"):
        tables.check_placement((1 << 24) - 1)


def _wide_build(bits: int):
    """``build_hashmatch`` with index fields of ``bits`` bits."""
    def build(keys, indices=None, space_prefix=None):
        assert indices is None
        return offset_placement(phm, keys, 0, bits, space_prefix)
    return build


@pytest.fixture
def fields22(monkeypatch):
    """Hash placements, the tokenizer's and the trainer's, built with
    22-bit index fields, as for a vocabulary of more than 2^21 - 2
    entries."""
    monkeypatch.setattr(tables, "build_hashmatch", _wide_build(22))
    monkeypatch.setattr(port, "build_hashmatch", _wide_build(22))


@pytest.fixture
def s22(monkeypatch, fields22):
    """The port's limits lowered: a vocabulary of ``n_tokens`` entries
    takes the wide word at S = 22, and a placement of 22-bit index fields,
    as one of more than 2^21 entries does."""
    def lower(n_tokens: int):
        monkeypatch.setattr(tables, "MAX_ENTRIES", n_tokens)
        monkeypatch.setattr(tables, "W3_SHIFT_WIDE", 22)
    return lower


def _raw_text(size: int, seed: int, misses: bool = True) -> bytes:
    """Raw English and code, seeded, with a few control bytes no test
    vocabulary has where ``misses``."""
    rng = np.random.default_rng(seed)
    words = ENGLISH.split(b" ")
    parts = [words[i] for i in rng.integers(0, len(words), size // 4)]
    for at in rng.integers(0, len(parts), 4 if misses else 0):
        parts[at] += b"\x01\x02"
    return b" ".join(parts)[:size]


@pytest.mark.parametrize("which", ["realtext-1024", "realtext-32000",
                                   "unk"])
def test_slice_at_s22_equals_jax_and_native(which, s22, tmp_path):
    """The slice on the CPU at S = 22 and 22-bit index fields: one text
    through ``GpuTokenizer`` and through ``load(..., route="device")``, no
    host fallback, ids equal to the JAX package's decision engine and to
    native (with unk literals at 3 << 22 for the unk vocabulary, whose
    text has bytes it lacks)."""
    if which == "unk":
        path = str(tmp_path / "unk.vocab")
        VOCABS["unk"]().save(path)
    else:
        path = os.path.join(EXAMPLES, f"{which}-fast.vocab")
    v = tokenmonster_tpu_torch.load(path, device="cpu", route="device")
    s22(len(v._core.tokens))
    text = _raw_text(16000, seed=3, misses=which == "unk")
    ids = v.tokenize(text).astype(np.int64)
    tk = v._tpu
    assert tk.tables.w3_shift == 22 and tk.tables.idx1_bits == 22
    assert tk.host_fallbacks == 0 and tk.last_mode in ("fast", "full")
    assert v.route_counts == {"device": 1, "native": 0}
    normalized = v._core.normalize(text)
    gtk = GpuTokenizer(v._core, device="cpu")
    assert gtk.tables.w3_shift == 22 and gtk.tables.idx1_bits == 22
    g_ids, g_missing = gtk.tokenize(normalized)
    core = tokenmonster_tpu.load(path)._core
    jax_ids = TpuTokenizer(core, engine="decision").tokenize(normalized)[0]
    native, n_missing = NativeVocab(v._core).tokenize(normalized)
    np.testing.assert_array_equal(ids, jax_ids.astype(np.int64))
    np.testing.assert_array_equal(ids, native.astype(np.int64))
    np.testing.assert_array_equal(g_ids, native)
    assert g_missing == n_missing and gtk.host_fallbacks == 0
    if which == "unk":
        assert n_missing and (ids == v._core.unk_token).any()


def _scorer(v, cls, **kw):
    sc = cls(v.charset, v.using_capcode, v.normalizer.flag, **kw)
    sc.set_specials([])
    return sc


@pytest.mark.parametrize("name", ["capcode", "plain"])
def test_scorer_on_22_bit_fields_equals_jax_pallas_and_native(name,
                                                              fields22):
    """A superset whose placement has 22-bit index fields arms in REMAP
    mode; its candidates keep S = 20; every candidate's scores, token count
    and missing set equal the JAX Pallas scorer's and native's."""
    v = VOCABS[name]()
    tokens = list(v.tokens)
    jsc = _scorer(v, ref.CandidateScorer, backend="tpu")
    assert jsc.prepare_pallas(tokens)
    sc = _scorer(v, port.GpuCandidateScorer, device="cpu")
    sc.prepare(tokens)
    base = sc._sup.tokenizer.tables
    assert base.match_only and base.idx1_bits == 22
    strips = [text_for(name, v, size, seed=size) for size in (1500, 3001)]
    for drops in drop_sets(v, 11):
        cand = candidate(sc, tokens, drops, False)
        s, n_tok, miss = sc.score(cand, strips)
        js, jt, jm = jsc.score(cand, strips)
        ns, nt, nm = native_score(cand, strips)
        np.testing.assert_array_equal(s, np.asarray(js))
        np.testing.assert_array_equal(s, ns)
        assert n_tok == jt == nt and miss == jm == nm
    assert jsc.tpu_compiles == 1
    tabs = candidate_runtime_state(sc._sup, cand)
    assert tabs.w3_shift == 20


SEED_TEXT = (b"The quick brown fox jumps over the lazy dog. The dog sleeps "
             b"while the fox runs through the forest; every morning the sun "
             b"rises over the mountains and the birds sing their songs. ")
LOGGERS = ("tokenmonster_tpu.trainvocab", "tokenmonster_tpu_torch.trainvocab")


def test_train_vocab_on_22_bit_fields_equals_native(fields22, tmp_path,
                                                    caplog, monkeypatch):
    """A seeded run of ``train_vocab(backend="cuda", device="cpu")`` to its
    end, its superset placement with 22-bit index fields, equals the JAX
    loop's ``backend="native"``: the round log and the files written."""
    corpus = SEED_TEXT * 40
    counter, char_table, header = get_all_tokens(
        corpus, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=10, min_occur_singles=1, chunk_size=1 << 20,
        micro_chunks=1, add_extra_tokens=False)
    tok = str(tmp_path / "all.tok")
    save_tokens_file(tok, counter, char_table, header)
    armed = []

    class Recording(port.GpuCandidateScorer):
        def prepare(self, *args, **kw):
            super().prepare(*args, **kw)
            armed.append(self._sup.tokenizer.tables.idx1_bits)

    monkeypatch.setattr(port, "GpuCandidateScorer", Recording)
    runs = {}
    for backend in ("native", "cuda"):
        caplog.clear()
        kw = dict(vocab_size=120, workers=2, fast=True, seed=7,
                  keep_trying=5, backend=backend)
        out = str(tmp_path / backend)
        with caplog.at_level(logging.INFO, logger=LOGGERS[0]), \
                caplog.at_level(logging.INFO, logger=LOGGERS[1]):
            if backend == "native":
                ref.train_vocab(corpus, tok, out, ref.TrainConfig(**kw))
            else:
                port.train_vocab(corpus, tok, out, port.TrainConfig(**kw),
                                 device="cpu")
        runs[backend] = [r.getMessage() for r in caplog.records
                         if r.getMessage().startswith("round ")]
    assert armed == [22]
    assert runs["cuda"] == runs["native"] and len(runs["native"]) > 5
    assert "deleted 0;" not in runs["native"][0]
    names = sorted(os.listdir(tmp_path / "native"))
    assert names == sorted(os.listdir(tmp_path / "cuda")) and names
    for n in names:
        assert ((tmp_path / "native" / n).read_bytes()
                == (tmp_path / "cuda" / n).read_bytes()), n
