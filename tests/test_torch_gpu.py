"""The CUDA kernels on a card, against their plain PyTorch versions on the
same card and inputs, at the main path's shapes (chunk 2048, 512 lanes)
and at the trainer's (a candidate's masked superset tables): bit for bit
(tolerance 0; every output is an integer word).  Marked gpu; each test
skips when torch sees no CUDA card.  Imports no jax: the machine with the
card has none.

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import ctypes
import os
from contextlib import nullcontext
from unittest import mock

import numpy as np
import pytest
import torch

from tokenmonster_tpu_torch import load, tracing
from tokenmonster_tpu_torch.corpus import (main_dispatch, one_row_vocab,
                                           stdlib_text)
from tokenmonster_tpu_torch.core.vocab import Vocab
from tokenmonster_tpu_torch.native import NativeVocab
from tokenmonster_tpu_torch.ops import _build, stitch, tables
from tokenmonster_tpu_torch.ops import hashmatch as phm
from tokenmonster_tpu_torch.ops.decide import decide, decide_plain
from tokenmonster_tpu_torch.ops.follow import follow, follow_plain
from tokenmonster_tpu_torch.ops.follow import window as follow_window
from tokenmonster_tpu_torch.ops.match import match, match_args, match_plain
from tokenmonster_tpu_torch.ops.scan import (MARGIN, OVERLAP_SCAN, GpuTokenizer,
                                            remap_matches)
from tokenmonster_tpu_torch.train.score_helpers import candidate_runtime_state
from tokenmonster_tpu_torch.train.trainvocab import GpuCandidateScorer

from torch_cases import (LONG_KEYS, ZERO_STEP_TEXT, ZERO_STEP_TOKENS,
                         edge_text, edge_vocab, native_score,
                         offset_placement, wide_matches, wide_tables,
                         wide_words, zero_step_vocab)

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK, LANES = 2048, 512


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _real32k():
    return Vocab.load(os.path.join(ROOT, "examples",
                                   "realtext-32000-fast.vocab"))


@pytest.fixture(scope="module", params=["two_rows", "one_row"])
def dispatch(request, cuda):
    """One main-path dispatch of real text: tokenizer, staged buffer, n."""
    v = _real32k()
    if request.param == "one_row":
        v = one_row_vocab(v)
    raw, _dropped = stdlib_text(v, LANES * CHUNK)
    return main_dispatch(v, raw, cuda, CHUNK, LANES)


def _equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b), int((a != b).sum())


def test_match_kernel_equals_plain(dispatch):
    tk, buf, n = dispatch
    got = match(buf, n, tk.tables)
    want = match_plain(buf, n, tk.tables)
    torch.cuda.synchronize()
    for g, w in zip(*((got, want) if tk.tables.has_space
                      else ((got,), (want,)))):
        _equal(g, w)


def _match_tile():
    """(positions per warp tile, positions per block and round) of the
    match kernel, as the library reports them."""
    block = ctypes.c_int(0)
    tile = _build.load_library().tm_match_tile(ctypes.byref(block))
    return tile, block.value


@pytest.mark.parametrize("capcode", [0, 1])
def test_match_kernel_edges_equal_plain(cuda, capcode):
    """Overflow keys, 40-byte keys and their near misses; 40-byte keys
    across every third warp-tile boundary and every block boundary of the
    kernel, each starting 17 positions before it; a buffer whose last
    tile is partial and whose pointer is not word-aligned (the kernel's
    byte loads)."""
    tile, block = _match_tile()
    assert block % tile == 0 and tile > len(LONG_KEYS[0])
    v = edge_vocab(capcode)
    tk = GpuTokenizer(v, device=cuda)
    data = bytearray(edge_text(3 * block + 1000, seed=2 + capcode))
    n = len(data) - 50
    edges = sorted(set(range(tile, n - 40, 3 * tile))
                   | set(range(block, n - 40, block)))
    at = np.array(edges) - 17
    for a in at:
        data[a:a + 40] = LONG_KEYS[0]
    for offset in (0, 1):
        host = torch.zeros(len(data) + offset, dtype=torch.uint8)
        host[offset:] = torch.tensor(list(data), dtype=torch.uint8)
        buf = host.to(cuda)[offset:]
        assert buf.data_ptr() % 4 == offset
        got = match(buf, n, tk.tables)
        want = match_plain(buf, n, tk.tables)
        torch.cuda.synchronize()
        for g, w in zip(*((got, want) if tk.tables.has_space
                          else ((got,), (want,)))):
            _equal(g, w)
        m = (want[0] if tk.tables.has_space else want).cpu().numpy()
        assert ((m[at] & 63) == 40).all()


@pytest.mark.parametrize("capcode", [0, 1])
def test_match_kernel_with_many_lengths_per_position(cuda, capcode):
    """Runs of one byte under tokens of every run length 1..40 (and their
    space-prefixed forms): every position has dozens of lengths to probe,
    more than a warp's shared probe list holds, so lanes also probe their
    own after it."""
    toks = [b"x" * k for k in range(1, 41)] + [b" " + b"x" * k
                                              for k in range(1, 40)]
    v = Vocab()
    v._generate(tokens=toks + [b" ", b"y"] + ([b"\x7f"] if capcode else []),
                charset=1, normalize_string="none", using_capcode=capcode,
                level=5, reset_token_ids=True)
    tk = GpuTokenizer(v, device=cuda)
    rng = np.random.default_rng(capcode)
    data = b"".join(b"x" * int(k) + b" y"[:int(rng.integers(1, 3))]
                    for k in rng.integers(30, 200, 400))
    buf = torch.tensor(list(data), dtype=torch.uint8, device=cuda)
    got = match(buf, len(data), tk.tables)
    want = match_plain(buf, len(data), tk.tables)
    torch.cuda.synchronize()
    for g, w in zip(*((got, want) if tk.tables.has_space
                      else ((got,), (want,)))):
        _equal(g, w)
    m = want[0] if tk.tables.has_space else want
    assert ((m & 63) == 40).sum() > 1000


def test_match_kernel_with_displacements_in_global_memory(cuda):
    """A vocabulary whose displacement planes do not fit in shared memory
    beside the filter: the kernel reads them from global memory."""
    rng = np.random.default_rng(5)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    toks = {bytes(letters[rng.integers(0, 26, int(k))])
            for k in rng.integers(5, 15, 400_000)}
    v = Vocab()
    v._generate(tokens=sorted(toks) + [bytes([b]) for b in letters],
                charset=1, normalize_string="none", using_capcode=0, level=5,
                reset_token_ids=True)
    tk = GpuTokenizer(v, device=cuda)
    data = bytes(letters[rng.integers(0, 26, 200_000)])
    buf = torch.tensor(list(data), dtype=torch.uint8, device=cuda)
    m_out = torch.empty(len(data), dtype=torch.int32, device=cuda)
    args = match_args(buf, len(data), tk.tables, m_out, m_out)
    disp_smem = ctypes.c_int(-1)
    assert _build.load_library().tm_match_smem(ctypes.byref(args),
                                               ctypes.byref(disp_smem)) > 0
    assert disp_smem.value == 0, tk.tables.disp.numel()
    got = match(buf, len(data), tk.tables)
    _equal(got, match_plain(buf, len(data), tk.tables))


@pytest.mark.parametrize("lanes,chunk", [(1, 70_000), (6, 30_000)])
def test_follow_kernel_walks_windows_longer_than_its_tile(cuda, lanes,
                                                          chunk):
    """Lanes whose windows exceed the shared-memory tile (one lane of a
    long span, as GpuTokenizer.chain runs a repair; six lanes, so two
    blocks, one partly filled), on two fd rows, with the full record
    window: refilled tile by tile, equal to the plain version."""
    v = _real32k()
    raw, _dropped = stdlib_text(v, lanes * chunk + 4096)
    data = v.normalize(raw)[:lanes * chunk + 2048]
    tk = GpuTokenizer(v, device=cuda)
    buf = torch.zeros(lanes * chunk + 4096, dtype=torch.uint8, device=cuda)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8,
                                   device=cuda)
    n = len(data)
    m, mb = match(buf, n, tk.tables)
    ctl, tok = decide(m, mb, buf, n, tk.tables)
    t_rec = tk._t_rec(True, chunk)
    args = _build.FollowArgs(N=buf.numel(), rows=2, n=n, chunk=chunk,
                             overlap=OVERLAP_SCAN,
                             W=follow_window(chunk, OVERLAP_SCAN), L=lanes,
                             t_rec=t_rec)
    tile = _build.load_library().tm_follow_tile(ctypes.byref(args))
    assert 0 < tile < args.W
    got = follow(ctl, tok, n, chunk, lanes, OVERLAP_SCAN, t_rec)
    want = follow_plain(ctl, tok, n, chunk, lanes, OVERLAP_SCAN, t_rec)
    for g, w in zip(got, want):
        _equal(g, w)
    assert int(got[2]) == 1
    n_rec = int(((got[0][:, 0] & 0xF) != 0).sum())
    assert n_rec > tile // 8


def _decisions(tk, buf, n):
    mm = match(buf, n, tk.tables)
    m, mb = mm if tk.tables.has_space else (mm, None)
    return m, mb


def test_decide_kernel_equals_plain(dispatch):
    tk, buf, n = dispatch
    m, mb = _decisions(tk, buf, n)
    got = decide(m, mb, buf, n, tk.tables)
    want = decide_plain(m, mb, buf, n, tk.tables)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _equal(g, w)


def _decide_tile():
    smem = ctypes.c_int(0)
    return _build.load_library().tm_decide_tile(ctypes.byref(smem))


@pytest.mark.parametrize("cut", [1, 130, 777])
def test_decide_kernel_at_the_end_of_the_buffer(dispatch, cut):
    """A buffer that ends where the text ends, its length no multiple of
    the kernel's tile: the last block is partly filled and its lookahead
    lies past N, read as zeros; one launch counted per call."""
    tk, buf, n = dispatch
    tile = _decide_tile()
    N = (n - cut) // tile * tile - cut
    assert N % tile and N > 100 * tile
    short = buf[:N].clone()
    m, mb = _decisions(tk, short, N)
    before = _build.launches["decide"]
    got = decide(m, mb, short, N, tk.tables)
    assert _build.launches["decide"] == before + 1
    want = decide_plain(m, mb, short, N, tk.tables)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _equal(g, w)


def _dirty(n_words, device):
    """Leave nonzero words where the allocator will place the next tensor
    of this size, so a kernel that skips a word of its output shows."""
    torch.cuda.synchronize()
    t = torch.full((n_words,), 0x5A5A5A5A, dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    del t


def _compact_both(recs, toks, s, e, q, out_len, w3_shift=tables.W3_SHIFT):
    _dirty(out_len, recs.device)
    before = _build.launches["compact"]
    got = stitch.compact(recs, toks, s, e, q, out_len, w3_shift)
    assert _build.launches["compact"] == before + 1
    want = stitch.compact_plain(recs, toks, s, e, q, out_len, w3_shift)
    torch.cuda.synchronize()
    _equal(got, want)
    return want


@pytest.mark.parametrize("L", [1, 5, 512])
def test_compact_kernel_writes_every_word(cuda, L):
    """Seeded record grids of L lanes with gaps between the lanes' slots,
    empty lanes, ranges ending at T - 1, slots before 0 and past out_len:
    the whole output equals the plain version's, the zeros the kernel
    writes included, in an output buffer that held other words."""
    T, out_len = 1024, 700 * L + 77
    rng = np.random.default_rng(L)
    recs = torch.tensor(rng.integers(1, 1 << 20, (T, L)), dtype=torch.int32,
                        device=cuda)
    toks = torch.tensor(rng.integers(1, 1 << 22, (T, L)), dtype=torch.int32,
                        device=cuda)
    s = rng.integers(-3, 300, L)
    e = s + rng.integers(0, 400, L)
    s[::4] = rng.integers(600, T, len(s[::4]))
    e[::4] = T - 1
    e[2::5] = s[2::5] - 1
    span = np.maximum(e.clip(max=T - 1) - s.clip(min=0) + 1, 0)
    q = np.cumsum(span + 3) - span - s.clip(min=0)
    q[0] = -s[0].clip(min=0) - 2
    if L > 1:
        q[-1] = out_len - 4 - s[-1].clip(min=0)
    assert (np.cumsum(span + 3))[-1] < out_len - 4 or L == 1
    s, e, q = (torch.tensor(v, dtype=torch.int32, device=cuda)
               for v in (s, e, q))
    want = _compact_both(recs, toks, s, e, q, out_len)
    assert (want != 0).any() and (want == 0).any()


def test_compact_kernel_on_one_long_lane(cuda):
    """The grid of a bridge or repair lane: one lane of a long span with
    the full record window, thousands of record tiles for one column."""
    v = _real32k()
    chunk = 70_000
    raw, _dropped = stdlib_text(v, chunk + 4096)
    data = v.normalize(raw)[:chunk]
    tk = GpuTokenizer(v, device=cuda)
    buf = torch.zeros(chunk + 4096, dtype=torch.uint8, device=cuda)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8,
                                   device=cuda)
    n = len(data)
    m, mb = match(buf, n, tk.tables)
    ctl, tok = decide(m, mb, buf, n, tk.tables)
    t_rec = tk._t_rec(True, chunk)
    recs, toks, done = follow(ctl, tok, n, chunk, 1, OVERLAP_SCAN, t_rec)
    assert int(done) == 1
    _f, keep, _sn, ok, s, e = stitch.stitched_keep(recs, 0, 0, True)
    assert bool(ok)
    counts = keep.sum(0)
    q = (counts.cumsum(0) - counts - s).to(torch.int32)
    s, e = s.to(torch.int32), e.clamp(max=t_rec - 1).to(torch.int32)
    want = _compact_both(recs, toks, s, e, q, t_rec)
    assert int((want != 0).sum()) > 10_000


@pytest.mark.parametrize("full", [False, True])
def test_follow_and_compact_kernels_equal_plain(dispatch, full):
    tk, buf, n = dispatch
    m, mb = _decisions(tk, buf, n)
    ctl, tok = decide(m, mb, buf, n, tk.tables)
    t_rec = tk._t_rec(full)
    got = follow(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec)
    want = follow_plain(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec)
    for g, w in zip(got, want):
        _equal(g, w)
    assert int(got[2]) == 1
    recs, toks, _done = got
    _f, keep, _sn, ok, s, e = stitch.stitched_keep(recs, 0, LANES - 2,
                                                   False)
    assert bool(ok)
    counts = keep.sum(0)
    q = (counts.cumsum(0) - counts - s).to(torch.int32)
    s, e = s.to(torch.int32), e.clamp(max=t_rec - 1).to(torch.int32)
    _compact_both(recs, toks, s, e, q, t_rec * LANES)


def test_wide_words_on_card_equal_plain(dispatch):
    """The wide token word (S = 21) of a vocabulary of more than 2^20
    entries: decide on tables whose indices are all moved past 2^20
    (``torch_cases.wide_tables``), then follow and compact at S = 21,
    each kernel equal to its plain version at the main path's shapes."""
    tk, buf, n = dispatch
    m, mb = (wide_matches(w) for w in _decisions(tk, buf, n))
    wide = wide_tables(tk.tables)
    got = decide(m, mb, buf, n, wide)
    want = decide_plain(m, mb, buf, n, wide)
    for g, w in zip(got, want):
        _equal(g, w)
    ctl, tok = got
    assert ((tok.long() & 0x1FFFFF) >= 1 << 20).any()
    t_rec = tk._t_rec(False)
    got = follow(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec, 21)
    want = follow_plain(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec, 21)
    for g, w in zip(got, want):
        _equal(g, w)
    recs, toks, _done = got
    _f, keep, _sn, ok, s, e = stitch.stitched_keep(recs, 0, LANES - 2,
                                                   False)
    assert bool(ok)
    counts = keep.sum(0)
    q = (counts.cumsum(0) - counts - s).to(torch.int32)
    s, e = s.to(torch.int32), e.clamp(max=t_rec - 1).to(torch.int32)
    _compact_both(recs, toks, s, e, q, t_rec * LANES, 21)


@pytest.mark.parametrize("S", [22, 23, 24])
def test_wider_words_on_card_equal_plain(dispatch, S):
    """Token words at S = 22, 23 and 24, every index moved up (by 2^21,
    2^22, and to a largest index of 2^24 - 3): decide on tables moved up
    as far (``torch_cases.wide_tables``), follow on the u64 tile word, and
    compact with its delete marker at bit S + 2, each kernel equal to its
    plain version at the main path's shapes."""
    tk, buf, n = dispatch
    n_ent = tk.tables.meta.shape[1]
    off = (1 << 24) - n_ent - 2 if S == 24 else 1 << (S - 1)
    m, mb = (wide_matches(w, off) for w in _decisions(tk, buf, n))
    wide = wide_tables(tk.tables, off, S)
    got = decide(m, mb, buf, n, wide)
    want = decide_plain(m, mb, buf, n, wide)
    for g, w in zip(got, want):
        _equal(g, w)
    ctl, tok = got
    assert ((tok.long() & ((1 << S) - 1)) >= 1 << (S - 1)).any()
    t_rec = tk._t_rec(False)
    got = follow(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec, S)
    want = follow_plain(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec, S)
    for g, w in zip(got, want):
        _equal(g, w)
    recs, toks, _done = got
    _f, keep, _sn, ok, s, e = stitch.stitched_keep(recs, 0, LANES - 2,
                                                   False)
    assert bool(ok)
    counts = keep.sum(0)
    q = (counts.cumsum(0) - counts - s).to(torch.int32)
    s, e = s.to(torch.int32), e.clamp(max=t_rec - 1).to(torch.int32)
    _compact_both(recs, toks, s, e, q, t_rec * LANES, S)


@pytest.mark.parametrize("lanes,chunk", [(1, 70_000), (512, 2048)])
def test_follow_kernel_u64_tiles_equal_plain(dispatch, lanes, chunk):
    """The u64 tile word (S = 24) on windows longer than its tile and on
    the main path's lanes: the same records as the u32 word at S = 20."""
    tk, buf, n = dispatch
    m, mb = _decisions(tk, buf, n)
    ctl, tok = decide(m, mb, buf, n, tk.tables)
    wide = wide_words(ctl, tok, 1 << 23, 24)
    t_rec = tk._t_rec(True, chunk)
    args = _build.FollowArgs(N=buf.numel(), rows=1 if ctl.dim() == 1
                             else ctl.shape[0], n=n, chunk=chunk,
                             overlap=OVERLAP_SCAN,
                             W=follow_window(chunk, OVERLAP_SCAN), L=lanes,
                             t_rec=t_rec, w3_shift=24)
    tile = _build.load_library().tm_follow_tile(ctypes.byref(args))
    assert 0 < tile and (tile < args.W) == (lanes == 1)
    got = follow(ctl, wide, n, chunk, lanes, OVERLAP_SCAN, t_rec, 24)
    want = follow_plain(ctl, wide, n, chunk, lanes, OVERLAP_SCAN, t_rec, 24)
    for g, w in zip(got, want):
        _equal(g, w)
    narrow = follow(ctl, tok, n, chunk, lanes, OVERLAP_SCAN, t_rec)
    _equal(got[0], narrow[0])


@pytest.mark.parametrize("bits,top", [(22, (1 << 21) - 1), (24, 1 << 22),
                                      (24, (1 << 24) - 3)])
def test_match_kernel_at_wide_fields_equals_plain(dispatch, bits, top):
    """Placements of 22 and 24 index bits with every index moved up
    (``torch_cases.offset_placement``), indices up to 2^24 - 3 through the
    warp's shared hit list (length << 24 | index): M and Mb equal the
    plain version's."""
    tk, buf, n = dispatch
    v = tk.vocab
    off = top - (len(v.tokens) - 1)
    dt = tables.DeviceTables(v, offset_placement(
        phm, v.tokens, off, bits, tables.space_prefix(v)),
        match_only=True).to(buf.device)
    got = match(buf, n, dt)
    want = match_plain(buf, n, dt)
    torch.cuda.synchronize()
    got, want = (got, want) if dt.has_space else ((got,), (want,))
    for g, w in zip(got, want):
        _equal(g, w)
    idx = (want[0].long() & 0xFFFFFFFF) >> 6
    assert idx[want[0] != 0].min() >= off


@pytest.mark.parametrize("S", [22, 24])
def test_wider_tokenizer_on_card_equals_native(cuda, monkeypatch, S):
    """A vocabulary with its limits lowered so that it takes S = 22 (24)
    and a placement of 22-bit (24-bit) index fields tokenizes on the card
    a multi-dispatch text equal to native, every kernel launched, no host
    fallback."""
    v = _real32k()
    monkeypatch.setattr(tables, "MAX_ENTRIES", len(v.tokens))
    monkeypatch.setattr(tables, "W3_SHIFT_WIDE", S)
    monkeypatch.setattr(tables, "build_hashmatch", lambda keys, space_prefix:
                        offset_placement(phm, keys, 0, S, space_prefix))
    raw, _dropped = stdlib_text(v, 3 << 20)
    data = v.normalize(raw)
    tk = GpuTokenizer(v, device=cuda)
    assert tk.tables.w3_shift == S and tk.tables.idx1_bits == S
    _build.reset_launches()
    ids, missing = tk.tokenize(data)
    want, wmiss = NativeVocab(v).tokenize(data)
    np.testing.assert_array_equal(ids, want)
    assert missing == wmiss == 0 and tk.host_fallbacks == 0
    assert all(c > 0 for c in tk.launches.values()), tk.launches


def test_wide_tokenizer_on_card_equals_native(cuda, monkeypatch):
    """A vocabulary at the (lowered) limit tokenizes on the card at S =
    21, a multi-dispatch text equal to native, every kernel launched, no
    host fallback."""
    v = _real32k()
    monkeypatch.setattr(tables, "MAX_ENTRIES", len(v.tokens))
    raw, _dropped = stdlib_text(v, 3 << 20)
    data = v.normalize(raw)
    tk = GpuTokenizer(v, device=cuda)
    assert tk.tables.w3_shift == 21
    _build.reset_launches()
    ids, missing = tk.tokenize(data)
    want, wmiss = NativeVocab(v).tokenize(data)
    np.testing.assert_array_equal(ids, want)
    assert missing == wmiss == 0 and tk.host_fallbacks == 0
    assert all(c > 0 for c in tk.launches.values()), tk.launches


def test_tokenizer_on_card_equals_native(cuda):
    """A multi-dispatch text through the kernels equals the native
    tokenizer, with every kernel launched and no host fallback."""
    v = _real32k()
    raw, _dropped = stdlib_text(v, 3 << 20)
    data = v.normalize(raw)
    tk = GpuTokenizer(v, device=cuda)
    assert len(tk._plan(len(data))[1]) >= 3
    _build.reset_launches()
    ids, missing = tk.tokenize(data)
    want, wmiss = NativeVocab(v).tokenize(data)
    np.testing.assert_array_equal(ids, want)
    assert missing == wmiss == 0
    assert tk.fallbacks == {"missing_byte": 0}
    assert all(c > 0 for c in tk.launches.values()), tk.launches


def test_wrappers_validate_arguments(dispatch):
    tk, buf, n = dispatch
    with pytest.raises(TypeError):
        match(buf.to(torch.int32), n, tk.tables)
    with pytest.raises(ValueError):
        match(buf, buf.numel() + 1, tk.tables)
    with pytest.raises(ValueError):
        match(buf[::2], n // 2, tk.tables)


@pytest.fixture(scope="module")
def trainer(cuda):
    """A scorer armed on realtext-32000's entries as the superset, and a
    candidate of its singles and about three quarters of the rest."""
    v = _real32k()
    sc = GpuCandidateScorer(v.charset, v.using_capcode, v.normalizer.flag,
                            device=cuda)
    sc.set_specials([])
    tokens = [bytes(t) for t in v.tokens]
    sc.prepare(tokens)
    rng = np.random.default_rng(3)
    cand = sc.build([t for t in tokens if len(t) == 1 or rng.random() < 0.75])
    raw, _dropped = stdlib_text(None, 3 << 20)
    data = bytearray(v.normalize(raw))
    data[1000::100003] = b"\x01" * len(data[1000::100003])  # lacked byte
    return sc, cand, bytes(data)


def test_kernels_on_masked_tables_equal_plain(trainer):
    """One 512-lane dispatch of text with bytes the candidate lacks."""
    sc, cand, data = trainer
    tk = sc._sup.tokenizer
    staged = tk.stage(data[:(LANES - 1) * CHUNK + MARGIN])
    lanes, bufs = staged.lanes, staged.bufs
    assert lanes == LANES
    buf, n, _last = bufs[0]
    tabs = candidate_runtime_state(sc._sup, cand)
    m, mb = match(buf, n, tabs)
    for g, w in zip((m, mb), match_plain(buf, n, tabs)):
        _equal(g, w)
    m, mb = remap_matches(m, tabs.rank), remap_matches(mb, tabs.rank)
    ctl, tok = decide(m, mb, buf, n, tabs)
    for g, w in zip((ctl, tok), decide_plain(m, mb, buf, n, tabs)):
        _equal(g, w)
    assert ((ctl[0] & (1 << 9)) != 0).any(), "no missing byte"
    t_rec = tk._t_rec(False)
    got = follow(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec)
    want = follow_plain(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _equal(g, w)


def test_scorer_on_card_equals_native(trainer):
    """Strips of a few kB to two dispatches: scores, token count and
    missing set equal the native scorer's, through every path kernel."""
    sc, cand, data = trainer
    strips = [data[:5000], data[5000:70000],
              data[70000:70000 + 2 * (LANES - 1) * CHUNK - 4096]]
    assert len(sc._sup.tokenizer._plan(len(strips[2]))[1]) == 2
    _build.reset_launches()
    got = sc.score(cand, strips)
    launches = dict(_build.launches)
    want = native_score(cand, strips)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2]
    assert sc.repairs == 0
    assert all(launches[k] >= 4 for k in ("match", "decide", "follow"))


def test_zero_advance_step_on_card(cuda):
    """The fd-1 step that advances 0 bytes: the decide kernel equals its
    plain version, and the scorer on the card equals native."""
    sc = GpuCandidateScorer(1, 2, zero_step_vocab().normalizer.flag,
                            device=cuda)
    sc.set_specials([])
    sc.prepare(ZERO_STEP_TOKENS)
    cand = sc.build(ZERO_STEP_TOKENS)
    tk = sc._sup.tokenizer
    bufs = tk.stage(ZERO_STEP_TEXT).bufs
    buf, n, _last = bufs[0]
    tabs = candidate_runtime_state(sc._sup, cand)
    m, mb = match(buf, n, tabs)
    m, mb = remap_matches(m, tabs.rank), remap_matches(mb, tabs.rank)
    ctl, tok = decide(m, mb, buf, n, tabs)
    for g, w in zip((ctl, tok), decide_plain(m, mb, buf, n, tabs)):
        _equal(g, w)
    assert ((ctl[1, :n] & 63) == 0).any()
    got = sc.score(cand, [ZERO_STEP_TEXT])
    want = native_score(cand, [ZERO_STEP_TEXT])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_junction_repairs_on_card(cuda):
    """A run of "a" after an "x" (tokens "aa", "a", "x"; capcode 2, two fd
    rows) through two dispatches fails every junction, the bridge lane's
    too: repaired on the card, equal to native, in a few dozen repairs."""
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                normalize_string="none", using_capcode=2, level=5,
                reset_token_ids=True)
    sc = GpuCandidateScorer(1, 2, v.normalizer.flag, device=cuda)
    sc.set_specials([])
    sc.prepare(list(v.tokens))
    cand = sc.build(list(v.tokens))
    strips = [b"x" + b"a" * ((LANES - 1) * CHUNK + 70000) + b"xaaxa" * 20,
              b"x" + b"a" * 3000]
    assert len(sc._sup.tokenizer._plan(len(strips[0]))[1]) == 2
    got = sc.score(cand, strips)
    want = native_score(cand, strips)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert 2 <= sc.repairs <= 30


def test_tokenizer_junction_repairs_on_card(cuda):
    """The tokenizer's junction repair on the card: a run of "a" after an
    "x" (tokens "aa", "a", "x"; capcode 2) through two dispatches fails
    every junction; repaired, the ids equal native's, no host fallback."""
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                normalize_string="none", using_capcode=2, level=5,
                reset_token_ids=True)
    tk = GpuTokenizer(v, device=cuda)
    data = b"x" + b"a" * ((LANES - 1) * CHUNK + 70000) + b"xaaxa" * 20
    assert len(tk._plan(len(data))[1]) == 2
    _build.reset_launches()
    ids, missing = tk.tokenize(data)
    want, wmiss = NativeVocab(v).tokenize(data)
    np.testing.assert_array_equal(ids, want)
    assert missing == wmiss and tk.host_fallbacks == 0
    assert 2 <= tk.repairs <= 30
    assert all(c > 0 for c in tk.launches.values()), tk.launches


@pytest.mark.parametrize("how", ["below_limit", "at_limit", "fields24"])
def test_remap_scorer_on_card_equals_native(trainer, monkeypatch, how):
    """REMAP mode on the card, on a superset below the entry limit, at it
    (the limit lowered to its size) and with a placement of 24-bit index
    fields: the superset's match tables, each candidate's match words
    mapped to its indices, decide and follow on candidate-sized tables
    equal their plain versions; scores equal native's and those of a
    scorer armed on its own placement."""
    sc0, cand, data = trainer
    sup0 = sc0._sup
    if how == "at_limit":
        monkeypatch.setattr(tables, "MAX_ENTRIES", len(sup0.vocab.tokens))
    placement = sup0.hashmatch
    if how == "fields24":
        placement = offset_placement(phm, sup0.vocab.tokens, 0, 24,
                                     tables.space_prefix(sup0.vocab))
    sc = GpuCandidateScorer(sup0.vocab.charset, sup0.vocab.using_capcode,
                            sup0.vocab.normalizer.flag, device=sc0.device)
    sc.set_specials([])
    sc.prepare([bytes(t) for t in sup0.vocab.tokens],
               hashmatch_tables=placement)
    assert sc._sup.tokenizer.tables.match_only
    assert sc._sup.tokenizer.tables.idx1_bits == (24 if how == "fields24"
                                                  else 16)
    tk = sc._sup.tokenizer
    bufs = tk.stage(data[:(LANES - 1) * CHUNK + MARGIN]).bufs
    buf, n, _last = bufs[0]
    tabs = candidate_runtime_state(sc._sup, cand)
    assert tabs.meta.shape[1] == tables.bucket_width(len(cand.tokens))
    m, mb = match(buf, n, tabs)
    for g, w in zip((m, mb), match_plain(buf, n, tabs)):
        _equal(g, w)
    m, mb = remap_matches(m, tabs.rank), remap_matches(mb, tabs.rank)
    ctl, tok = decide(m, mb, buf, n, tabs)
    for g, w in zip((ctl, tok), decide_plain(m, mb, buf, n, tabs)):
        _equal(g, w)
    t_rec = tk._t_rec(False)
    got = follow(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec)
    want = follow_plain(ctl, tok, n, CHUNK, LANES, OVERLAP_SCAN, t_rec)
    for g, w in zip(got, want):
        _equal(g, w)
    strips = [data[:5000], data[5000:70000 + (LANES - 1) * CHUNK]]
    got = sc.score(cand, strips)
    want = native_score(cand, strips)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2]
    other = sc0.score(cand, strips)
    np.testing.assert_array_equal(got[0], other[0])


@pytest.mark.parametrize("shift", [20, 21])
def test_own_tables_scorer_on_card(trainer, monkeypatch, shift):
    """Candidates on their own tables on the card: the trainer's candidate
    scored by a scorer never prepared, and the same candidate with an unk
    token by the prepared scorer, whose superset has none.  Scores, token
    count and missing set equal the same scorer's plain versions on the
    CPU and native, over strips of one dispatch and of two; with
    ``tables.MAX_ENTRIES`` lowered to the candidate's size, at token words
    of S = 21."""
    sc0, cand, data = trainer
    if shift == 21:
        monkeypatch.setattr(tables, "MAX_ENTRIES", len(cand.tokens))
    unk = sc0.build([bytes(t) for t in cand.tokens])
    assert unk.enable_unk_token()
    assert tables.w3_shift(cand) == tables.w3_shift(unk) == shift

    def scorer(device):
        sc = GpuCandidateScorer(cand.charset, cand.using_capcode,
                                cand.normalizer.flag, device=device)
        sc.set_specials([])
        return sc

    fresh, plain = scorer(sc0.device), scorer("cpu")
    own_before = sc0.own_table_scores
    short = [data[:5000], data[5000:250000]]
    long = [data[:70000 + (LANES - 1) * CHUNK]]
    assert len(sc0._sup.tokenizer._plan(len(long[0]))[1]) == 2
    _build.reset_launches()
    for sc, c in ((fresh, cand), (sc0, unk)):
        got = sc.score(c, short)
        for want in (plain.score(c, short), native_score(c, short)):
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
        assert got[2]
        got, want = sc.score(c, long), native_score(c, long)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    assert fresh.own_table_scores == 2 and fresh.repairs == 0
    assert sc0.own_table_scores == own_before + 2
    assert all(launches[k] >= 6 for k in ("match", "decide", "follow"))


def test_device_sort_on_card_equals_cpu_and_host(cuda):
    """The getalltokens window sort on the card: the same order and first
    differences as the same torch ops on the CPU (the same stable passes),
    and the host sort's run structure."""
    from tokenmonster_tpu_torch.native import native_sorted_windows
    from tokenmonster_tpu_torch.ops.device_sort import device_sorted_windows
    raw, _dropped = stdlib_text(None, 600_000)
    rng = np.random.default_rng(3)
    data = np.frombuffer(raw + bytes(rng.integers(0, 256, 5000)
                                     .astype(np.uint8)), np.uint8)
    width = 41
    n = len(data) - width - 1
    order, fd = device_sorted_windows(data, n, width, cuda)
    order_c, fd_c = device_sorted_windows(data, n, width, "cpu")
    np.testing.assert_array_equal(order, order_c)
    np.testing.assert_array_equal(fd, fd_c)
    _order_h, fd_h = native_sorted_windows(data, n, width)
    np.testing.assert_array_equal(np.minimum(fd, width),
                                  np.minimum(fd_h, width))


@pytest.mark.parametrize("case", ["whole", "split", "repair"])
def test_two_slots_on_one_card_equal_one_slot(cuda, case):
    """The scorer over two slots of one card (each its own thread and
    stream) equals one slot and native: whole strips, a strip split over
    the slots, and a split strip scored again whole."""
    import torch_multidevice_cases as cases
    one, cand, strips = cases.scoring_cases("cuda:0")[case]
    v = cases.run_vocab() if case == "repair" else None
    if v is None:
        from torch_cases import VOCABS
        v = VOCABS["capcode"]()
    two = cases.scorer(v, ["cuda:0", "cuda:0"])
    assert len(two._slots) == 2
    assert all(s.stream is not None for s in two._slots)
    with cases.split_geometry():
        got, want1 = two.score(cand, strips), one.score(cand, strips)
    want = native_score(cand, strips)
    np.testing.assert_array_equal(got[0], want1[0])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want1[1:] == want[1:]
    assert two.repairs == one.repairs


def test_two_processes_on_one_card(cuda, tmp_path):
    """Two gloo processes, both scoring on the one card: each case's
    scores equal native's in both ranks; ``train_vocab`` in both ranks
    logs native's rounds, and rank 0 writes native's files."""
    import logging

    import torch_multidevice_cases as cases
    cases.pool(str(tmp_path))
    ranks = cases.launch_ranks(tmp_path, "cuda:0", 600)
    for name, (_sc, cand, strips) in cases.scoring_cases("cpu").items():
        want = native_score(cand, strips)
        for got, _log in ranks:
            np.testing.assert_array_equal(got[name], want[0])
            assert got[name + "_meta"][0] == want[1]
    rounds = []
    logger = logging.getLogger("tokenmonster_tpu_torch.trainvocab")
    handler = logging.Handler()
    handler.emit = lambda r: rounds.append(r.getMessage())
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        cases.train(str(tmp_path / "native"), None, backend="native")
    finally:
        logger.removeHandler(handler)
    rounds = [r for r in rounds if r.startswith("round ")]
    for _got, log in ranks:
        assert log["rounds"] == rounds
    names = sorted(os.listdir(tmp_path / "native"))
    assert sorted(os.listdir(tmp_path / "results")) == names
    for name in names:
        assert ((tmp_path / "results" / name).read_bytes()
                == (tmp_path / "native" / name).read_bytes())


def _both_paths(tk, data):
    """(captured, eager) results of ``tk.tokenize_staged`` on ``data`` and
    the launches per kernel of each, the captured path's counted on a
    replay (its geometry captured before); the eager path is the same
    call with ``_run_captured`` replaced by the chain op by op."""
    staged = tk.stage(data)
    tk.tokenize_staged(staged, data)
    runs = []
    for eager in (False, True):
        _build.reset_launches()
        with mock.patch.object(tk, "_run_captured", tk._run_eager) \
                if eager else nullcontext():
            res = tk.tokenize_staged(staged, data)
        torch.cuda.synchronize()
        runs.append((res, dict(_build.launches), tk.last_mode))
    return runs


@pytest.mark.parametrize("dispatches", [1, 5, 16, 17])
def test_captured_chain_equals_eager(cuda, dispatches):
    """The captured chain (graphs of up to 16 dispatches; 17 replays the
    16-dispatch graph, then the 1-dispatch one, the record skip carried on
    the card) equals the chain enqueued op by op bit for bit and native;
    a replayed call launches each kernel as often as the eager one.
    Lanes of 256 bytes keep the text of 17 dispatches near 2 MB."""
    v = _real32k()
    tk = GpuTokenizer(v, chunk=256, device=cuda)
    raw, _dropped = stdlib_text(v, 3 << 20)
    data = v.normalize(raw)[:(dispatches - 1) * (LANES - 1) * 256 + 100_000]
    L, plan = tk._plan(len(data))
    assert len(plan) == dispatches
    (got, got_l, mode), (want, want_l, want_mode) = _both_paths(tk, data)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 0 and mode == want_mode == "fast"
    np.testing.assert_array_equal(got[0], NativeVocab(v).tokenize(data)[0])
    assert got_l == want_l and got_l["match"] >= dispatches, got_l
    keys = {(L, min(dispatches - g, 16), False)
            for g in range(0, dispatches, 16)}
    assert set(tk._graphs) == keys and tk.captures == len(keys)


def test_captured_chain_full_window_retry(cuda):
    """Dense text (a record a byte, the unk vocabulary's misses) overflows
    the captured fast window; the full-window retry runs op by op behind
    it: equal to the eager path and native."""
    v = Vocab()
    v._generate(tokens=[b"q", b"u", b"i", b"c", b"k", b"qu", b"ick"],
                charset=1, normalize_string="none", using_capcode=0, level=5,
                reset_token_ids=True)
    assert v.enable_unk_token()
    tk = GpuTokenizer(v, device=cuda)
    data = (b"q\x01u\x02i\x03c\x04k\x05" * 120_000)[:1_100_000]
    (got, got_l, mode), (want, want_l, want_mode) = _both_paths(tk, data)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] > 0 and mode == want_mode == "full"
    np.testing.assert_array_equal(got[0], NativeVocab(v).tokenize(data)[0])
    assert got_l == want_l, (got_l, want_l)


def test_captured_chain_junction_repair(cuda):
    """A junction whose lanes share no state (a run of "a" after an "x",
    tokens "aa", "a", "x") through two dispatches: the captured run does
    not hold, and the repair runs op by op from its record grids; equal
    to the eager path and native, with the same repairs and launches."""
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                normalize_string="none", using_capcode=2, level=5,
                reset_token_ids=True)
    tk = GpuTokenizer(v, device=cuda)
    data = b"x" + b"a" * ((LANES - 1) * CHUNK + 70000) + b"xaaxa" * 20
    before = tk.repairs
    (got, got_l, _m), (want, want_l, _w) = _both_paths(tk, data)
    repairs = tk.repairs - before
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], NativeVocab(v).tokenize(data)[0])
    assert repairs % 3 == 0 and 6 <= repairs <= 90   # three calls
    assert got_l == want_l and tk.host_fallbacks == 0


def test_replays_count_their_launches_and_reuse_one_capture(cuda):
    """Texts of several lengths with the same number of dispatches share
    one capture; every replayed call counts one launch of each kernel a
    dispatch, as the eager chain does, and the first call of the geometry
    also counts its warm-up (the chain once, op by op)."""
    v = _real32k()
    tk = GpuTokenizer(v, device=cuda)
    raw, _dropped = stdlib_text(v, 5 << 20)
    text = v.normalize(raw)
    nv = NativeVocab(v)
    per_call = []
    for size in (2_200_000, 2_500_000, 3_100_000):
        data = text[:size]
        assert len(tk._plan(len(data))[1]) == 3
        _build.reset_launches()
        ids, _missing = tk.tokenize(data)
        torch.cuda.synchronize()
        per_call.append(dict(_build.launches))
        np.testing.assert_array_equal(ids, nv.tokenize(data)[0])
    assert tk.captures == 1
    assert per_call[0] == {k: 6 for k in _build.KERNELS}, per_call
    assert per_call[1] == per_call[2] == {k: 3 for k in _build.KERNELS}


def test_failed_capture_raises(cuda, monkeypatch):
    """A chain that syncs inside the capture cannot be captured: the call
    raises, nothing is kept, nothing runs op by op in its place."""
    v = _real32k()
    tk = GpuTokenizer(v, device=cuda)
    raw, _dropped = stdlib_text(v, 1 << 20)
    data = v.normalize(raw)
    compact = tk._compact

    def syncing(*args):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return compact(*args)
    monkeypatch.setattr(tk, "_compact", syncing)
    tk.last_mode = None
    with pytest.raises(RuntimeError):
        tk.tokenize(data)
    assert tk.captures == 0 and tk.last_mode is None
    monkeypatch.setattr(tk, "_compact", compact)
    torch.cuda.synchronize()
    ids, _missing = tk.tokenize(data)
    np.testing.assert_array_equal(ids, NativeVocab(v).tokenize(data)[0])
    assert tk.captures == 1


def _score_both(sc, cand, strips):
    """(captured, eager) ``sc.score`` results and launches per kernel, the
    captured path counted on a call after its keys are captured; the
    eager path is the same call with each batch op by op."""
    from tokenmonster_tpu_torch.parallel import score as pscore
    sc.score(cand, strips)
    runs = []
    for eager in (False, True):
        _build.reset_launches()
        with mock.patch.object(pscore, "_run_captured", pscore._run_eager) \
                if eager else nullcontext():
            got = sc.score(cand, strips)
        torch.cuda.synchronize()
        runs.append((got, dict(_build.launches)))
    return runs


def _strips_of(data, count, size):
    step = (len(data) - size) // count
    return [data[i * step:i * step + size] for i in range(count)]


@pytest.mark.parametrize("cell", ["strips", "full"])
def test_captured_score_chain_equals_eager_and_native(trainer, cell):
    """The trainer's score chain as replays of captured graphs (20 strips
    of 40 kB, 16 a replay, the last batch 4 of 16 rows; one strip of two
    dispatches at batch 1) equals the same batches op by op and native,
    with as many launches of each kernel; the captures are no more than
    the keys, and nothing ran op by op."""
    from tokenmonster_tpu_torch.parallel import score as pscore
    sc, cand, data = trainer
    tk = sc._sup.tokenizer
    strips = (_strips_of(data, 20, 40_000) if cell == "strips"
              else [data[:(LANES - 1) * CHUNK + 300_000]])
    before, eager0 = set(tk._graphs), dict(sc.eager_scores)
    (got, got_l), (eager, eager_l) = _score_both(sc, cand, strips)
    want = native_score(cand, strips)
    for g in (got, eager):
        np.testing.assert_array_equal(g[0], want[0])
        assert g[1:] == want[1:]
    assert got_l == eager_l and all(got_l[k] > 0 for k in
                                    ("match", "decide", "follow"))
    assert got_l["match"] == (32 if cell == "strips" else 2)
    new = set(tk._graphs) - before     # one key: the strips' geometry
    B = pscore.batch_size(len(strips))
    assert all(k[0] == "score" and k[3] == B for k in new) and len(new) <= 1
    assert tk.captures == len(before) + len(new)
    assert sc.eager_scores == eager0


def test_two_threads_replay_score_graphs_safely(trainer):
    """Two threads score two candidates at once through the same captured
    graphs (each holds a graph's lock from loading its inputs through
    reading its outputs): each equals itself scored alone."""
    import threading
    sc, cand, data = trainer
    tokens = [bytes(t) for t in sc._sup.vocab.tokens]
    rng = np.random.default_rng(9)
    other = sc.build([t for t in tokens
                      if len(t) == 1 or rng.random() < 0.6])
    strips = _strips_of(data, 20, 30_000)
    cands = [cand, other]
    alone = [sc.score(c, strips) for c in cands]
    assert not np.array_equal(alone[0][0], alone[1][0])
    results = [[], []]

    def work(i):
        for _ in range(4):
            results[i].append(sc.score(cands[i], strips))
    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    for want, got in zip(alone, results):
        assert len(got) == 4
        for g in got:
            np.testing.assert_array_equal(g[0], want[0])
            assert g[1:] == want[1:]


def test_failed_score_capture_raises(cuda, monkeypatch):
    """A score chain that syncs inside its capture cannot be captured: the
    call raises and keeps no graph; nothing scores op by op in its
    place."""
    from tokenmonster_tpu_torch.parallel import score as pscore
    v = _real32k()
    sc = GpuCandidateScorer(v.charset, v.using_capcode, v.normalizer.flag,
                            device=cuda)
    sc.set_specials([])
    tokens = [bytes(t) for t in v.tokens]
    sc.prepare(tokens)
    cand = sc.build(tokens)
    raw, _dropped = stdlib_text(None, 1 << 20)
    strips = _strips_of(v.normalize(raw), 3, 50_000)
    sums = pscore._batch_sums

    def syncing(*args):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return sums(*args)
    monkeypatch.setattr(pscore, "_batch_sums", syncing)
    with pytest.raises(RuntimeError):
        sc.score(cand, strips)
    assert sc._sup.tokenizer.captures == 0
    assert sum(sc.eager_scores.values()) == 0
    monkeypatch.setattr(pscore, "_batch_sums", sums)
    torch.cuda.synchronize()
    got = sc.score(cand, strips)
    want = native_score(cand, strips)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and sc._sup.tokenizer.captures == 1


def test_wait_span_on_card(cuda):
    """On a card the host's waits for it are spans of their own: a
    ``wait`` under ``device`` for the metadata read and one for the ids'
    download, each counting the bytes it read, beside ``stage``,
    ``launch`` and ``expand``."""
    v = load(os.path.join(ROOT, "examples", "realtext-32000-fast.vocab"),
             device=cuda, route="device")
    text = "The quick brown fox jumps over the lazy dog. " * 400
    v.tokenize(text)                    # the geometry's capture
    tracing.clear()
    try:
        with tracing.enable():
            ids = v.tokenize(text)
        recs = tracing.records()
    finally:
        tracing.clear()
    (dev,) = [r for r in recs if r.name == "device"]
    under = [r for r in recs if r.parent == dev.id]
    waits = [r for r in under if r.name == "wait"]
    assert len(waits) == 2 and all(w.n > 0 for w in waits)
    assert {r.name for r in under} == {"stage", "launch", "wait", "expand"}
    assert next(r for r in under if r.name == "expand").n == len(ids)
