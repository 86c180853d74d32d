"""The CUDA kernels' own per-thread code (csrc/tm_kernels.cuh), compiled for
the host with g++ through csrc/tm_host.cpp, against the plain PyTorch
versions, bit for bit (tolerance 0).  This is the check of the kernels'
arithmetic that runs without a card; tests/test_torch_gpu.py runs the
kernels themselves on one."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tokenmonster_tpu_torch.ops import _build, stitch
from tokenmonster_tpu_torch.ops import hashmatch as phm
from tokenmonster_tpu_torch.ops.decide import decide_plain
from tokenmonster_tpu_torch.ops.follow import follow_plain, window
from tokenmonster_tpu_torch.ops.match import match_args, match_plain
from tokenmonster_tpu_torch.ops.tables import (W3_SHIFT, DeviceTables,
                                              space_prefix, upload_tables)

from torch_cases import (OVERLAP, VOCABS, ZERO_STEP_TEXT, edge_text,
                         edge_vocab, hashmatch_tables, offset_placement,
                         text_for, wide_matches, wide_tables, wide_words,
                         zero_step_vocab)

N = 4096


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels' host harness")
    so = str(tmp_path_factory.mktemp("tm_host") / "libtm_host.so")
    src = os.path.join(_build.CSRC, "tm_host.cpp")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    for name, struct in (("match", _build.MatchArgs),
                         ("follow", _build.FollowArgs)):
        getattr(lib, f"tm_{name}_host").argtypes = [ctypes.POINTER(struct),
                                                    ctypes.c_int]
    lib.tm_match_tile.restype = ctypes.c_int
    lib.tm_compact_host.argtypes = [ctypes.POINTER(_build.CompactArgs),
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tm_compact_tile.argtypes = [ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    lib.tm_decide_host.argtypes = [ctypes.POINTER(_build.DecideArgs),
                                   ctypes.c_int]
    lib.tm_decide_tile.restype = ctypes.c_int
    lib.tm_follow_word_bytes.argtypes = [ctypes.POINTER(_build.FollowArgs)]
    lib.tm_match_hit_word.argtypes = [ctypes.c_int] * 3
    lib.tm_args_layout.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    return lib


@pytest.fixture(scope="module", params=sorted(VOCABS))
def stages(request):
    """One seeded text through the plain match and decide stages."""
    name = request.param
    v = VOCABS[name]()
    dt = upload_tables(v, hashmatch_tables(v), "cpu")
    data = text_for(name, v, N - 700, seed=7, misses=name != "utf16")
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    buf[len(data):len(data) + 300] = 101     # live bytes past n
    n = len(data)
    mm = match_plain(buf, n, dt)
    m, mb = mm if dt.has_space else (mm, None)
    ctl, tok = decide_plain(m, mb, buf, n, dt)
    return name, dt, buf, n, m, mb, ctl, tok


@pytest.fixture(scope="module", params=["capcode", "unk"])
def wide_stages(request):
    """The seeded text of ``stages`` decided at S = 21 on tables whose
    dictionary indices are moved up by 2^20 (``torch_cases.wide_tables``),
    as a vocabulary of more than 2^20 entries decides it."""
    name = request.param
    v = VOCABS[name]()
    dt = wide_tables(upload_tables(v, hashmatch_tables(v), "cpu"))
    data = text_for(name, v, N - 700, seed=7)
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    n = len(data)
    mm = match_plain(buf, n, upload_tables(v, hashmatch_tables(v), "cpu"))
    m, mb = (wide_matches(w) for w in (mm if dt.has_space else (mm, None)))
    ctl, tok = decide_plain(m, mb, buf, n, dt)
    assert (tok.long() & 0x1FFFFF >= 1 << 20).any()
    return name, dt, buf, n, m, mb, ctl, tok


def _match_host(lib, dt, buf, n, tile):
    got_m = torch.full((buf.numel(),), -1, dtype=torch.int32)
    got_mb = torch.full((buf.numel(),), -1, dtype=torch.int32)
    args = match_args(buf, n, dt, got_m, got_mb)
    lib.tm_match_host(ctypes.byref(args), tile)
    return got_m, got_mb


def test_match_host_equals_plain(host_lib, stages):
    """Text tiles as the kernel stages them (its warp tile, and 61: tile
    boundaries at other offsets inside matches), the key filter, the
    32-bit key compares."""
    _name, dt, buf, n, m, mb, _ctl, _tok = stages
    for tile in (host_lib.tm_match_tile(), 61):
        got_m, got_mb = _match_host(host_lib, dt, buf, n, tile)
        assert torch.equal(got_m, m)
        if mb is not None:
            assert torch.equal(got_mb, mb)


@pytest.mark.parametrize("capcode", [0, 1])
def test_match_host_edges_equal_plain(host_lib, capcode):
    """Overflow keys (full-hash twins), 40-byte keys and their near misses,
    at every offset of tiles of the kernel's warp tile, 61 and 37
    positions."""
    v = edge_vocab(capcode)
    dt = upload_tables(v, hashmatch_tables(v), "cpu")
    assert dt.max_len == 40 and any(c.ovf_keys for c in dt.classes)
    data = edge_text(N - 100, seed=capcode)
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    mm = match_plain(buf, len(data), dt)
    m, mb = mm if dt.has_space else (mm, None)
    assert ((m & 63) == 40).any() and ((m & 63) == 6).any()
    for tile in (host_lib.tm_match_tile(), 61, 37):
        got_m, got_mb = _match_host(host_lib, dt, buf, len(data), tile)
        assert torch.equal(got_m, m)
        if mb is not None:
            assert torch.equal(got_mb, mb)


def _decide_host(lib, dt, buf, n, m, mb, tile=None):
    rows = 2 if dt.has_delete else 1
    N = buf.numel()
    got_c = torch.full((rows, N), -1, dtype=torch.int32)
    got_t = torch.full((rows, N), -1, dtype=torch.int32)
    n_t = _build.scalar_arg(n, "n", N, buf.device)
    args = _build.DecideArgs(
        m=m.data_ptr(), mb=(mb if mb is not None else m).data_ptr(),
        text=buf.data_ptr(), entries=dt.entries.data_ptr(),
        bb=dt.bb.data_ptr(), ctl=got_c.data_ptr(), tok=got_t.data_ptr(),
        n=n_t.data_ptr(), literals=dt.literals.data_ptr(), N=N,
        n_entries=dt.entries.shape[1], has_delete=int(dt.has_delete),
        lil_off=dt.lil_off, w3_shift=dt.w3_shift)
    lib.tm_decide_host(ctypes.byref(args), tile or lib.tm_decide_tile())
    return got_c, got_t


def test_decide_host_equals_plain(host_lib, stages):
    _name, dt, buf, n, m, mb, ctl, tok = stages
    got_c, got_t = _decide_host(host_lib, dt, buf, n, m, mb)
    assert torch.equal(got_c.reshape(ctl.shape), ctl)
    assert torch.equal(got_t.reshape(tok.shape), tok)


@pytest.mark.parametrize("tile", [61, 37, 1])
def test_decide_host_tiles_equal_plain(host_lib, stages, tile):
    """Tiles of neighbourhood pairs as the kernel stages them, small and
    odd: every decision's lookahead crosses tile edges at other offsets,
    the last tiles' lookahead runs past the end of the buffer (zeros
    there), on both fd rows where the vocabulary has them; the unk
    vocabulary and charset 2 (lil_off 2) are among ``stages``."""
    name, dt, buf, n, m, mb, ctl, tok = stages
    assert name != "utf16" or dt.lil_off == 2
    assert name != "unk" or dt.has_unk
    got_c, got_t = _decide_host(host_lib, dt, buf, n, m, mb, tile)
    assert torch.equal(got_c.reshape(ctl.shape), ctl)
    assert torch.equal(got_t.reshape(tok.shape), tok)


@pytest.mark.parametrize("tile", [None, 61, 37])
def test_decide_host_at_the_end_of_the_text(host_lib, stages, tile):
    """A buffer that ends where the text ends, its length no multiple of a
    tile: the last decisions' second tokens and next bytes lie past N and
    read as zeros, as in the plain version."""
    _name, dt, buf, n, _m, _mb, _ctl, _tok = stages
    cut = buf[:n - 3].clone()
    mm = match_plain(cut, cut.numel(), dt)
    m, mb = mm if dt.has_space else (mm, None)
    ctl, tok = decide_plain(m, mb, cut, cut.numel(), dt)
    got_c, got_t = _decide_host(host_lib, dt, cut, cut.numel(), m, mb, tile)
    assert torch.equal(got_c.reshape(ctl.shape), ctl)
    assert torch.equal(got_t.reshape(tok.shape), tok)


@pytest.mark.parametrize("tile", [None, 61, 7])
def test_zero_advance_step_host_equals_plain(host_lib, tile):
    """The fd-1 step that advances 0 bytes (torch_cases.zero_step_vocab):
    decide (on the kernel's tile and on small ones) and follow of the
    kernels' code equal the plain versions, and the lanes' records hold
    the step (a record at the position of the one before it)."""
    v = zero_step_vocab()
    dt = upload_tables(v, hashmatch_tables(v), "cpu")
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(ZERO_STEP_TEXT)] = torch.tensor(list(ZERO_STEP_TEXT),
                                             dtype=torch.uint8)
    n = len(ZERO_STEP_TEXT)
    m, mb = match_plain(buf, n, dt)
    ctl, tok = decide_plain(m, mb, buf, n, dt)
    got_c, got_t = _decide_host(host_lib, dt, buf, n, m, mb, tile)
    assert torch.equal(got_c, ctl) and torch.equal(got_t, tok)
    assert ((ctl[1, :n] & 63) == 0).any()
    want = follow_plain(ctl, tok, n, 64, 8, OVERLAP, 256)
    got = _follow_host(host_lib, ctl, tok, n, 64, 8, 256)
    for w, g in zip(want, got):
        assert torch.equal(g, w)
    pos = want[0].long() >> 4
    assert ((pos[1:] == pos[:-1]) & (want[0][1:] != 0)).any()


def _follow_host(lib, ctl, tok, n, chunk, L, t_rec, tw=None,
                 w3_shift=W3_SHIFT):
    recs = torch.full((t_rec, L), -1, dtype=torch.int32)
    toks = torch.full((t_rec, L), -1, dtype=torch.int32)
    done = torch.ones(1, dtype=torch.int32)
    n_t = _build.scalar_arg(n, "n", ctl.shape[-1], ctl.device)
    args = _build.FollowArgs(
        ctl=ctl.data_ptr(), tok=tok.data_ptr(), recs=recs.data_ptr(),
        toks=toks.data_ptr(), done_all=done.data_ptr(), n=n_t.data_ptr(),
        N=ctl.shape[-1], rows=1 if ctl.dim() == 1 else ctl.shape[0],
        chunk=chunk, overlap=OVERLAP, W=window(chunk, OVERLAP), L=L,
        t_rec=t_rec, w3_shift=w3_shift)
    lib.tm_follow_host(ctypes.byref(args), tw or args.W)
    return recs, toks, done[0]


@pytest.mark.parametrize("chunk,L,t_rec", [(32, 128, 256), (64, 50, 128),
                                           (32, 128, 16)])
def test_follow_host_equals_plain(host_lib, stages, chunk, L, t_rec):
    _name, _dt, _buf, n, _m, _mb, ctl, tok = stages
    want = follow_plain(ctl, tok, n, chunk, L, OVERLAP, t_rec)
    got = _follow_host(host_lib, ctl, tok, n, chunk, L, t_rec)
    for w, g in zip(want, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tw", [1, 7, 100])
def test_follow_host_tiles_equal_plain(host_lib, stages, tw):
    """Lane windows walked in tiles of ``tw`` positions, refilled from
    where each lane stopped, as the kernel walks windows longer than its
    shared memory (a bridge or repair lane): the records of the whole
    window, and a full-window retry's geometry (t_rec records a byte)."""
    _name, _dt, _buf, n, _m, _mb, ctl, tok = stages
    for chunk, L, t_rec in ((32, 128, 256), (1024, 3, 2304)):
        want = follow_plain(ctl, tok, n, chunk, L, OVERLAP, t_rec)
        got = _follow_host(host_lib, ctl, tok, n, chunk, L, t_rec, tw)
        for w, g in zip(want, got):
            assert torch.equal(g, w)
        assert int(want[2]) == 1


def _compact_host(lib, recs, toks, s, e, q, out_len, tiles=None,
                  w3_shift=W3_SHIFT):
    """The harness's compact into a buffer of ones: the kernel's code
    writes every word, the zeros too."""
    T, L = recs.shape
    got = torch.ones(out_len, dtype=torch.int32)
    args = _build.CompactArgs(
        recs=recs.data_ptr(), toks=toks.data_ptr(), s=s.data_ptr(),
        e=e.data_ptr(), q=q.data_ptr(), out=got.data_ptr(), out_len=out_len,
        T=T, L=L, w3_shift=w3_shift)
    if tiles is None:
        recs_t, zero = ctypes.c_int(0), ctypes.c_int(0)
        lanes_t = lib.tm_compact_tile(ctypes.byref(recs_t),
                                      ctypes.byref(zero))
        tiles = (lanes_t, recs_t.value, zero.value)
    lib.tm_compact_host(ctypes.byref(args), *tiles)
    return got


def _kept(recs, start0, last_lane, final):
    t_rec = recs.shape[0]
    _f, keep, _sn, _ok, s, e = stitch.stitched_keep(recs, start0, last_lane,
                                                    final)
    counts = keep.sum(0)
    q = (counts.cumsum(0) - counts - s).to(torch.int32)
    return (s.to(torch.int32), e.clamp(max=t_rec - 1).to(torch.int32), q,
            int(counts.sum()))


@pytest.mark.parametrize("tiles", [None, (5, 7, 64), (3, 61, 32)])
@pytest.mark.parametrize("start0,final", [(0, True), (2, False)])
def test_compact_host_equals_plain(host_lib, stages, start0, final, tiles):
    """The kernel's tiles, and small odd ones (L = 128 no multiple of the
    lane tile): every word of the output, the zeros the kernel's code
    writes included."""
    _name, _dt, _buf, n, _m, _mb, ctl, tok = stages
    chunk, L, t_rec = 32, 128, 256
    recs, toks, _done = follow_plain(ctl, tok, n, chunk, L, OVERLAP, t_rec)
    last_lane = min(-(-n // chunk), L) - (1 if final else 2)
    s, e, q, count = _kept(recs, start0, last_lane, final)
    out_len = t_rec * L
    want = stitch.compact_plain(recs, toks, s, e, q, out_len)
    got = _compact_host(host_lib, recs, toks, s, e, q, out_len, tiles)
    assert torch.equal(got, want)
    assert count > 0


@pytest.mark.parametrize("tiles", [None, (5, 7, 64), (32, 64, 32)])
@pytest.mark.parametrize("L", [1, 5, 45])
def test_compact_host_odd_ranges_equal_plain(host_lib, L, tiles):
    """Ranges a synced dispatch does not give but the kernel must take:
    lanes whose [s, e] is empty, starts after the first record tile, ends
    at T - 1 or past it, s negative; q negative and past out_len (those
    records are dropped); gaps between the lanes' slots (zeros there);
    L below and no multiple of the lane tile; out_len no multiple of the
    zero-fill chunk."""
    T, out_len = 150, 160 * L + 77
    rng = np.random.default_rng(L)
    recs = torch.tensor(rng.integers(1, 1 << 20, (T, L)), dtype=torch.int32)
    toks = torch.tensor(rng.integers(1, 1 << 22, (T, L)), dtype=torch.int32)
    s = rng.integers(-3, T, L)
    e = np.minimum(s + rng.integers(0, T, L), T + 5)
    s[::4] = rng.integers(70, T, len(s[::4]))     # after the first tiles
    e[::4] = T - 1
    e[2::5] = s[2::5] - 1                         # empty
    span = np.maximum(e.clip(max=T - 1) - s.clip(min=0) + 1, 0)
    q = np.cumsum(span + 3) - span - s.clip(min=0)  # gaps of 3 slots
    q[0] = -s[0].clip(min=0) - 2                  # two records before slot 0
    if L > 1:
        q[-1] = out_len - 4 - s[-1].clip(min=0)   # runs past out_len
    s, e, q = (torch.tensor(v, dtype=torch.int32) for v in (s, e, q))
    want = stitch.compact_plain(recs, toks, s, e, q, out_len)
    got = _compact_host(host_lib, recs, toks, s, e, q, out_len, tiles)
    assert torch.equal(got, want)
    assert (want != 0).any() and (want == 0).any()


@pytest.mark.parametrize("tile", [None, 61])
def test_decide_host_at_s21_equals_plain(host_lib, wide_stages, tile):
    """The wide token word: idx | w3 << 21, literals at 3 << 21, with
    indices past 2^20."""
    _name, dt, buf, n, m, mb, ctl, tok = wide_stages
    got_c, got_t = _decide_host(host_lib, dt, buf, n, m, mb, tile)
    assert torch.equal(got_c.reshape(ctl.shape), ctl)
    assert torch.equal(got_t.reshape(tok.shape), tok)
    assert ((tok.long() >> 22) & 1).any()


@pytest.mark.parametrize("tw", [None, 7])
def test_follow_host_at_s21_equals_plain(host_lib, wide_stages, tw):
    """Token words of 23 bits through the follow tile's packed word."""
    _name, _dt, _buf, n, _m, _mb, ctl, tok = wide_stages
    want = follow_plain(ctl, tok, n, 32, 128, OVERLAP, 256, 21)
    got = _follow_host(host_lib, ctl, tok, n, 32, 128, 256, tw, 21)
    for w, g in zip(want, got):
        assert torch.equal(g, w)
    assert ((want[1].long() >> 22) & 1).any()


@pytest.mark.parametrize("tiles", [None, (5, 7, 64)])
def test_compact_host_at_s21_equals_plain(host_lib, wide_stages, tiles):
    """The delete marker at bit 23, above a 23-bit token word."""
    _name, _dt, _buf, n, _m, _mb, ctl, tok = wide_stages
    chunk, L, t_rec = 32, 128, 256
    recs, toks, _done = follow_plain(ctl, tok, n, chunk, L, OVERLAP, t_rec,
                                     21)
    s, e, q, count = _kept(recs, 0, min(-(-n // chunk), L) - 1, True)
    out_len = t_rec * L
    want = stitch.compact_plain(recs, toks, s, e, q, out_len, 21)
    got = _compact_host(host_lib, recs, toks, s, e, q, out_len, tiles, 21)
    assert torch.equal(got, want)
    assert count > 0


@pytest.mark.parametrize("bits,top", [(22, (1 << 21) - 1), (24, 1 << 22),
                                      (24, (1 << 24) - 3)])
@pytest.mark.parametrize("name", ["plain", "capcode", "utf16"])
def test_match_host_at_wide_fields_equals_plain(host_lib, name, bits, top):
    """Placements of 22 and 24 index bits (44 and 48 with the
    space-stripped index, spilling into the second field word), indices up
    to 2^24 - 3 (``torch_cases.offset_placement``): the kernel's key
    compare and index decode against the plain version, on its warp tile
    and on tiles of 61."""
    v = VOCABS[name]()
    off = top - (len(v.tokens) - 1)
    dt = DeviceTables(v, offset_placement(phm, v.tokens, off, bits,
                                          space_prefix(v)), match_only=True)
    data = text_for(name, v, N - 700, seed=2)
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    mm = match_plain(buf, len(data), dt)
    m, mb = mm if dt.has_space else (mm, None)
    assert ((m.long() & 0xFFFFFFFF) >> 6).max() >= off
    for tile in (host_lib.tm_match_tile(), 61):
        got_m, got_mb = _match_host(host_lib, dt, buf, len(data), tile)
        assert torch.equal(got_m, m)
        if mb is not None:
            assert torch.equal(got_mb, mb)


def test_match_hit_word_holds_24_bit_indices(host_lib):
    """The kernel's shared hit list packs a hit as length << 24 | index
    and gives back the match word (idx << 6) | (len + add) for every
    length and for indices up to 2^24 - 3."""
    for l in (1, 2, 40, 63):
        for idx in (0, 1, (1 << 21) - 1, 1 << 21, 1 << 22, (1 << 24) - 3):
            for add in (0, 1, 2):
                want = (idx << 6) | (l + add)
                got = host_lib.tm_match_hit_word(l, idx, add)
                assert got & 0xFFFFFFFF == want, (l, idx, add)


@pytest.fixture(scope="module", params=[22, 23, 24])
def wider_stages(request, stages):
    """The decisions of ``stages`` as a vocabulary of more than 2^(S - 1)
    entries has them: token words at S = 22, 23 or 24 with every index
    moved up by 2^(S - 1) (``torch_cases.wide_words``)."""
    S = request.param
    name, _dt, _buf, n, _m, _mb, ctl, tok = stages
    wide = wide_words(ctl, tok, 1 << (S - 1), S)
    assert (wide.long() >> (S - 1) & 1).any() and (wide.long() >> (S + 1)).any()
    return name, S, n, ctl, wide


@pytest.mark.parametrize("tw", [None, 7])
def test_follow_host_at_wide_shifts_equals_plain(host_lib, wider_stages, tw):
    """Token words of S + 2 = 24 to 26 bits: the follow tile's word is a
    u64 there (9 + S + 2 bits), a u32 up to S = 21."""
    _name, S, n, ctl, tok = wider_stages
    want = follow_plain(ctl, tok, n, 32, 128, OVERLAP, 256, S)
    got = _follow_host(host_lib, ctl, tok, n, 32, 128, 256, tw, S)
    for w, g in zip(want, got):
        assert torch.equal(g, w)
    t = want[1].long()
    assert ((t >> (S - 1)) & 1).any() and ((t >> S) & 3).any()
    for s, size in ((20, 4), (21, 4), (S, 8)):
        args = _build.FollowArgs(w3_shift=s)
        assert host_lib.tm_follow_word_bytes(ctypes.byref(args)) == size


@pytest.mark.parametrize("tiles", [None, (5, 7, 64)])
def test_compact_host_at_wide_shifts_equals_plain(host_lib, wider_stages,
                                                  tiles):
    """The delete marker at bit S + 2, up to bit 26, above a token word of
    S + 2 bits."""
    _name, S, n, ctl, tok = wider_stages
    chunk, L, t_rec = 32, 128, 256
    recs, toks, _done = follow_plain(ctl, tok, n, chunk, L, OVERLAP, t_rec,
                                     S)
    s, e, q, count = _kept(recs, 0, min(-(-n // chunk), L) - 1, True)
    out_len = t_rec * L
    want = stitch.compact_plain(recs, toks, s, e, q, out_len, S)
    got = _compact_host(host_lib, recs, toks, s, e, q, out_len, tiles, S)
    assert torch.equal(got, want)
    assert count > 0


def test_decide_host_at_s22_equals_plain(host_lib):
    """The decide kernel's code at S = 22 on tables whose indices are moved
    up by 2^21: literals at 3 << 22, indices with bit 21 set."""
    v = VOCABS["unk"]()
    base = upload_tables(v, hashmatch_tables(v), "cpu")
    dt = wide_tables(base, 1 << 21, 22)
    data = text_for("unk", v, N - 700, seed=7)
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    n = len(data)
    m = wide_matches(match_plain(buf, n, base), 1 << 21)
    ctl, tok = decide_plain(m, None, buf, n, dt)
    got_c, got_t = _decide_host(host_lib, dt, buf, n, m, None, 61)
    assert torch.equal(got_c.reshape(ctl.shape), ctl)
    assert torch.equal(got_t.reshape(tok.shape), tok)
    t = tok.long()
    assert (t >> 22 == 3).any() and ((t & ((1 << 22) - 1)) >= 1 << 21).any()


def test_argument_structs_match_their_ctypes_mirrors(host_lib):
    """Every argument struct's size and every field's offset, as g++ lays
    out csrc/tm_kernels.cuh, equal its ctypes mirror's in ops/_build.py:
    the device-scalar pointer ``n`` of match, decide and follow among
    them."""
    structs = (_build.MatchArgs, _build.DecideArgs, _build.FollowArgs,
               _build.CompactArgs)
    want = []
    for st in structs:
        want += [ctypes.sizeof(st)] + [getattr(st, f).offset
                                       for f, _t in st._fields_]
    got = (ctypes.c_int64 * 256)()
    count = host_lib.tm_args_layout(got)
    assert list(got[:count]) == want
    for st in structs[:3]:
        assert dict(st._fields_)["n"] is ctypes.c_void_p
    assert dict(_build.DecideArgs._fields_)["literals"] is ctypes.c_void_p


def test_decide_reads_the_unk_literal_through_its_pointer(host_lib):
    """decide's unk id and flag are read on the device (``literals``, a
    trainer candidate's, so one captured score chain serves every
    candidate): the kernel's code and the plain version, given the same
    tables with another unk id or with the unk flag cleared, write the
    misses' token words and has_tok bits those literals say."""
    v = VOCABS["unk"]()
    dt = upload_tables(v, hashmatch_tables(v), "cpu")
    data = text_for("unk", v, N - 700, seed=5)
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    n = len(data)
    m = match_plain(buf, n, dt)
    base_c, base_t = decide_plain(m, None, buf, n, dt)
    miss = (base_c & (1 << 9)) != 0
    assert miss.any() and dt.has_unk
    for unk, has in ((dt.unk_token + 7, 1), (dt.unk_token, 0)):
        dt.literals = torch.tensor([unk, has, dt.delete_token],
                                   dtype=torch.int32)
        ctl, tok = decide_plain(m, None, buf, n, dt)
        got_c, got_t = _decide_host(host_lib, dt, buf, n, m, None, 61)
        assert torch.equal(got_c.reshape(ctl.shape), ctl)
        assert torch.equal(got_t.reshape(tok.shape), tok)
        assert torch.equal(tok[miss], torch.full_like(tok[miss],
                                                      (3 << 20) | unk))
        assert torch.equal((ctl[miss] >> 7) & 1,
                           torch.full_like(ctl[miss], has))
        assert torch.equal(ctl[~miss], base_c[~miss])


def test_stages_read_n_from_dispatch_scalars(host_lib, stages):
    """match, decide and follow of the kernels' code read ``n`` through
    the pointer, from a row of a dispatch-scalar array (n, last lane,
    final) as ``GpuTokenizer.stage`` builds one: for each of three
    dispatches' n, their outputs equal the plain versions given that
    0-dim tensor, and differ from one n to the next."""
    _name, dt, buf, n, _m, _mb, _ctl, _tok = stages
    scalars = torch.tensor([[n, 40, 0], [n - 333, 20, 0], [n // 3, 5, 1]],
                           dtype=torch.int32)
    seen = []
    for d in range(3):
        nd = scalars[d, 0]
        mm = match_plain(buf, nd, dt)
        m, mb = mm if dt.has_space else (mm, None)
        got_m, got_mb = _match_host(host_lib, dt, buf, nd, 61)
        assert torch.equal(got_m, m)
        if mb is not None:
            assert torch.equal(got_mb, mb)
        ctl, tok = decide_plain(m, mb, buf, nd, dt)
        got_c, got_t = _decide_host(host_lib, dt, buf, nd, m, mb, 37)
        assert torch.equal(got_c.reshape(ctl.shape), ctl)
        assert torch.equal(got_t.reshape(tok.shape), tok)
        want = follow_plain(ctl, tok, nd, 32, 128, OVERLAP, 256)
        got = _follow_host(host_lib, ctl, tok, nd, 32, 128, 256, 7)
        for w, g in zip(want, got):
            assert torch.equal(g, w)
        seen.append(want[0])
    assert not torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[1], seen[2])
