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
from tokenmonster_tpu_torch.ops.decide import decide_plain
from tokenmonster_tpu_torch.ops.follow import follow_plain, window
from tokenmonster_tpu_torch.ops.match import match_args, match_plain
from tokenmonster_tpu_torch.ops.tables import upload_tables

from torch_cases import (OVERLAP, VOCABS, ZERO_STEP_TEXT, edge_text,
                         edge_vocab, hashmatch_tables, text_for,
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
    lib.tm_compact_host.argtypes = [ctypes.POINTER(_build.CompactArgs)]
    lib.tm_decide_host.argtypes = [ctypes.POINTER(_build.DecideArgs),
                                   ctypes.c_int]
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


def _decide_host(lib, dt, buf, n, m, mb):
    rows = 2 if dt.has_delete else 1
    got_c = torch.full((rows, N), -1, dtype=torch.int32)
    got_t = torch.full((rows, N), -1, dtype=torch.int32)
    args = _build.DecideArgs(
        m=m.data_ptr(), mb=(mb if mb is not None else m).data_ptr(),
        text=buf.data_ptr(), meta=dt.meta.data_ptr(), bb=dt.bb.data_ptr(),
        ctl=got_c.data_ptr(), tok=got_t.data_ptr(), N=N,
        meta_stride=dt.meta.shape[1], n=n, has_delete=int(dt.has_delete),
        has_unk=int(dt.has_unk), unk_token=dt.unk_token,
        lil_off=dt.lil_off)
    lib.tm_decide_host(ctypes.byref(args), rows)
    return got_c, got_t


def test_decide_host_equals_plain(host_lib, stages):
    _name, dt, buf, n, m, mb, ctl, tok = stages
    got_c, got_t = _decide_host(host_lib, dt, buf, n, m, mb)
    assert torch.equal(got_c.reshape(ctl.shape), ctl)
    assert torch.equal(got_t.reshape(tok.shape), tok)


def test_zero_advance_step_host_equals_plain(host_lib):
    """The fd-1 step that advances 0 bytes (torch_cases.zero_step_vocab):
    decide and follow of the kernels' code equal the plain versions, and
    the lanes' records hold the step (a record at the position of the one
    before it)."""
    v = zero_step_vocab()
    dt = upload_tables(v, hashmatch_tables(v), "cpu")
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(ZERO_STEP_TEXT)] = torch.tensor(list(ZERO_STEP_TEXT),
                                             dtype=torch.uint8)
    n = len(ZERO_STEP_TEXT)
    m, mb = match_plain(buf, n, dt)
    ctl, tok = decide_plain(m, mb, buf, n, dt)
    got_c, got_t = _decide_host(host_lib, dt, buf, n, m, mb)
    assert torch.equal(got_c, ctl) and torch.equal(got_t, tok)
    assert ((ctl[1, :n] & 63) == 0).any()
    want = follow_plain(ctl, tok, n, 64, 8, OVERLAP, 256)
    got = _follow_host(host_lib, ctl, tok, n, 64, 8, 256)
    for w, g in zip(want, got):
        assert torch.equal(g, w)
    pos = want[0].long() >> 4
    assert ((pos[1:] == pos[:-1]) & (want[0][1:] != 0)).any()


def _follow_host(lib, ctl, tok, n, chunk, L, t_rec, tw=None):
    recs = torch.full((t_rec, L), -1, dtype=torch.int32)
    toks = torch.full((t_rec, L), -1, dtype=torch.int32)
    done = torch.ones(1, dtype=torch.int32)
    args = _build.FollowArgs(
        ctl=ctl.data_ptr(), tok=tok.data_ptr(), recs=recs.data_ptr(),
        toks=toks.data_ptr(), done_all=done.data_ptr(), N=ctl.shape[-1],
        rows=1 if ctl.dim() == 1 else ctl.shape[0], n=n, chunk=chunk,
        overlap=OVERLAP, W=window(chunk, OVERLAP), L=L, t_rec=t_rec)
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


@pytest.mark.parametrize("start0,final", [(0, True), (2, False)])
def test_compact_host_equals_plain(host_lib, stages, start0, final):
    _name, _dt, _buf, n, _m, _mb, ctl, tok = stages
    chunk, L, t_rec = 32, 128, 256
    recs, toks, _done = follow_plain(ctl, tok, n, chunk, L, OVERLAP, t_rec)
    last_lane = min(-(-n // chunk), L) - (1 if final else 2)
    _f, keep, _sn, _ok, s, e = stitch.stitched_keep(recs, start0, last_lane,
                                                    final)
    counts = keep.sum(0)
    q = (counts.cumsum(0) - counts - s).to(torch.int32)
    s, e = s.to(torch.int32), e.clamp(max=t_rec - 1).to(torch.int32)
    out_len = t_rec * L
    want = stitch.compact_plain(recs, toks, s, e, q, out_len)
    got = torch.zeros(out_len, dtype=torch.int32)
    args = _build.CompactArgs(
        recs=recs.data_ptr(), toks=toks.data_ptr(), s=s.data_ptr(),
        e=e.data_ptr(), q=q.data_ptr(), out=got.data_ptr(), out_len=out_len,
        T=t_rec, L=L)
    host_lib.tm_compact_host(ctypes.byref(args))
    assert torch.equal(got, want)
    assert int(counts.sum()) > 0
