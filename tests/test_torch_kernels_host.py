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
from tokenmonster_tpu_torch.ops.match import match_plain
from tokenmonster_tpu_torch.ops.tables import upload_tables

from torch_cases import (OVERLAP, VOCABS, ZERO_STEP_TEXT, hashmatch_tables,
                         text_for, zero_step_vocab)

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
                         ("follow", _build.FollowArgs),
                         ("compact", _build.CompactArgs)):
        getattr(lib, f"tm_{name}_host").argtypes = [ctypes.POINTER(struct)]
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


def test_match_host_equals_plain(host_lib, stages):
    _name, dt, buf, n, m, mb, _ctl, _tok = stages
    got_m = torch.full((N,), -1, dtype=torch.int32)
    got_mb = torch.full((N,), -1, dtype=torch.int32)
    args = _build.MatchArgs(
        text=buf.data_ptr(), fields=dt.fields.data_ptr(),
        disp=dt.disp.data_ptr(), single=dt.single.data_ptr(),
        space_single=dt.space_single.data_ptr(),
        scalars=dt.scalars.data_ptr(), desc=dt.desc.data_ptr(),
        len_cls=dt.len_cls.data_ptr(), ovf_keys=dt.ovf_keys.data_ptr(),
        m=got_m.data_ptr(), mb=got_mb.data_ptr(), N=N, n=n,
        max_len=dt.max_len, idx1_bits=dt.idx1_bits,
        has_space=int(dt.has_space), lil_off=dt.lil_off)
    host_lib.tm_match_host(ctypes.byref(args))
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


def _follow_host(lib, ctl, tok, n, chunk, L, t_rec):
    recs = torch.full((t_rec, L), -1, dtype=torch.int32)
    toks = torch.full((t_rec, L), -1, dtype=torch.int32)
    done = torch.ones(1, dtype=torch.int32)
    args = _build.FollowArgs(
        ctl=ctl.data_ptr(), tok=tok.data_ptr(), recs=recs.data_ptr(),
        toks=toks.data_ptr(), done_all=done.data_ptr(), N=ctl.shape[-1],
        rows=1 if ctl.dim() == 1 else ctl.shape[0], n=n, chunk=chunk,
        overlap=OVERLAP, W=window(chunk, OVERLAP), L=L, t_rec=t_rec)
    lib.tm_follow_host(ctypes.byref(args))
    return recs, toks, done[0]


@pytest.mark.parametrize("chunk,L,t_rec", [(32, 128, 256), (64, 50, 128),
                                           (32, 128, 16)])
def test_follow_host_equals_plain(host_lib, stages, chunk, L, t_rec):
    _name, _dt, _buf, n, _m, _mb, ctl, tok = stages
    want = follow_plain(ctl, tok, n, chunk, L, OVERLAP, t_rec)
    got = _follow_host(host_lib, ctl, tok, n, chunk, L, t_rec)
    for w, g in zip(want, got):
        assert torch.equal(g, w)


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
