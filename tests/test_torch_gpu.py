"""The CUDA kernels on a card, against their plain PyTorch versions on the
same card and inputs, at the main path's shapes (chunk 2048, 512 lanes):
bit for bit (tolerance 0; every output is an integer word).  Marked gpu;
each test skips when torch sees no CUDA card.  Imports no jax: the machine
with the card has none.

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from tokenmonster_tpu.core.vocab import Vocab
from tokenmonster_tpu.native import NativeVocab
from tokenmonster_tpu_torch.corpus import (main_dispatch, one_row_vocab,
                                           stdlib_text)
from tokenmonster_tpu_torch.ops import _build, stitch
from tokenmonster_tpu_torch.ops.decide import decide, decide_plain
from tokenmonster_tpu_torch.ops.follow import follow, follow_plain
from tokenmonster_tpu_torch.ops.match import match, match_plain
from tokenmonster_tpu_torch.ops.scan import OVERLAP_SCAN, GpuTokenizer

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
    got_c = stitch.compact(recs, toks, s, e, q, t_rec * LANES)
    want_c = stitch.compact_plain(recs, toks, s, e, q, t_rec * LANES)
    torch.cuda.synchronize()
    _equal(got_c, want_c)


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
    assert tk.fallbacks == {"missing_byte": 0, "junction": 0}
    assert all(c > 0 for c in tk.launches.values()), tk.launches


def test_wrappers_validate_arguments(dispatch):
    tk, buf, n = dispatch
    with pytest.raises(TypeError):
        match(buf.to(torch.int32), n, tk.tables)
    with pytest.raises(ValueError):
        match(buf, buf.numel() + 1, tk.tables)
    with pytest.raises(ValueError):
        match(buf[::2], n // 2, tk.tables)
