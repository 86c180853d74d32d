"""The CUDA kernels on a card, against their plain PyTorch versions on the
same card and inputs, at the main path's shapes (chunk 2048, 512 lanes)
and at the trainer's (a candidate's masked superset tables): bit for bit
(tolerance 0; every output is an integer word).  Marked gpu; each test
skips when torch sees no CUDA card.  Imports no jax: the machine with the
card has none.

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from tokenmonster_tpu.core.vocab import Vocab
from tokenmonster_tpu_torch.corpus import (main_dispatch, one_row_vocab,
                                           stdlib_text)
from tokenmonster_tpu_torch.native import native_vocab
from tokenmonster_tpu_torch.ops import _build, stitch
from tokenmonster_tpu_torch.ops.decide import decide, decide_plain
from tokenmonster_tpu_torch.ops.follow import follow, follow_plain
from tokenmonster_tpu_torch.ops.match import match, match_plain
from tokenmonster_tpu_torch.ops.scan import MARGIN, OVERLAP_SCAN, GpuTokenizer
from tokenmonster_tpu_torch.train.score_helpers import candidate_runtime_state
from tokenmonster_tpu_torch.train.trainvocab import GpuCandidateScorer

from torch_cases import (ZERO_STEP_TEXT, ZERO_STEP_TOKENS, native_score,
                         zero_step_vocab)

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
    want, wmiss = native_vocab(v).tokenize(data)
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
    _n, lanes, bufs = tk.stage(data[:(LANES - 1) * CHUNK + MARGIN])
    assert lanes == LANES
    buf, n, _last = bufs[0]
    tabs = candidate_runtime_state(sc._sup, cand)
    m, mb = match(buf, n, tabs)
    for g, w in zip((m, mb), match_plain(buf, n, tabs)):
        _equal(g, w)
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
    _n, _lanes, bufs = tk.stage(ZERO_STEP_TEXT)
    buf, n, _last = bufs[0]
    tabs = candidate_runtime_state(sc._sup, cand)
    m, mb = match(buf, n, tabs)
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
