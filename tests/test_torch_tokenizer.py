"""The slice as a whole: GpuTokenizer(device="cpu") — the plain versions of
the four kernels plus the PyTorch stitch and chaining — against the JAX
TpuTokenizer (Pallas engine, interpret mode), the host oracle and the
native tokenizer.  Ids and missing counts must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode
from tokenmonster_tpu.ops import stitch as jstitch
from tokenmonster_tpu.ops.scan import TpuTokenizer
from tokenmonster_tpu_torch.ops import scan, stitch
from tokenmonster_tpu_torch.ops.decide import decide
from tokenmonster_tpu_torch.ops.follow import follow
from tokenmonster_tpu_torch.ops.match import match
from tokenmonster_tpu_torch.ops.scan import OVERLAP_SCAN, GpuTokenizer

from torch_cases import (ENGLISH, VOCABS, ZERO_STEP_TEXT, native_ids,
                         realtext_vocab, text_for, zero_step_vocab)


@pytest.mark.parametrize("name", sorted(VOCABS))
def test_tokenizer_equals_jax_oracle_native(name):
    v = VOCABS[name]()
    data = text_for(name, v, 3000, seed=8, misses=name == "unk")
    tk = GpuTokenizer(v, chunk=64, device="cpu")
    ids, missing = tk.tokenize(data)
    assert tk.last_mode == "fast" and tk.host_fallbacks == 0
    want, wmiss = host_tokenize(v, data)
    np.testing.assert_array_equal(ids, np.asarray(want, np.uint32))
    assert missing == wmiss
    if name == "unk":
        assert missing > 0
    nids, nmiss = native_ids(v, data)
    np.testing.assert_array_equal(ids, nids)
    assert missing == nmiss
    jids, jmiss = TpuTokenizer(v, chunk=64).tokenize(data)
    np.testing.assert_array_equal(ids, np.asarray(jids, np.uint32))
    assert missing == jmiss


def test_multi_dispatch_bridges():
    """Chunk 32 and more than 512 lanes: three chained dispatches, each
    splicing onto the previous one's bridge lane."""
    v = VOCABS["capcode"]()
    data = text_for("capcode", v, 40000, seed=9, misses=False)
    tk = GpuTokenizer(v, chunk=32, device="cpu")
    L, plan = tk._plan(len(data))
    assert L == 512 and len(plan) == 3
    ids, missing = tk.tokenize(data)
    assert tk.last_mode == "fast" and tk.host_fallbacks == 0
    nids, nmiss = native_ids(v, data)
    np.testing.assert_array_equal(ids, nids)
    assert missing == nmiss == 0


def test_dense_text_full_window_retry():
    """About one record per byte overflows the fast record window; the
    full-window retry syncs (unk vocabulary: misses still emit)."""
    v = VOCABS["unk"]()
    data = (b"q\x01u\x02i\x03c\x04k\x05" * 800)[:3000]
    tk = GpuTokenizer(v, chunk=2048, device="cpu")
    ids, missing = tk.tokenize(data)
    assert tk.last_mode == "full" and tk.host_fallbacks == 0
    want, wmiss = host_tokenize(v, data)
    np.testing.assert_array_equal(ids, np.asarray(want, np.uint32))
    assert missing == wmiss > 1000


@pytest.mark.parametrize("name", ["capcode", "plain"])
def test_missing_byte_without_unk_falls_back(name):
    """A byte the vocabulary lacks, with no unk token: no device variant
    syncs, the text goes to the native tokenizer, counted; ids exact."""
    v = VOCABS[name]()
    data = text_for(name, v, 2000, seed=10, misses=True)
    tk = GpuTokenizer(v, chunk=64, device="cpu")
    ids, missing = tk.tokenize(data)
    assert tk.host_fallbacks == 1 and tk.last_mode == "host"
    assert tk.fallbacks == {"missing_byte": 1}
    want, wmiss = host_tokenize(v, data)
    np.testing.assert_array_equal(ids, np.asarray(want, np.uint32))
    assert missing == wmiss > 0


def _run_vocab(capcode: int = 0):
    """Tokens "aa", "a" and "x" (capcode 2 adds the delete token's second
    fd row)."""
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                normalize_string="none", using_capcode=capcode, level=5,
                reset_token_ids=True)
    return v


def test_junction_without_shared_state_falls_back():
    """Chains that stay out of phase: "x" then a run of "a" with tokens
    "aa" and "a" puts lane 0's tokens at odd offsets and every other lane's
    at even ones, so no junction finds a shared state.  Given the text,
    the tokenizer repairs the junctions on the device (a lane of the
    text's own chain replaces the lanes after the last that holds it), as
    the trainer does, and nothing falls back.  The repair starts from the
    first pass's record grids: the text runs once, then once a repair."""
    v = _run_vocab()
    data = b"x" + b"a" * 3000
    tk = GpuTokenizer(v, chunk=64, device="cpu")
    passes = []
    run_staged = tk._run_staged
    tk._run_staged = lambda *a: passes.append(1) or run_staged(*a)
    ids, missing = tk.tokenize(data)
    assert tk.fallbacks == {"missing_byte": 0}
    assert tk.last_mode == "fast" and 1 <= tk.repairs <= 8
    assert len(passes) == 1 + tk.repairs
    nids, nmiss = native_ids(v, data)
    np.testing.assert_array_equal(ids, nids)
    assert missing == nmiss == 0
    jids, jmiss = TpuTokenizer(v, chunk=64).tokenize(data)
    np.testing.assert_array_equal(ids, np.asarray(jids, np.uint32))


@pytest.mark.parametrize("capcode", [0, 2])
def test_junctions_repaired_across_dispatches(capcode):
    """Lanes of 32 bytes: a run of "a" through three dispatches fails every
    junction, bridge lanes included (capcode 2: on both fd rows); repaired
    on the device in a few dozen repairs, no fallback, the ids equal
    native's."""
    v = _run_vocab(capcode)
    data = b"x" + b"a" * 40000 + b"xaaxa" * 20
    tk = GpuTokenizer(v, chunk=32, device="cpu")
    assert len(tk._plan(len(data))[1]) == 3
    ids, missing = tk.tokenize(data)
    assert tk.host_fallbacks == 0 and 3 <= tk.repairs <= 30
    nids, nmiss = native_ids(v, data)
    np.testing.assert_array_equal(ids, nids)
    assert missing == nmiss == 0


def test_splice_past_the_first_16_records():
    """Runs of 119 "a" between "x" and "y" (tokens "aa", "a", "x", "y"):
    a lane that starts inside a run stays out of phase with its left
    neighbour until the run ends, up to 59 records in but within the
    128-byte overlap.  The port searches every record and splices there;
    the JAX package's 16-record probe misses some of these junctions.  No
    fallback, ids exact."""
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x", b"y"], charset=1,
                normalize_string="none", using_capcode=0, level=5,
                reset_token_ids=True)
    data = (b"x" + b"a" * 119 + b"y") * 40
    tk = GpuTokenizer(v, chunk=256, device="cpu")
    ids, missing = tk.tokenize(data)
    assert tk.fallbacks == {"missing_byte": 0}
    assert tk.last_mode == "fast"
    nids, nmiss = native_ids(v, data)
    np.testing.assert_array_equal(ids, nids)
    assert missing == nmiss == 0
    _n, lanes, bufs = tk.stage(data)
    buf, n, last_lane = bufs[0]
    ctl, tok = decide(match(buf, n, tk.tables), None, buf, n, tk.tables)
    recs, _toks, _done = follow(ctl, tok, n, 256, lanes, OVERLAP_SCAN,
                                tk._t_rec(False))
    assert bool(stitch.stitched_keep(recs, 0, last_lane, True)[3])
    assert not bool(jstitch.stitched_keep(
        jnp.asarray(recs.numpy().view(np.uint32)), jnp.int32(0),
        jnp.int32(last_lane), jnp.bool_(True))[3])


def test_zero_advance_step_equals_native():
    """An fd-1 alternative that is the virtual space alone advances 0
    bytes (o, D, " ", u, t on "out\xc2", unk vocabulary): ids equal native
    and the host oracle, on the device path.  The JAX device path, which
    clamps every advance to one byte, parts from native here."""
    v = zero_step_vocab(unk=True)
    data = ZERO_STEP_TEXT
    tk = GpuTokenizer(v, chunk=64, device="cpu")
    ids, missing = tk.tokenize(data)
    assert tk.last_mode == "fast" and tk.host_fallbacks == 0
    nids, nmiss = native_ids(v, data)
    np.testing.assert_array_equal(ids, nids)
    want, wmiss = host_tokenize(v, data)
    np.testing.assert_array_equal(ids, np.asarray(want, np.uint32))
    assert missing == nmiss == wmiss == 30
    step = [v.reverse.index(t) for t in (b"o", b"D", b" ", b"u", b"t")]
    assert list(ids[:5]) == step
    jids, _jmiss = TpuTokenizer(v, chunk=64).tokenize(data)
    assert not np.array_equal(np.asarray(jids, np.uint32), nids)


def test_full_window_overflow_raises(monkeypatch):
    """The full window holds one record per scanned byte, so a lane that
    overflows it is a kernel fault: it raises, never falls back."""
    v = VOCABS["capcode"]()
    data = text_for("capcode", v, 3000, seed=11, misses=False)
    tk = GpuTokenizer(v, chunk=2048, device="cpu")
    monkeypatch.setattr(tk, "_t_rec", lambda full: 128)
    with pytest.raises(RuntimeError, match="full record window"):
        tk.tokenize(data)
    assert tk.host_fallbacks == 0


def test_silent_record_without_missing_byte_raises(monkeypatch):
    """A kept record that emits nothing where the text has no byte the
    vocabulary lacks (here: an unk vocabulary) is a kernel fault."""
    v = VOCABS["unk"]()
    data = text_for("unk", v, 2000, seed=10, misses=True)

    def no_emit(*args):
        out = stitch.device_stitch_compact(*args)
        return (*out[:4], torch.zeros((), dtype=torch.bool), out[5])

    tk = GpuTokenizer(v, chunk=64, device="cpu")
    monkeypatch.setattr(scan, "device_stitch_compact", no_emit)
    with pytest.raises(RuntimeError, match="emitted no token"):
        tk.tokenize(data)
    assert tk.host_fallbacks == 0


def test_realtext_32000_equals_native():
    v = realtext_vocab(32000)
    rng = np.random.default_rng(12)
    words = ENGLISH.split(b" ")
    raw = b" ".join(words[i] for i in rng.integers(0, len(words), 1500))
    data = normalize_and_capcode(raw, v.using_capcode, v.normalizer)
    tk = GpuTokenizer(v, chunk=256, device="cpu")
    ids, missing = tk.tokenize(data)
    assert tk.last_mode == "fast" and tk.host_fallbacks == 0
    nids, nmiss = native_ids(v, data)
    np.testing.assert_array_equal(ids, nids)
    assert missing == nmiss == 0
    assert len(ids) > 1000


def test_empty_and_tiny():
    v = VOCABS["capcode"]()
    tk = GpuTokenizer(v, chunk=64, device="cpu")
    ids, missing = tk.tokenize(b"")
    assert len(ids) == 0 and missing == 0
    ids, missing = tk.tokenize(b" hello")
    want, wmiss = host_tokenize(v, b" hello")
    np.testing.assert_array_equal(ids, np.asarray(want, np.uint32))
    assert missing == wmiss
