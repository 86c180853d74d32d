"""The tokenizer's chain as the card runs it, on the CPU: each dispatch's
valid bytes, last lane and final flag as device scalars (``Staged.scalars``)
through the stitch, the narrow finishing (``ops/finish.py``: the concat at
running offsets, u16 or 24-bit ids, the delete bitmask and its host
expansion), the grouping of a text into captured chains of up to
``MAX_FUSED_DISPATCHES`` dispatches, and one metadata read a text.
Against the JAX package's stitch stages (interpret mode) and its
``TpuTokenizer._meta_concat_fns``, ``resolve_device``, the host-int
stitch and native.  Tolerance 0: every word and id is an integer.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_chain.py -q
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenmonster_tpu.ops import stitch as jstitch
from tokenmonster_tpu.ops.pallas_stitch import (device_stitch_compact,
                                                make_compact_kernel)
from tokenmonster_tpu.ops.scan import DeviceVocab, TpuTokenizer
from tokenmonster_tpu_torch.ops import finish, scan, stitch
from tokenmonster_tpu_torch.ops.decide import resolve_device
from tokenmonster_tpu_torch.ops.scan import GpuTokenizer

from torch_cases import (VOCABS, native_ids, text_for, u32, wide_tables,
                         wide_words)

CHUNK, LANES = 32, 64          # dispatches of 64 lanes: 2,016 bytes each
TEXT = 5500                    # three dispatches
DISPATCHES = {"first": 0, "middle": 1, "last": 2}

# one interpreted compact kernel for the one geometry every case has
_compact_kernel = functools.lru_cache(make_compact_kernel)


def _tokenizer(name):
    v = VOCABS[name]()
    return v, GpuTokenizer(v, chunk=CHUNK, device="cpu")


@pytest.fixture(scope="module", params=sorted(VOCABS))
def chained(request):
    """A three-dispatch text of each vocabulary run through the chain on
    device scalars: per dispatch its records, token words, record skip,
    scalars and compact outputs."""
    name = request.param
    v, tk = _tokenizer(name)
    data = text_for(name, v, TEXT, seed=11, misses=name != "utf16")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scan, "MAX_LANES", LANES)
        staged = tk.stage(data)
        assert staged.lanes == LANES and len(staged.bufs) == 3
        seen = []

        def recording(recs, toks, buf, start0, last_lane, final):
            seen.append((recs, toks, start0, last_lane, final))
            return tk._compact(recs, toks, buf, start0, last_lane, final)
        outs = tk._run_staged(staged, False, tk.tables, recording, {})
    return name, v, tk, staged, seen, outs


def _host_ints(staged, d, start0):
    """Dispatch d's scalars as the host ints the stitch took before."""
    _buf, _n, last_lane = staged.bufs[d]
    return int(start0), last_lane, d == len(staged.bufs) - 1


@pytest.mark.parametrize("which", sorted(DISPATCHES))
def test_stitched_keep_on_device_scalars(chained, which):
    """stitched_keep on a dispatch's device scalars (0-dim int32 tensors,
    read by tensor arithmetic) equals it on the host ints and the JAX
    stage (every splice of these texts lies within the right lane's first
    16 records, which the JAX stage probes, ``SYNC_PROBE``; the port
    searches them all)."""
    _name, _v, _tk, staged, seen, _outs = chained
    d = DISPATCHES[which]
    recs, _toks, start0, last_lane, final = seen[d]
    assert last_lane.dim() == 0 and last_lane.dtype == torch.int32
    assert int(final) == (d == 2)
    got = stitch.stitched_keep(recs, start0, last_lane, final)
    s0, lr, fin = _host_ints(staged, d, start0)
    assert int(last_lane) == lr
    old = stitch.stitched_keep(recs, s0, lr, fin)
    for g, o in zip(got, old):
        assert torch.equal(g.long(), o.long())
    want = jstitch.stitched_keep(jnp.asarray(u32(recs)), jnp.int32(s0),
                                 jnp.int32(lr), jnp.bool_(fin),
                                 want_ranges=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("which", sorted(DISPATCHES))
def test_stitch_compact_on_device_scalars(chained, which):
    """device_stitch_compact on the device scalars equals it on the host
    ints and the JAX stage with the interpreted compact kernel."""
    _name, _v, tk, staged, seen, outs = chained
    d = DISPATCHES[which]
    recs, toks, start0, last_lane, final = seen[d]
    T, L = recs.shape
    got = stitch.device_stitch_compact(recs, toks, start0, last_lane, final,
                                       T * L)
    s0, lr, fin = _host_ints(staged, d, start0)
    old = stitch.device_stitch_compact(recs, toks, s0, lr, fin, T * L)
    for g, o in zip(got, old):
        assert torch.equal(g, o)
    assert torch.equal(got[0], outs[d][0])
    r, t = u32(recs), u32(toks)
    toks_aug = t | (((r >> 2) & 1) << 22)
    want = device_stitch_compact(
        jnp.asarray(r), jnp.asarray(toks_aug.T.copy()).reshape(
            L * (T // 128), 128),
        jnp.int32(s0), jnp.int32(lr), jnp.bool_(fin),
        _compact_kernel(L, T, T * L // 128, interpret=True), T * L)
    np.testing.assert_array_equal(u32(got[0]), np.asarray(want[0]))
    for w, g in zip(want[1:], got[1:5]):
        assert int(g) == int(w)


def _jax_finish(v, outs, wide: bool):
    """The JAX package's metadata fetch and concat (``_meta_concat_fns``)
    on the port's compact outputs: (meta (3k,), ids, delete bits)."""
    dv = DeviceVocab.build(v)
    reverse = range(70000) if wide else v.reverse
    host = types.SimpleNamespace(
        _finalize={}, engine="pallas", dv=dv,
        vocab=types.SimpleNamespace(reverse=reverse))
    k = len(outs)
    meta_fn, concat_fn = TpuTokenizer._meta_concat_fns(host, k,
                                                       outs[0][0].numel())
    meta = meta_fn([jnp.int32(int(o[1])) for o in outs],
                   [jnp.int32(int(o[2])) for o in outs],
                   [jnp.bool_(bool(o[3])) for o in outs])
    parts = concat_fn([jnp.asarray(u32(o[0])) for o in outs],
                      jnp.asarray(np.array([int(o[1]) for o in outs],
                                           np.int32)))
    return (np.asarray(meta), np.asarray(parts[0]),
            np.asarray(parts[1]) if len(parts) > 1 else None)


def _resolved(outs, tabs):
    """``resolve_device`` on the concatenated kept words: the ids."""
    words = torch.cat([o[0][:int(o[1])] for o in outs])
    return resolve_device(words, tabs).numpy().astype(np.uint32)


@pytest.mark.parametrize("wide", [False, True])
def test_finish_equals_resolve_and_jax(chained, wide):
    """The narrow finishing of the three dispatches (u16 ids, or 24-bit
    packed ones; the delete bitmask where the vocabulary has a delete
    token) equals the JAX ``_meta_concat_fns`` outputs on the same words,
    and its host expansion equals ``resolve_device``."""
    name, v, tk, _staged, _seen, outs = chained
    meta, ids, bits = finish.finish(outs, tk.tables, wide)
    k = len(outs)
    assert meta.shape == (5, k) and meta.dtype == torch.int32
    assert ids.dtype == (torch.uint8 if wide else torch.int16)
    assert (bits is not None) == tk.tables.has_delete
    for j, o in enumerate(outs):
        assert [int(x) for x in meta[:, j]] == [
            int(o[1]), int(o[2]), int(o[3]), int(o[4]), int(o[5])]
    total = int(meta[0].sum())
    jmeta, jids, jbits = _jax_finish(v, outs, wide)
    np.testing.assert_array_equal(meta[:3].reshape(-1).numpy(), jmeta)
    width = 3 if wide else 1
    np.testing.assert_array_equal(
        ids.numpy()[:total * width].view(np.uint8 if wide else np.uint16),
        jids[:total * width])
    if bits is not None:
        nb = -(-total // 8)
        np.testing.assert_array_equal(bits.numpy()[:nb], jbits[:nb])
    host = finish.host_ids(ids.numpy(), None if bits is None
                           else bits.numpy(), total,
                           tk.tables.delete_token)
    if bool(meta[2].all()):         # every kept record emits
        np.testing.assert_array_equal(host, _resolved(outs, tk.tables))
    if name == "realtext1024":      # forward-delete branches taken
        assert bits.any(), "no delete marker in the text"


def _moved_outs(outs, off: int, S: int):
    """The compact outputs (S = 20 words) as a vocabulary of more than
    ``off`` entries has them at S: ``torch_cases.wide_words`` on each
    word, the delete marker moved from bit 22 to bit S + 2."""
    moved = []
    for o in outs:
        w = o[0].long() & 0xFFFFFFFF
        has_tok = (w != 0).to(torch.int32) << 7
        tok = wide_words(has_tok, (w & 0x3FFFFF).to(torch.int32), off, S)
        dele = ((w >> 22) & 1) << (S + 2)
        moved.append((((tok.long() & 0xFFFFFFFF) | dele).to(torch.int32),
                      *o[1:]))
    return moved


@pytest.mark.parametrize("chained", ["realtext1024", "unk"], indirect=True)
@pytest.mark.parametrize("S", [21, 22, 23, 24])
def test_finish_past_65536_ids(chained, S):
    """More than 65,536 ids: the words at S = 21-24 on tables whose
    indices are moved up by 2^20 (``torch_cases.wide_tables``) and whose
    ids are moved up by 2^(S - 1), so the ids themselves take 17-24 bits
    and the delete token too: 24-bit packed ids and the bitmask at bit
    S + 2 expand on the host to ``resolve_device``'s ids."""
    name, _v, tk, _staged, _seen, outs = chained
    off, id_off = 1 << 20, 1 << (S - 1)
    tabs = wide_tables(tk.tables, off, S)
    ids3 = tabs.ids3.long()
    tabs.ids3 = torch.where(torch.arange(len(ids3))[:, None] >= off,
                            ids3 + id_off, ids3).to(torch.int32)
    tabs.delete_token = tk.tables.delete_token + id_off
    moved = _moved_outs(outs, off, S)
    meta, ids, bits = finish.finish(moved, tabs, True)
    total = int(meta[0].sum())
    host = finish.host_ids(ids.numpy(), None if bits is None
                           else bits.numpy(), total, tabs.delete_token)
    want = _resolved(moved, tabs)
    np.testing.assert_array_equal(host, want)
    assert (want >= 65536).any() and want.max() < 1 << 24
    assert (bits is not None) == (name == "realtext1024")
    if bits is not None:
        assert (host == tabs.delete_token).any()


def test_concat_at_running_offsets():
    """Each dispatch's first count words land at the running offset of
    the counts before it; zero from the total on; an empty dispatch
    holds no slot."""
    words = torch.arange(1, 25, dtype=torch.int32).reshape(4, 6)
    counts = torch.tensor([2, 0, 6, 3], dtype=torch.int32)
    got = finish.concat(words, counts).tolist()
    assert got == [1, 2, 13, 14, 15, 16, 17, 18, 19, 20, 21] + [0] * 13


def test_host_ids_expand_the_delete_bitmask():
    """The bitmask's marked ids get the delete token inserted after them,
    as the JAX package's ``np.insert`` does; 24-bit ids unpack."""
    ids = torch.tensor([5, 70000, 9, (1 << 24) - 1, 3], dtype=torch.int64)
    marks = torch.tensor([1, 0, 0, 1, 0, 0, 0, 0], dtype=torch.int32)
    words = marks << 22
    bits = finish.delete_bits(words, 20).numpy()
    got = finish.host_ids(finish.narrow(ids, True).numpy(), bits, 5, 7)
    assert got.tolist() == [5, 7, 70000, 9, (1 << 24) - 1, 7, 3]
    small = finish.narrow(torch.tensor([0, 65535, 40000]), False).numpy()
    assert finish.host_ids(small, None, 3, 0).tolist() == [0, 65535, 40000]


class _EagerGraph(scan._Graph):
    """A stand-in for a captured graph on the CPU: its replay runs the
    captured body again on the inputs as they stand."""

    def capture(self, body, stream):
        self.body, self.launches = body, {}

    def replay(self):
        return self.body(self.text, self.scalars, self.start0)


@pytest.mark.parametrize("name", ["capcode", "plain"])
def test_groups_of_captured_chains(monkeypatch, name):
    """A text of more dispatches than a graph holds replays the graphs
    group by group (here groups of 2: 2, 2 and 1 of five dispatches), the
    record skip carried from one group to the next: its metadata and ids
    equal the chain run op by op and native's (a vocabulary with a delete
    token and one without).  A text of another length with the same group
    sizes captures nothing more."""
    monkeypatch.setattr(scan, "MAX_LANES", LANES)
    monkeypatch.setattr(scan, "MAX_FUSED_DISPATCHES", 2)
    monkeypatch.setattr(scan, "_Graph", _EagerGraph)
    v, tk = _tokenizer(name)
    for size in (9000, 10050):
        data = text_for(name, v, size, seed=size, misses=False)
        staged = tk.stage(data)
        assert len(staged.bufs) == 5
        meta, parts, grids = tk._run_captured(staged)
        emeta, eparts, egrids = tk._run_eager(staged)
        assert [kg for _i, _b, kg in parts] == [2, 2, 1]
        assert torch.equal(meta, emeta) and len(grids) == len(egrids) == 5
        counts = meta[0].numpy()
        ids = tk._download(parts, counts)
        np.testing.assert_array_equal(ids, tk._download(eparts, counts))
        np.testing.assert_array_equal(ids, native_ids(v, data)[0])
        assert tk.captures == 2
    assert sorted(tk._graphs) == [(LANES, 1, False), (LANES, 2, False)]


@pytest.mark.parametrize("name", ["capcode", "unk"])
def test_one_metadata_read_a_text(monkeypatch, name):
    """A text that holds reads its metadata once and its ids once (the
    ids and their bitmask in one wait); the ids equal native's."""
    monkeypatch.setattr(scan, "MAX_LANES", LANES)
    v, tk = _tokenizer(name)
    data = text_for(name, v, TEXT, seed=12, misses=name == "unk")
    reads = []
    read = tk._read
    monkeypatch.setattr(tk, "_read", lambda ts: reads.append(len(ts))
                        or read(ts))
    ids, missing = tk.tokenize(data)
    assert tk.last_mode == "fast" and tk.repairs == 0
    assert reads == [1, 2 if tk.tables.has_delete else 1]
    nids, nmiss = native_ids(v, data)
    np.testing.assert_array_equal(ids, nids)
    assert missing == nmiss
