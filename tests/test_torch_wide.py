"""The wide token word on the CPU (the plain kernel versions), tolerance
0: what a vocabulary of 2^20 to 2^21 - 2 entries takes through decide,
follow, compact, id resolution and the device route of ``load``.

Token words are ``idx | w3 << S`` with S = 21 there
(``ops/tables.py::w3_shift``).  The JAX package's Pallas stages keep S =
20 and serve only vocabularies below 2^20 entries; above, the JAX package
tokenizes on its XLA decision engine (``tokenmonster_tpu/ops/scan.py:
512-518``).  So each stage is held against the JAX Pallas stage (interpret
mode) field by field, each word unpacked at its own shift, on tables whose
dictionary indices are moved up by 2^20 (``torch_cases.wide_tables``: bit
20 of every index set), and the slice against ``TpuTokenizer(engine=
"decision")`` and the port's native tokenizer, with ``tables.MAX_ENTRIES``
lowered so that a small vocabulary takes S = 21, as
``tests/test_torch_train.py`` lowers it.  ``tests/test_torch_wide24.py``
does the same at S = 22 to 24 and placement fields of 22 to 24 bits.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tokenmonster_tpu
import tokenmonster_tpu_torch
from tokenmonster_tpu.ops import pallas_decide
from tokenmonster_tpu.ops.pallas_decide import make_decide_kernel
from tokenmonster_tpu.ops.pallas_match import make_match_kernel
from tokenmonster_tpu.ops.pallas_stitch import (device_stitch_compact,
                                                make_compact_kernel)
from tokenmonster_tpu.ops.scan import TpuTokenizer
from tokenmonster_tpu_torch.native import NativeVocab
from tokenmonster_tpu_torch.ops import tables
from tokenmonster_tpu_torch.ops import stitch as tstitch
from tokenmonster_tpu_torch.ops.decide import decide, resolve_device
from tokenmonster_tpu_torch.ops.follow import follow

from torch_cases import (ENGLISH, EXAMPLES, OVERLAP, VOCABS, WIDE_OFFSET,
                         hashmatch_tables, port_ctl, realtext_vocab, text_for,
                         u32, wide_matches, wide_tables)

N = 2048
CHUNK, L, T_REC = 32, 128, 256


def _fields(words, S):
    """(idx, w3) of token words (any int array) packed at shift ``S``."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    return w & ((1 << S) - 1), (w >> S) & 3


def _match(v, tabs, buf, n):
    """The JAX match words of ``buf`` as int32 tensors (mb None without a
    delete token), and the JAX arrays the JAX decide takes."""
    jm = make_match_kernel(tabs, interpret=True)(jnp.asarray(buf), n)
    if tabs.has_space:
        m, mb = (torch.from_numpy(np.array(a).view(np.int32)) for a in jm)
        return m, mb, (jm[0], jm[1])
    return torch.from_numpy(np.array(jm).view(np.int32)), None, (jm,)


@pytest.mark.parametrize("off", [0, WIDE_OFFSET])
@pytest.mark.parametrize("name", ["capcode", "unk", "utf16"])
def test_decide_at_s21_equals_jax_kernel(name, off):
    """ctl bit for bit; tok's idx and w3 fields, unpacked at 21 and at
    20, equal, each dictionary index moved up by ``off`` (a literal id is
    not)."""
    v = VOCABS[name]()
    tabs = hashmatch_tables(v)
    dt = tables.upload_tables(v, tabs, "cpu")
    assert dt.w3_shift == 20
    wide = wide_tables(dt, off)
    data = text_for(name, v, N - 200, seed=1)
    buf = np.zeros(N, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    n = len(data)
    m, mb, jargs = _match(v, tabs, buf, n)
    want = make_decide_kernel(v, interpret=True)(*jargs, jnp.asarray(buf),
                                                 n)
    ctl, tok = decide(wide_matches(m, off), wide_matches(mb, off),
                      torch.from_numpy(buf), n, wide)
    np.testing.assert_array_equal(u32(ctl),
                                  port_ctl(want[0], want[1], dt.meta.numpy()))
    idx, w3 = _fields(u32(tok), 21)
    j_idx, j_w3 = _fields(np.asarray(want[1]), 20)
    np.testing.assert_array_equal(w3, j_w3)
    lit = j_w3 == 3
    found = (torch.stack([m, mb]) if mb is not None else m).numpy() != 0
    np.testing.assert_array_equal(idx[~lit], j_idx[~lit] + off * found[~lit])
    if dt.has_unk:
        np.testing.assert_array_equal(idx[lit], j_idx[lit])
    assert (w3 >= 2).any()               # bit 22 of the word is set
    if off:
        assert (idx >= 1 << 20).any()


CASES = {
    # name, text bytes, start0, last_lane, final
    "final": ("capcode", L * CHUNK - 90, 0, None, True),
    "chained": ("realtext1024", L * CHUNK + 400, 3, L - 2, False),
    "miss_no_unk": ("realtext1024", L * CHUNK - 10, 0, None, True),
    "unk": ("unk", L * CHUNK - 40, 0, None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_follow_compact_resolve_at_s21_equal_jax(case):
    """Decisions at S = 21 with every index moved past 2^20, followed,
    compacted and resolved, against the 20-bit path: the same records;
    token words whose fields, unpacked each at its shift, are equal; the
    JAX compact kernel's output (interpret mode) field for field, the
    delete marker at bit 23 where the JAX word has it at 22; and the same
    emitted ids as the JAX ``resolve_tokens``."""
    name, n_bytes, start0, last_lane, final = CASES[case]
    v = VOCABS[name]()
    tabs = hashmatch_tables(v)
    dt = tables.upload_tables(v, tabs, "cpu")
    wide = wide_tables(dt)
    data = text_for(name, v, min(n_bytes, 6144 - 600), seed=4,
                    misses=case in ("miss_no_unk", "unk"))
    buf = torch.zeros(6144, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    n = len(data)
    m, mb, _ = _match(v, tabs, buf.numpy(), n)
    if last_lane is None:
        last_lane = -(-n // CHUNK) - 1
    narrow = follow(*decide(m, mb, buf, n, dt), n, CHUNK, L, OVERLAP, T_REC)
    got = follow(*decide(wide_matches(m), wide_matches(mb), buf, n, wide),
                 n, CHUNK, L, OVERLAP, T_REC, 21)
    assert torch.equal(got[0], narrow[0]) and int(got[2]) == 1
    recs = narrow[0]
    live = (u32(recs) & 0xF) != 0
    idx, w3 = _fields(u32(got[1]), 21)
    j_idx, j_w3 = _fields(u32(narrow[1]), 20)
    np.testing.assert_array_equal(w3, j_w3)
    moved = live & (j_w3 != 3)
    np.testing.assert_array_equal(idx[moved], j_idx[moved] + WIDE_OFFSET)
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
                                        final, out_cap, 21)
    for w, g in zip(want[1:], out[1:5]):
        assert int(g) == int(w)
    count = int(out[1])
    o, jo = u32(out[0]).astype(np.int64), np.asarray(want[0]).astype(np.int64)
    np.testing.assert_array_equal(o[count:], 0)
    np.testing.assert_array_equal(jo[count:], 0)
    o, jo = o[:count], jo[:count]
    np.testing.assert_array_equal((o >> 23) & 1, (jo >> 22) & 1)
    idx, w3 = _fields(o & ~(1 << 23), 21)
    j_idx, j_w3 = _fields(jo & ~(1 << 22), 20)
    np.testing.assert_array_equal(w3, j_w3)
    np.testing.assert_array_equal(idx[w3 != 3], j_idx[w3 != 3] + WIDE_OFFSET)
    if bool(out[4]):                     # every kept record emits
        ids = resolve_device(out[0][:count], wide).numpy()
        np.testing.assert_array_equal(
            ids, pallas_decide.resolve_tokens(v, jo.astype(np.uint32)))
        if case == "unk":
            assert (ids == v.unk_token).any()
        if name == "realtext1024":       # forward-delete branches taken
            assert ((o >> 23) & 1).any() and (ids == v.delete_token).any()


def _raw_text(size: int, seed: int, misses: bool = True) -> bytes:
    """Raw (unnormalized) English and code, seeded, with a few control
    bytes no test vocabulary has where ``misses``."""
    rng = np.random.default_rng(seed)
    words = ENGLISH.split(b" ")
    parts = [words[i] for i in rng.integers(0, len(words), size // 4)]
    for at in rng.integers(0, len(parts), 4 if misses else 0):
        parts[at] += b"\x01\x02"
    return b" ".join(parts)[:size]


def _vocab_path(which: str, tmp_path) -> str:
    """A ``.vocab`` file: an example's, or a test vocabulary's with an
    unk token (``unk``: capcode 0; ``unk32000``: the 32,000-id example,
    which has a delete token)."""
    if which.startswith("realtext"):
        return os.path.join(EXAMPLES, f"realtext-{which[8:]}-fast.vocab")
    v = VOCABS["unk"]() if which == "unk" else realtext_vocab(32000)
    if which != "unk":
        assert v.enable_unk_token()
    path = str(tmp_path / f"{which}.vocab")
    v.save(path)
    return path


def _device_ids(path, monkeypatch, limit, text):
    """``load(path, device="cpu", route="device")`` with MAX_ENTRIES at
    ``limit`` (None: the vocabulary's size): the ids of ``text`` and the
    vocabulary."""
    v = tokenmonster_tpu_torch.load(path, device="cpu", route="device")
    monkeypatch.setattr(tables, "MAX_ENTRIES",
                        limit or len(v._core.tokens))
    ids = v.tokenize(text)
    tk = v._tpu
    assert tk.tables.w3_shift == 21
    assert tk.host_fallbacks == 0 and tk.last_mode in ("fast", "full")
    assert v.last_route == "device"
    assert v.route_counts == {"device": 1, "native": 0}
    return ids.astype(np.int64), v


def _reference_ids(path, v, text):
    """The JAX package's XLA decision engine and the port's native
    tokenizer on the same normalized text."""
    normalized = v._core.normalize(text)
    core = tokenmonster_tpu.load(path)._core
    jax_ids = TpuTokenizer(core, engine="decision").tokenize(normalized)[0]
    native = NativeVocab(v._core).tokenize(normalized)[0]
    return jax_ids.astype(np.int64), native.astype(np.int64)


@pytest.mark.parametrize("which", ["realtext1024", "realtext32000", "unk"])
def test_device_route_at_s21_equals_jax_and_native(which, monkeypatch,
                                                   tmp_path):
    """The slice on the CPU: ``load(..., route="device")`` of a vocabulary
    at the (lowered) limit tokenizes at S = 21, no host fallback, ids
    equal to the JAX package's decision engine and to native."""
    path = _vocab_path(which, tmp_path)
    text = _raw_text(20000, seed=3, misses=which == "unk")
    ids, v = _device_ids(path, monkeypatch, None, text)
    jax_ids, native = _reference_ids(path, v, text)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_array_equal(ids, native)
    if which == "unk":
        assert (ids == v._core.unk_token).any()


def test_literal_ids_above_the_limit_round_trip(monkeypatch, tmp_path):
    """Unk and delete ids at or above the (lowered) limit go through the
    literal and delete fields of the wide words: the ids hold both, equal
    to the JAX decision engine's and native's, and decode as native's
    do."""
    path = _vocab_path("unk32000", tmp_path)
    probe = tokenmonster_tpu_torch.load(path, device="cpu")
    unk, dele = probe._core.unk_token, probe._core.delete_token
    text = _raw_text(20000, seed=5)
    ids, v = _device_ids(path, monkeypatch, min(unk, dele), text)
    assert (ids == unk).any() and (ids == dele).any()
    jax_ids, native = _reference_ids(path, v, text)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_array_equal(ids, native)
    assert v.decode(ids) == probe.decode(native)


def test_placement_limit_raises_on_device_and_routes_auto_to_native(
        monkeypatch):
    """A vocabulary of more entries than a placement holds (the kernels'
    index fields narrowed here from their 24 bits): "auto" takes native,
    decided from its size and counted, with no device tokenizer built;
    "device" raises, naming the index fields' width."""
    path = os.path.join(EXAMPLES, "realtext-1024-fast.vocab")
    ref = tokenmonster_tpu.load(path)
    v = tokenmonster_tpu_torch.load(path, device="cpu")
    n = len(v._core.tokens)
    monkeypatch.setattr(tables, "ID_BITS", n.bit_length() - 1)
    assert tables.placement_limit() < n
    monkeypatch.setattr(v, "TPU_THRESHOLD", 16)
    text = _raw_text(6000, seed=2, misses=False).decode()
    for k in (1, 2):
        np.testing.assert_array_equal(v.tokenize(text), ref.tokenize(text))
        assert v.last_route == "native"
        assert v.route_counts == {"device": 0, "native": k}
    assert v._tpu is None
    v.route = "device"
    with pytest.raises(NotImplementedError, match="index fields"):
        v.tokenize(text)
    assert v.route_counts == {"device": 0, "native": 2}
