"""The trainer scorer's stages with a candidate's masked superset tables,
against the JAX package (interpret mode) and the native scorer, bit for
bit (tolerance 0: every output is an integer):

- the masked-table copies (``ops/tables.py``) against ``pallas_match``'s
  ``flat_tables``/``smem_scalars``/``_single_tbl`` with ``alive``, and the
  candidate state against ``train/score_helpers.py``'s in REMAP mode;
- port match on ``CandidateTables`` against the JAX kernel given
  ``tabs=`` and ``space_empty=``, and port decide on the match words
  mapped through ``rank`` against the JAX kernel given the same words and
  the candidate's planes (its advances read as the port writes them,
  ``port_ctl``), and against port match and decide on tables built from
  the candidate alone;
- ``device_stitch_score`` against ``ops/stitch.py``'s;
- ``GpuCandidateScorer(device="cpu")`` on the pool and strips of
  ``tests/test_pallas_scorer.py`` against the JAX ``CandidateScorer``'s
  Pallas path and the native scorer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode
from tokenmonster_tpu.ops import pallas_match
from tokenmonster_tpu.ops import stitch as jstitch
from tokenmonster_tpu.ops.pallas_decide import make_decide_kernel
from tokenmonster_tpu.ops.pallas_match import make_match_kernel
from tokenmonster_tpu.train import score_helpers as jhelpers
from tokenmonster_tpu.train.trainvocab import CandidateScorer
from tokenmonster_tpu_torch.ops import tables as ttab
from tokenmonster_tpu_torch.ops.decide import decide
from tokenmonster_tpu_torch.ops.follow import follow
from tokenmonster_tpu_torch.ops.match import match
from tokenmonster_tpu_torch.ops.scan import remap_matches
from tokenmonster_tpu_torch.ops.stitch import device_stitch_score
from tokenmonster_tpu_torch.train import score_helpers
from tokenmonster_tpu_torch.train.trainvocab import GpuCandidateScorer

from torch_cases import (OVERLAP, VOCABS, candidate, decisions, drop_sets,
                         hashmatch_tables, native_score,
                         port_ctl, text_for, u32, with_unk)
from torch_cases import jax_native  # noqa: F401 (autouse fixture)


N = 2048        # one JAX tile grain
KINDS = ["capcode", "plain", "unk", "utf16"]


def _alive(n, seed):
    return np.random.default_rng(seed).random(n) < 0.7


@pytest.mark.parametrize("name", sorted(VOCABS))
def test_masked_tables_equal_jax(name):
    v = VOCABS[name]()
    tabs = hashmatch_tables(v)
    alive = _alive(len(v.tokens), len(name))
    want = pallas_match.flat_tables(tabs, alive)
    got = ttab.flat_tables(tabs, alive)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.dtype == np.asarray(w).dtype
    np.testing.assert_array_equal(ttab.smem_scalars(tabs, alive),
                                  pallas_match.smem_scalars(tabs, alive))
    np.testing.assert_array_equal(
        ttab.single_tbl(tabs.single, alive),
        np.asarray(pallas_match._single_tbl(tabs.single, alive)))
    # masking changes the tables (the test would pass vacuously otherwise)
    assert not np.array_equal(got[2 * len(tabs.classes)],
                              ttab.flat_tables(tabs)[2 * len(tabs.classes)])


def _prepared(name):
    """(port scorer, JAX fast-path state, candidate) for a torch_cases
    vocabulary as the superset and its second drop set."""
    unk = name == "unk"
    v = VOCABS[name]()
    tokens = list(v.tokens)
    cls = with_unk(GpuCandidateScorer) if unk else GpuCandidateScorer
    sc = cls(v.charset, v.using_capcode, v.normalizer.flag, device="cpu")
    sc.set_specials([])
    sc.prepare(tokens)
    sup = sc._sup
    pal = {"v_sup": sup.vocab, "tabs": sup.hashmatch, "remap": True,
           "has_delete": sup.vocab.delete_token != 0xFFFFFF,
           "sup_index": sup.index}
    cand = candidate(sc, tokens, drop_sets(v, 5)[1], unk)
    return sc, pal, cand


@pytest.fixture(scope="module", params=KINDS)
def masked(request):
    name = request.param
    sc, pal, cand = _prepared(name)
    ctabs = score_helpers.candidate_runtime_state(sc._sup, cand)
    return name, sc, pal, cand, ctabs


def test_candidate_state_equals_jax(masked):
    """The candidate's uploaded tables are the JAX helper's arrays in REMAP
    mode: the masked match tables, its rank, and the live prefix of its
    planes and ids3 (the JAX package pads their rows to a power of two,
    zeros past the prefix)."""
    _name, _sc, pal, cand, ctabs = masked
    tabs_args, se, planes, bb, ids3f, del_tok, rank = \
        jhelpers.candidate_runtime_state(pal, cand)
    np.testing.assert_array_equal(ctabs.rank.numpy(), np.asarray(rank))
    n_cls = len(pal["tabs"].classes)
    fields = np.concatenate([np.asarray(a).reshape(-1)
                             for a in tabs_args[:n_cls]])
    np.testing.assert_array_equal(ctabs.fields.numpy(), fields)
    np.testing.assert_array_equal(ctabs.single.numpy(),
                                  np.asarray(tabs_args[2 * n_cls]).ravel())
    if ctabs.has_space:
        np.testing.assert_array_equal(
            ctabs.space_single.numpy(),
            np.asarray(tabs_args[2 * n_cls + 1]).ravel())
    np.testing.assert_array_equal(ctabs.scalars.numpy(), se)
    planes = np.asarray(planes).reshape(2, -1)
    n_c, w = len(cand.tokens), ctabs.meta.shape[1]
    assert w == ttab.meta_width(n_c)
    np.testing.assert_array_equal(ctabs.meta.numpy(), planes[:, :w])
    assert not planes[:, w:].any()
    assert torch.equal(ctabs.entries, ttab.decide_entries(
        torch.tensor(planes[:, :w]), ctabs.entries.shape[0]))
    np.testing.assert_array_equal(ctabs.bb.numpy(),
                                  np.asarray(bb).reshape(-1))
    ids3f = np.asarray(ids3f).reshape(-1, 3)
    np.testing.assert_array_equal(ctabs.ids3.numpy().view(np.uint32),
                                  ids3f[:n_c])
    assert not ids3f[n_c:].any()
    assert ctabs.delete_token == del_tok


def test_masked_match_decide_equal_jax_and_candidate(masked):
    name, sc, pal, cand, ctabs = masked
    v_sup = pal["v_sup"]
    data = text_for(name, v_sup, N - 200, seed=2)
    buf = np.zeros(N, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    n = len(data)
    text = torch.from_numpy(buf)
    tabs_args, se, planes, bb, _ids3f, _del, rank = \
        jhelpers.candidate_runtime_state(pal, cand)

    jm = make_match_kernel(pal["tabs"], interpret=True)(
        jnp.asarray(buf), n, tabs=tabs_args, space_empty=se)
    jm = jm if ctabs.has_space else (jm,)
    got_m = match(text, n, ctabs)
    got_m = got_m if ctabs.has_space else (got_m,)
    for g, w in zip(got_m, jm):
        np.testing.assert_array_equal(u32(g), np.asarray(w))
    # REMAP: the JAX package maps the words through rank (jnp.take, as in
    # parallel/score.py) and decides on the candidate's planes
    jr = [jnp.where(w == 0, w, (jnp.take(rank, (w >> 6).astype(jnp.int32))
                                .astype(jnp.uint32) << 6) | (w & 63))
          for w in jm]
    got_r = [remap_matches(g, ctabs.rank) for g in got_m]
    for g, w in zip(got_r, jr):
        np.testing.assert_array_equal(u32(g), np.asarray(w))
    jd = make_decide_kernel(v_sup, interpret=True)
    mb = got_r[1] if ctabs.has_space else None
    if ctabs.has_space:
        want_d = jd(jr[0], jr[1], jnp.asarray(buf), n, planes, bb)
    else:
        want_d = jd(jr[0], jnp.asarray(buf), n, planes, bb)
    got_d = decide(got_r[0], mb, text, n, ctabs)
    want_d = (port_ctl(want_d[0], want_d[1], ctabs.meta.numpy()), want_d[1])
    for g, w in zip(got_d, want_d):
        np.testing.assert_array_equal(u32(g), np.asarray(w))

    # the same words as on the candidate's own tables
    own = ttab.upload_tables(cand, hashmatch_tables(cand), "cpu")
    own_m = match(text, n, own)
    own_m = own_m if own.has_space else (own_m,)
    for g, o in zip(got_r, own_m):
        assert torch.equal(g, o)
    own_d = decide(own_m[0], own_m[1] if own.has_space else None, text, n,
                   own)
    assert torch.equal(got_d[0], own_d[0])
    assert torch.equal(got_d[1], own_d[1])
    if name != "utf16":
        assert ((u32(got_d[0]) & (1 << 9)) != 0).any(), "no missing byte"


CASES = {
    # name, text bytes, start0, last_lane, final
    "final": ("capcode", 128 * 32 - 90, 0, None, True),
    "chained": ("realtext1024", 128 * 32 + 400, 3, 126, False),
    "miss_no_unk": ("realtext1024", 128 * 32 - 10, 0, None, True),
    "unk": ("unk", 128 * 32 - 40, 0, None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_stitch_score_equals_jax(case):
    """Records of 128 lanes of 32 bytes, ids resolved through ids3."""
    name, n_bytes, start0, last_lane, final = CASES[case]
    chunk, L, t_rec = 32, 128, 256
    ctl, tok, n = decisions(name, min(n_bytes, 6144 - 600), 6144,
                            misses=case in ("miss_no_unk", "unk"))
    recs, toks, done = follow(ctl, tok, n, chunk, L, OVERLAP, t_rec)
    assert int(done) == 1
    if last_lane is None:
        last_lane = -(-n // chunk) - 1
    v = VOCABS[name]()
    ids3 = ttab.ids3(v).reshape(-1).astype(np.int64)
    t = u32(toks).astype(np.int64)
    at = np.clip((t & 0xFFFFF) * 3 + np.minimum((t >> 20) & 3, 2), 0,
                 len(ids3) - 1)
    emit = ids3[at].astype(np.uint32)
    text = text_for(name, v, min(n_bytes, 6144 - 600), seed=4,
                    misses=case in ("miss_no_unk", "unk"))
    buf = np.zeros(6144, np.uint8)
    buf[:len(text)] = np.frombuffer(text, np.uint8)
    n_ids = len(v.reverse)
    del_tok = int(v.delete_token) & 0xFFFFFF
    want = jstitch.device_stitch_score(
        jnp.asarray(u32(recs)), jnp.asarray(emit), jnp.asarray(buf),
        jnp.int32(start0), jnp.int32(last_lane), jnp.bool_(final), n_ids,
        chunk, delete_token=del_tok)
    got = device_stitch_score(recs, torch.from_numpy(emit.view(np.int32)),
                              torch.from_numpy(buf), start0, last_lane,
                              final, n_ids, chunk, del_tok)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3]) and bool(got[4]) == bool(want[4])
    assert bool(got[4]) and got[0].sum() > 0
    if case in ("miss_no_unk", "unk"):
        assert got[2].sum() > 0


POOL = [b" the", b"the", b" quick", b" brown", b" fox", b" jump",
        b"jumps", b" over", b" lazy", b" dog", b"ing", b"er", b" hello",
        b"hello", b" world", b" of", b" and", b" to", b"s ", b"e ",
        b"  ", b"\n", b" a"]
SINGLES = [bytes([c]) for c in b"abcdefghijklmnoqrstuvwxzDWC. ;:!,"]


def _pool_strips():
    """The strips of tests/test_pallas_scorer.py (one with bytes the
    pool lacks) and an empty one."""
    v = Vocab()
    v._generate(tokens=POOL + SINGLES, charset=1, normalize_string="none",
                using_capcode=2, level=5, reserve=8, reset_token_ids=True)
    seed = (b"The quick brown fox jumps over the lazy dog and the world. "
            b"Hello world of jumping dogs; lazy foxes doze over the hills. ")
    corpus = normalize_and_capcode(seed * 120, 2, v.normalizer)
    cuts = [0, 1371, 1371 + 2999, 1371 + 2999 + 4093]
    out = [bytes(corpus[cuts[i]:cuts[i + 1]]) for i in range(len(cuts) - 1)]
    out.append(bytes(corpus[cuts[-1]:cuts[-1] + 2001]) + b"\xf7\xfe"
               + bytes(corpus[:400]))
    return v, out + [b""]


def test_scorer_equals_jax_pallas_and_native():
    """Several drop sets of the pool: the port, the JAX Pallas scorer
    (interpret mode, one shared placement) and the native scorer agree."""
    v, strips = _pool_strips()
    jsc = CandidateScorer(1, 2, v.normalizer.flag, backend="tpu")
    jsc.set_specials([])
    assert jsc.prepare_pallas(POOL + SINGLES)
    sc = GpuCandidateScorer(1, 2, v.normalizer.flag, device="cpu")
    sc.set_specials([])
    sc.prepare(POOL + SINGLES, hashmatch_tables=jsc._pal["tabs"])
    for drops in ([], [b" quick", b"the", b" hello"],
                  [b" the", b"ing", b"er", b" of", b" to", b"  "]):
        cand = sc.build([t for t in POOL if t not in drops] + SINGLES)
        s, n_tok, miss = sc.score(cand, strips)
        js, jt, jm = jsc.score(cand, strips)
        ns, nt, nm = native_score(cand, strips)
        assert s.dtype == np.int64 and s.shape == (len(cand.reverse),)
        np.testing.assert_array_equal(s, np.asarray(js))
        np.testing.assert_array_equal(s, ns)
        assert n_tok == jt == nt, drops
        assert miss == jm == nm == {0xF7, 0xFE}, drops
    assert jsc.tpu_compiles == 1       # every JAX score took the fast path
    assert sc.repairs == 0
