"""The port's copies of the JAX package's table helpers equal the originals,
and DeviceTables carries them unchanged (tokenmonster_tpu_torch/ops/
tables.py against ops/pallas_match.py and ops/pallas_decide.py)."""

import numpy as np
import pytest

from tokenmonster_tpu.ops import pallas_decide, pallas_match
from tokenmonster_tpu_torch.ops import hashmatch as hm
from tokenmonster_tpu_torch.ops import tables as ttab

from torch_cases import VOCABS, hashmatch_tables


@pytest.fixture(scope="module", params=sorted(VOCABS))
def case(request):
    v = VOCABS[request.param]()
    return v, hashmatch_tables(v)


def test_flat_tables_equal(case):
    v, tabs = case
    want = pallas_match.flat_tables(tabs)
    got = ttab.flat_tables(tabs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.dtype == np.asarray(w).dtype


def test_smem_scalars_equal(case):
    _v, tabs = case
    np.testing.assert_array_equal(ttab.smem_scalars(tabs),
                                  pallas_match.smem_scalars(tabs))


def test_meta_planes_and_ids3_equal(case):
    v, _tabs = case
    planes, bb = ttab.build_meta_planes(v)
    w_planes, w_bb = pallas_decide.build_meta_planes(v)
    np.testing.assert_array_equal(planes, w_planes)
    np.testing.assert_array_equal(bb, w_bb)
    ids = ttab.ids3(v)
    assert ids.dtype == np.uint32
    np.testing.assert_array_equal(ids[:, 0], v.id)
    np.testing.assert_array_equal(ids[:, 2], v.id2)


def test_device_tables_carry_the_arrays(case):
    """DeviceTables holds the same numbers as the JAX tables: each class's
    composed planes at its descriptor's offset, the singles, the scalars,
    the meta planes and begin-byte."""
    v, tabs = case
    dt = ttab.upload_tables(v, tabs, "cpu")
    flat = pallas_match.flat_tables(tabs)
    n_cls = len(tabs.classes)
    desc = dt.desc.numpy()
    for ci, c in enumerate(tabs.classes):
        planes = np.asarray(flat[ci]).reshape(-1)
        off = desc[ci, ttab.D_FOFF]
        np.testing.assert_array_equal(
            dt.fields.numpy()[off:off + planes.size], planes)
        # the packed words of the displacement plane, without its padding
        dp = np.asarray(flat[n_cls + ci]).reshape(-1)
        words = -(-max(2, 1 << c.b_bits) // 2)
        assert not dp[words:].any()
        doff = desc[ci, ttab.D_DOFF]
        np.testing.assert_array_equal(dt.disp.numpy()[doff:doff + words],
                                      dp[:words])
        assert dt.len_cls[c.length] == ci
        assert desc[ci, ttab.D_S] == c.S
        assert (int(desc[ci, ttab.D_SALT]) & 0xFFFFFFFF) == c.salt
    np.testing.assert_array_equal(dt.single.numpy(),
                                  np.asarray(flat[2 * n_cls]).reshape(-1))
    np.testing.assert_array_equal(dt.scalars.numpy(),
                                  pallas_match.smem_scalars(tabs))
    planes, bb = pallas_decide.build_meta_planes(v)
    np.testing.assert_array_equal(dt.meta.numpy(), planes.reshape(2, -1))
    np.testing.assert_array_equal(dt.bb.numpy(), bb.reshape(-1))
    assert dt.has_delete == (v.delete_token != 0xFFFFFF)
    assert dt.lil_off == (2 if v.charset == 2 else 1)
    assert dt.disp.numel() == sum(-(-max(2, 1 << c.b_bits) // 2)
                                  for c in tabs.classes)


def test_key_filter_holds_every_key(case):
    """The match kernel skips a length with either filter bit clear, so
    both bits of every key of every class must be set; most others are
    clear."""
    v, tabs = case
    words, log2 = ttab.key_filter(tabs)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    assert len(bits) == 1 << log2 and 5 <= log2 <= ttab.FILTER_MAX_LOG2
    n_keys = 0
    for c in tabs.classes:
        keys = [bytes(k) for k in c.slot_keys[c.occupied]] + list(c.ovf_keys)
        for k in keys:
            x1 = (((int(hm.poly_hash(k)) + c.length * ttab.FILTER_LEN_MULT)
                   * ttab.FILTER_MULT) & 0xFFFFFFFF)
            x2 = ((x1 ^ (x1 >> 15)) * ttab.FILTER_MULT2) & 0xFFFFFFFF
            assert bits[x1 >> (32 - log2)] and bits[x2 >> (32 - log2)], k
        n_keys += len(keys)
    assert 0 < bits.sum() <= 2 * n_keys
    if len(bits) >= 16 * n_keys:
        assert bits.mean() <= 1 / 8
