"""Match stage: tokenmonster_tpu_torch.ops.match.match_plain against the
JAX Pallas kernel (interpret mode) and the host prober, bit for bit
(tolerance 0: the outputs are integer words)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenmonster_tpu.ops.hashmatch import (build_hashmatch,
                                            host_longest_space_match)
from tokenmonster_tpu.ops.pallas_match import (make_match_kernel,
                                               reference_match)
from tokenmonster_tpu_torch.ops.match import match
from tokenmonster_tpu_torch.ops.tables import upload_tables

from torch_cases import VOCABS, hashmatch_tables, text_for

N = 2048   # one JAX tile grain


def _both(tabs, dt, buf, n, jfn=None):
    jfn = jfn or make_match_kernel(tabs, interpret=True)
    want = jfn(jnp.asarray(buf), n)
    got = match(torch.from_numpy(buf), n, dt)
    if tabs.has_space:
        return ([np.asarray(w) for w in want],
                [g.numpy().view(np.uint32) for g in got])
    return [np.asarray(want)], [got.numpy().view(np.uint32)]


def _reference_space(tabs, data):
    out = np.zeros(len(data), np.uint32)
    for p in range(len(data)):
        idx, length = host_longest_space_match(tabs, data, p)
        if length:
            out[p] = (idx << 6) | length
    return out


@pytest.fixture(scope="module", params=sorted(VOCABS))
def prepared(request):
    v = VOCABS[request.param]()
    tabs = hashmatch_tables(v)
    return (request.param, v, tabs, upload_tables(v, tabs, "cpu"),
            make_match_kernel(tabs, interpret=True))


@pytest.mark.parametrize("kind", ["text", "random"])
def test_match_equals_jax_kernel(prepared, kind):
    """English/code text and random bytes; ``n`` ends mid-buffer with live
    bytes after it, so matches that would run past ``n`` are cut there."""
    name, v, tabs, dt, jfn = prepared
    rng = np.random.default_rng(11)
    if kind == "text":
        buf = np.frombuffer(text_for(name, v, N, seed=3), np.uint8).copy()
    else:
        buf = rng.integers(0, 256, N).astype(np.uint8)
    n = N - 301
    want, got = _both(tabs, dt, buf, n, jfn)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    data = bytes(buf[:n])
    np.testing.assert_array_equal(got[0][:n], reference_match(tabs, data))
    if tabs.has_space:
        np.testing.assert_array_equal(got[1][:n],
                                      _reference_space(tabs, data))


def test_match_overflow_keys():
    """Keys whose full 32-bit hash collides take the direct-compare
    overflow probes (the pair found in a training pool)."""
    keys = [b" the", b"the", b"D ncate", b"D recti", b" ", b"a", b"e",
            b"ncate", b"recti", b"D r"]
    tabs = build_hashmatch(keys, space_prefix=b" ")
    assert sum(len(c.ovf_keys) for c in tabs.classes) == 1

    class _V:   # the few vocabulary fields DeviceTables reads
        tokens = keys
        delete_token = 1
        unk_token = 0xFFFFFF
        charset = 1
        n = len(keys)
        flag = nwords = np.zeros(n, np.uint8)
        index1 = index2 = np.zeros(n, np.uint32)
        len1 = len2 = np.zeros(n, np.int32)
        id = id1 = id2 = np.arange(n, dtype=np.uint32)
        begin_byte = np.zeros(256, np.uint8)

    dt = upload_tables(_V, tabs, "cpu")
    data = b"the D ncateD recti a theD r ncate recti" * 3
    buf = np.zeros(N, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    want, got = _both(tabs, dt, buf, len(data))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (got[0] >> 6 == 3).any() and (got[0] >> 6 == 2).any()
