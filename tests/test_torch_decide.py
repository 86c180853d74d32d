"""Decide stage: tokenmonster_tpu_torch.ops.decide.decide_plain against
the JAX Pallas kernel (interpret mode) on the same match words, bit for bit
at all N positions (tolerance 0), and resolve_tokens against its original.
Covers one fd row (capcode 0), two rows (delete token), unk, and lil_off 1
and 2 (UTF-16).  Where the port advances 0 bytes and the JAX kernel 1 (an
fd-1 alternative that is the virtual space alone), the JAX words are
compared as the port writes them (``torch_cases.port_ctl``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenmonster_tpu.ops import pallas_decide
from tokenmonster_tpu.ops.pallas_decide import make_decide_kernel
from tokenmonster_tpu.ops.pallas_match import make_match_kernel
from tokenmonster_tpu_torch.ops.decide import decide, resolve_device
from tokenmonster_tpu_torch.ops.tables import upload_tables

from torch_cases import VOCABS, hashmatch_tables, port_ctl, text_for

N = 2048


@pytest.mark.parametrize("name", sorted(VOCABS))
def test_decide_equals_jax_kernel(name):
    v = VOCABS[name]()
    tabs = hashmatch_tables(v)
    dt = upload_tables(v, tabs, "cpu")
    data = text_for(name, v, N - 200, seed=1)
    buf = np.zeros(N, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    n = len(data)
    jm = make_match_kernel(tabs, interpret=True)(jnp.asarray(buf), n)
    jd = make_decide_kernel(v, interpret=True)
    text = torch.from_numpy(buf)
    if tabs.has_space:
        m, mb = (np.array(a) for a in jm)
        want = jd(jm[0], jm[1], jnp.asarray(buf), n)
        got = decide(torch.from_numpy(m.view(np.int32)),
                     torch.from_numpy(mb.view(np.int32)), text, n, dt)
        assert got[0].shape == (2, N)
    else:
        m = np.array(jm)
        want = jd(jm, jnp.asarray(buf), n)
        got = decide(torch.from_numpy(m.view(np.int32)), None, text, n, dt)
        assert got[0].shape == (N,)
    want = (port_ctl(want[0], want[1], dt.meta.numpy()), want[1])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))
    ctl = got[0].numpy()
    if name != "utf16":
        miss = (ctl & (1 << 9)) != 0
        assert miss.any()
        assert ((ctl[miss] & (1 << 7)) != 0).all() == (name == "unk")
    if name in ("utf16", "realtext1024"):
        assert ((ctl[0] & (1 << 8)) != 0).any(), "no forward-delete branch"


@pytest.mark.parametrize("name", ["capcode", "unk"])
def test_resolve_device_equals_resolve_tokens(name):
    v = VOCABS[name]()
    rng = np.random.default_rng(2)
    n_tok = len(v.tokens)
    idx = rng.integers(0, n_tok, 500).astype(np.uint32)
    w3 = rng.integers(0, 4, 500).astype(np.uint32)
    words = idx | (w3 << 20)
    lit = w3 == 3
    words[lit] = (3 << 20) | rng.integers(0, 2 ** 20, lit.sum()) \
        .astype(np.uint32)
    if v.delete_token != 0xFFFFFF:
        words[rng.random(500) < 0.2] |= np.uint32(1 << 22)
    dt = upload_tables(v, hashmatch_tables(v), "cpu")
    got = resolve_device(torch.from_numpy(words.view(np.int32)), dt)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  pallas_decide.resolve_tokens(v, words))
