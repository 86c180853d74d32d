"""Follow stage: tokenmonster_tpu_torch.ops.follow.follow_plain against the
JAX Pallas follow kernel (interpret mode, 128 lanes, one and two decision
rows via build_lane_windows) and, at other lane counts, against
ops/decision.py::follow_lanes(packed=True) cut to t_rec.  Bit for bit
(tolerance 0), the record-window overflow (done_all = 0) included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenmonster_tpu.ops.decision import follow_lanes
from tokenmonster_tpu.ops.pallas_follow import (build_lane_windows,
                                                make_follow_kernel)
from tokenmonster_tpu_torch.ops.follow import follow

from torch_cases import OVERLAP, decisions, u32


@pytest.mark.parametrize("name,t_rec", [("plain", 256), ("capcode", 256),
                                        ("realtext1024", 16)])
def test_follow_equals_jax_kernel(name, t_rec):
    """128 lanes of 32 bytes; t_rec 16 overflows the record window."""
    chunk, L = 32, 128
    ctl, tok, n = decisions(name, L * chunk - 50, 6144)
    two = ctl.dim() == 2
    words = jnp.asarray(u32(ctl)) | (jnp.asarray(u32(tok)) << 10)
    jfn = make_follow_kernel(chunk, L, OVERLAP, t_rec, two_rows=two,
                             interpret=True)
    w_recs, w_toks, w_done = jfn(
        build_lane_windows(words, chunk, L, OVERLAP), n)
    recs, toks, done = follow(ctl, tok, n, chunk, L, OVERLAP, t_rec)
    np.testing.assert_array_equal(u32(recs), np.asarray(w_recs))
    np.testing.assert_array_equal(u32(toks), np.asarray(w_toks))
    assert int(done) == int(w_done) == (0 if t_rec == 16 else 1)


@pytest.mark.parametrize("name,L,chunk", [("capcode", 8, 64),
                                          ("unk", 100, 16),
                                          ("utf16", 3, 256)])
def test_follow_any_lane_count(name, L, chunk):
    """Lane counts the JAX kernel does not take, against follow_lanes."""
    n_bytes = L * chunk - 7
    ctl, tok, n = decisions(name, n_bytes, -(-(n_bytes + 400) // 2048)
                             * 2048)
    t_rec = -(-(chunk * 3 // 8 + OVERLAP + 64) // 128) * 128
    c2, t2 = (ctl, tok) if ctl.dim() == 2 else (torch.stack([ctl, ctl]),
                                                  torch.stack([tok, tok]))
    w_recs, w_toks, t_final = follow_lanes(
        jnp.asarray(u32(c2)), jnp.asarray(u32(t2)), n, chunk, L, OVERLAP,
        packed=True)
    recs, toks, done = follow(ctl, tok, n, chunk, L, OVERLAP, t_rec)
    w_recs = np.asarray(w_recs)[:t_rec]
    w_toks = np.asarray(w_toks)[:t_rec]
    rows = min(t_rec, w_recs.shape[0])
    np.testing.assert_array_equal(u32(recs)[:rows], w_recs[:rows])
    assert not u32(recs)[rows:].any()
    # follow_lanes leaves the token word of a finished lane unmasked
    live = w_recs[:rows] != 0
    np.testing.assert_array_equal(u32(toks)[:rows][live], w_toks[live])
    assert not u32(toks)[:rows][~live].any()
    assert int(done) == int(int(t_final) <= t_rec) == 1
