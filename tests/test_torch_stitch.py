"""Stitch stage: the port's stitched_keep against ops/stitch.py's, and its
stitch + compact (plain compact) against ops/pallas_stitch.py::
device_stitch_compact with the interpreted compact kernel.  Bit for bit
(tolerance 0): a final dispatch, a chained one (start0 > 0, final=False)
and a missing byte in a vocabulary without unk (sync_ok = False)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenmonster_tpu.ops import stitch as jstitch
from tokenmonster_tpu.ops.pallas_stitch import (device_stitch_compact,
                                                make_compact_kernel)
from tokenmonster_tpu_torch.ops import stitch as tstitch
from tokenmonster_tpu_torch.ops.follow import follow

from torch_cases import OVERLAP, decisions, u32

CHUNK, L, T_REC = 32, 128, 256


def _records(name, n_bytes, misses):
    ctl, tok, n = decisions(name, n_bytes, 6144, misses)
    recs, toks, done = follow(ctl, tok, n, CHUNK, L, OVERLAP, T_REC)
    assert int(done) == 1
    return recs, toks, n


CASES = {
    # name, text bytes, start0, last_lane, final
    "final": ("capcode", L * CHUNK - 90, 0, None, True),
    "chained": ("realtext1024", L * CHUNK + 400, 3, L - 2, False),
    "miss_no_unk": ("realtext1024", L * CHUNK - 10, 0, None, True),
    "unk": ("unk", L * CHUNK - 40, 0, None, True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, n_bytes, start0, last_lane, final = CASES[request.param]
    recs, toks, n = _records(name, min(n_bytes, 6144 - 600),
                             misses=request.param in ("miss_no_unk", "unk"))
    if last_lane is None:
        last_lane = -(-n // CHUNK) - 1
    return request.param, recs, toks, start0, last_lane, final


def test_stitched_keep_equal(case):
    _name, recs, _toks, start0, last_lane, final = case
    want = jstitch.stitched_keep(jnp.asarray(u32(recs)), jnp.int32(start0),
                                 jnp.int32(last_lane), jnp.bool_(final),
                                 want_ranges=True)
    got = tstitch.stitched_keep(recs, start0, last_lane, final)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def test_stitch_compact_equal(case):
    name, recs, toks, start0, last_lane, final = case
    out_cap = T_REC * L
    compact_fn = make_compact_kernel(L, T_REC, out_cap // 128,
                                     interpret=True)
    r, t = u32(recs), u32(toks)
    toks_aug = t | (((r >> 2) & 1) << 22)
    toksT = jnp.asarray(toks_aug.T.copy()).reshape(L * (T_REC // 128), 128)
    want = device_stitch_compact(
        jnp.asarray(r), toksT, jnp.int32(start0), jnp.int32(last_lane),
        jnp.bool_(final), compact_fn, out_cap)
    got = tstitch.device_stitch_compact(recs, toks, start0, last_lane, final,
                                        out_cap)
    np.testing.assert_array_equal(u32(got[0]), np.asarray(want[0]))
    assert len(want) == 5 and len(got) == 6
    for w, g in zip(want[1:], got[1:5]):
        assert int(g) == int(w)
    assert bool(got[4]) == (name != "miss_no_unk")
    assert bool(got[5])             # every junction syncs in these cases
    if name == "unk":
        assert int(got[2]) > 0      # misses counted, emitted as unk
    jax.clear_caches()


def test_splice_at_a_state_after_an_in_place_step():
    """A step from fd 1 to fd 0 that keeps its position (the decide's
    zero-byte advance) sits before the shared state: the left lane holds
    (4, 0), (7, 1), (7, 0), (9, 0), (12, 0), the right lane, from byte 6,
    (7, 0), (9, 0), ...  The splice is the first shared state, (7, 0)."""
    tok, dele, fd = 2, 4, 1
    left = [(4 << 4) | tok, (7 << 4) | tok | dele | fd, (7 << 4) | tok,
            (9 << 4) | tok, (12 << 4) | tok]
    right = [(7 << 4) | tok, (9 << 4) | tok, (12 << 4) | tok,
             (14 << 4) | tok, 0]
    recs = torch.tensor([left, right], dtype=torch.int32).T.contiguous()
    _f, keep, _sn, ok, start_rec, end_rec = tstitch.stitched_keep(
        recs, 0, 1, True)
    assert bool(ok)
    assert start_rec.tolist() == [0, 1] and end_rec.tolist() == [2, 3]
    assert int(keep.sum()) == 6


def test_restart_point(case):
    """Where every splice holds there is nothing to restart; where lane 1
    stays out of phase with lane 0, the chain restarts at lane 0's last
    record with fd 0 before its last record, at or after its own splice."""
    _name, recs, _toks, start0, last_lane, final = case
    assert tstitch.restart_point(recs, start0, last_lane, final) is None
    tok, dele, fd = 2, 4, 1
    lanes = [[(1 << 4) | tok, (3 << 4) | tok, (5 << 4) | tok,
              (7 << 4) | tok | dele | fd, (9 << 4) | tok],
             [(6 << 4) | tok, (8 << 4) | tok, (10 << 4) | tok, 0, 0],
             [(10 << 4) | tok, (12 << 4) | tok, 0, 0, 0]]
    grid = torch.tensor(lanes, dtype=torch.int32).T.contiguous()
    assert tstitch.restart_point(grid, 0, 2, True) == (0, 5, 0)
    assert tstitch.restart_point(grid, 3, 2, True) == (0, 5, 0)
    with pytest.raises(RuntimeError, match="no record with fd 0"):
        tstitch.restart_point(grid, 4, 2, True)
