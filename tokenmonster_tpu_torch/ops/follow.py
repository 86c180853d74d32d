"""Chain-follow the decision table per speculative chunk lane.

Port of ``tokenmonster_tpu/ops/pallas_follow.py::make_follow_kernel`` with
the contract of ``ops/decision.py::follow_lanes(packed=True)``: lane l
starts at (l * chunk, fd = 0) and follows the decisions (ctl, tok) of its
current fd row through ``chunk + overlap`` bytes, one record per step:
  rec = (pos << 4) | fd' | has_tok<<1 | has_del<<2 | miss<<3
  tok = the token word, its low S + 2 bits (S = ``w3_shift``, 20 to 24;
        at 20 these are the 22 bits the JAX kernel's packed word
        ``ctl | tok << 10`` keeps)
has_del is written as fd': decide sets the two bits together.  Steps
after a lane finishes are zero.  ``done_all`` is 1 iff every lane
finished within ``t_rec`` steps (the stitch's record-window check).

The kernel is ``follow_kernel`` in ``csrc/tm_kernels.cu``: each block
copies the windows of a few lanes (``tmk::follow_pack(ctl, tok)`` of
every fd row: ctl without has_del, and the token word, in one u32 up to S
= 21 and one u64 above) into shared memory and one thread per lane walks its chain there, tile by
tile when a window exceeds the shared memory (per-lane steps
``tmk::follow_walk`` in ``csrc/tm_kernels.cuh``).  Any lane count works
(the JAX kernel's 128..512 lanes in multiples of 128 is a TPU layout
rule).
"""

from __future__ import annotations

import torch

from . import _build
from .tables import W3_SHIFT, check_w3_shift


def window(chunk: int, overlap: int) -> int:
    """A lane's readable span past its start (the JAX kernel's W)."""
    return -(-(chunk + overlap + 128) // 128) * 128


def follow_plain(ctl: torch.Tensor, tok: torch.Tensor, n, chunk: int,
                 n_lanes: int, overlap: int, t_rec: int,
                 w3_shift: int = W3_SHIFT):
    """PyTorch version of the follow kernel.  ``ctl``/``tok``: int32 (N,)
    or (2, N); ``n``: an int or a 0-dim tensor.  Returns (recs, toks)
    int32 (t_rec, n_lanes) and done_all int32 scalar."""
    dev = ctl.device
    rows = 1 if ctl.dim() == 1 else ctl.shape[0]
    N = ctl.shape[-1]
    W = window(chunk, overlap)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    ctls = torch.cat([ctl.long().reshape(-1), zero])
    tokens = torch.cat([tok.long().reshape(-1)
                        & ((1 << (w3_shift + 2)) - 1), zero])
    start = torch.arange(n_lanes, device=dev, dtype=torch.int64) * chunk
    stop = (n - start).clamp(-1, chunk + overlap)
    done = stop <= 0
    pos_rel = torch.zeros_like(start)
    fd = torch.zeros_like(start)
    recs = torch.zeros((t_rec, n_lanes), dtype=torch.int64, device=dev)
    toks = torch.zeros_like(recs)
    for t in range(t_rec):
        if bool(done.all()):
            break          # later rows stay zero
        q = start + pos_rel.clamp(max=W - 1)
        row = fd if rows > 1 else torch.zeros_like(fd)
        at = torch.where(q < N, row * N + q, rows * N)
        w = ctls[at]
        new_rel = pos_rel + (w & 63)
        new_fd = (w >> 6) & 1
        live = ~done
        rec = (((start + new_rel) << 4) | new_fd | (((w >> 7) & 1) << 1)
               | (new_fd << 2) | (((w >> 9) & 1) << 3))
        recs[t] = torch.where(live, rec, 0)
        toks[t] = torch.where(live, tokens[at], 0)
        done = done | (new_rel >= stop)
        pos_rel = torch.where(live, new_rel, pos_rel)
        fd = torch.where(live, new_fd, fd)
    done_all = done.all().to(torch.int32)
    return recs.to(torch.int32), toks.to(torch.int32), done_all


def follow(ctl: torch.Tensor, tok: torch.Tensor, n, chunk: int,
           n_lanes: int, overlap: int, t_rec: int, w3_shift: int = W3_SHIFT):
    """Per-lane record and token streams: the CUDA kernel for CUDA
    tensors, the plain version for CPU ones.  ``n``: valid bytes, an int
    or a 0-dim int32 tensor on their device; ``w3_shift``: the tables'
    S, which sets how many bits of each token word follow keeps."""
    N = ctl.shape[-1]
    if not isinstance(n, torch.Tensor) and not 0 <= n <= N:
        raise ValueError(f"n={n} outside [0, {N}]")
    if ctl.dim() not in (1, 2) or (ctl.dim() == 2 and ctl.shape[0] > 2):
        raise ValueError(f"ctl: shape {tuple(ctl.shape)}, expected (N,) "
                         "or (rows <= 2, N)")
    check_w3_shift(w3_shift)
    if ctl.device.type == "cpu":
        return follow_plain(ctl, tok, n, chunk, n_lanes, overlap, t_rec,
                            w3_shift)
    dev = ctl.device
    _build.check(ctl, "ctl", torch.int32, dev)
    _build.check(tok, "tok", torch.int32, dev, tuple(ctl.shape))
    n_t = _build.scalar_arg(n, "n", N, dev)
    recs = torch.empty((t_rec, n_lanes), dtype=torch.int32, device=dev)
    toks = torch.empty_like(recs)
    done = torch.ones(1, dtype=torch.int32, device=dev)
    args = _build.FollowArgs(
        ctl=ctl.data_ptr(), tok=tok.data_ptr(), recs=recs.data_ptr(),
        toks=toks.data_ptr(), done_all=done.data_ptr(), n=n_t.data_ptr(),
        N=N, rows=1 if ctl.dim() == 1 else ctl.shape[0], chunk=chunk,
        overlap=overlap, W=window(chunk, overlap), L=n_lanes, t_rec=t_rec,
        w3_shift=w3_shift)
    _build.launch("follow", args, dev)
    return recs, toks, done[0]
