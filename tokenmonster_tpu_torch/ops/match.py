"""Longest dictionary match at every byte: M(p) and, for delete-token
vocabularies, Mb(p).

Port of ``tokenmonster_tpu/ops/pallas_match.py::make_match_kernel``.  The
kernel is ``match_kernel`` in ``csrc/tm_kernels.cu`` (text tiles and the
small tables in shared memory, a key filter before each hash-table probe;
per-position body ``tmk::match_window`` in ``csrc/tm_kernels.cuh``);
``match_plain`` is the same function in PyTorch, written after the JAX
kernel (packed text windows, masked field compares, every length probed).

Output words: ``(idx << 6) | len``, 0 = no match.  ``Mb(p)`` is the longest
match of the virtual space plus ``text[p:]``, its length counting the space
(the ``lilbuf`` probe contract, go/tokenmonster.go:1029-1036).  Matches end
at or before ``n``; positions from ``n`` to ``N`` are computed too (the
bare space token still matches there), as in the JAX kernel.
"""

from __future__ import annotations

import torch

from . import _build
from .hashmatch import C1, C2, SEED, key_masks
from .tables import D_DOFF, D_FOFF, D_STRIDE, DeviceTables

M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x < 2^32 in int64, without overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def match_plain(text: torch.Tensor, n, tabs: DeviceTables):
    """PyTorch version of the match kernel.  ``text``: uint8 [N]; ``n``:
    an int or a 0-dim tensor.  Returns int32 [N] M, or (M, Mb) when the
    tables carry the space-stripped entries."""
    N = text.numel()
    dev = text.device
    has_space = tabs.has_space
    n_idx = 2 if has_space else 1
    idx1 = tabs.idx1_bits
    ib = idx1 * n_idx
    imask = (1 << idx1) - 1
    lil = tabs.lil_off
    t = torch.zeros(N + tabs.max_len + 1, dtype=torch.int64, device=dev)
    t[:N] = text
    pos = torch.arange(N, device=dev)
    fields = tabs.fields.long() & M32
    disp = tabs.disp.long() & M32
    scalars = tabs.scalars.long()

    b0 = t[:N]
    fits1 = pos + 1 <= n
    s1 = tabs.single.long()[b0]
    best = torch.where((s1 > 0) & fits1, ((s1 - 1) << 6) | 1, 0)
    bestb = None
    if has_space:
        se = scalars[0]
        bestb = torch.where(se > 0, ((se - 1) << 6) | lil, 0).expand(N)
        sp = tabs.space_single.long()[b0]
        bestb = torch.where((sp > 0) & fits1, ((sp - 1) << 6) | (1 + lil),
                            bestb)

    by_len = {c.length: (ci, c) for ci, c in enumerate(tabs.classes)}
    ovf_scalar = 1
    ovf_base = {}
    for c in tabs.classes:
        ovf_base[c.length] = ovf_scalar
        ovf_scalar += len(c.ovf_keys) * n_idx
    desc = tabs.desc.cpu()

    h = torch.full((N,), int(SEED), dtype=torch.int64, device=dev)
    wf: list[torch.Tensor] = []    # text windows packed like the key bits
    for l in range(1, tabs.max_len + 1):
        b = t[l - 1:l - 1 + N]
        h = (h * 257 + b) & M32
        h = h ^ (h >> 11)
        bit = ib + 8 * (l - 1)
        f, off = bit >> 5, bit & 31
        while len(wf) <= f + 1:
            wf.append(torch.zeros(N, dtype=torch.int64, device=dev))
        wf[f] = (wf[f] + (b << off)) & M32
        if off > 24:
            wf[f + 1] = wf[f + 1] + (b >> (32 - off))
        got = by_len.get(l)
        if got is None:
            continue
        ci, c = got
        S = c.S
        if c.b_bits:
            bucket = _mul32(h, int(C1)) >> (32 - c.b_bits)
        else:
            bucket = torch.zeros_like(h)
        y = _mul32(h ^ c.salt, int(C2))
        g = torch.zeros_like(h)
        for k, sign in c.scale:
            g = g + sign * (y >> (32 - k))
        g = g.clamp(0, S - 1)
        d32 = disp[int(desc[ci, D_DOFF]) + (bucket >> 1)]
        d = torch.where((bucket & 1) != 0, d32 >> 16, d32) & 0xFFFF
        slot = g + d
        slot = torch.where(slot >= S, slot - S, slot)
        f_off, stride = int(desc[ci, D_FOFF]), int(desc[ci, D_STRIDE])
        gotf = [fields[f_off + j * stride + slot] for j in range(c.n_fields)]
        kmask = key_masks(l, n_idx, idx1)
        mism = torch.zeros(N, dtype=torch.bool, device=dev)
        for j, km in enumerate(kmask):
            if km:
                mism |= ((gotf[j] ^ wf[j]) & km) != 0
        guard = pos + l <= n
        hit = ~mism & guard
        idx_m = gotf[0] & imask
        best = torch.where(hit & (idx_m > 0), ((idx_m - 1) << 6) | l, best)
        if has_space:
            sp_w = gotf[0] >> idx1
            if 2 * idx1 > 32:
                sp_w = sp_w | ((gotf[1] << (32 - idx1)) & M32)
            idx_s = sp_w & imask
            bestb = torch.where(hit & (idx_s > 0),
                                ((idx_s - 1) << 6) | (l + lil), bestb)
        for j, key in enumerate(c.ovf_keys):
            const = [0] * len(kmask)
            for kb in range(l):
                kbit = ib + 8 * kb
                kf, koff = kbit >> 5, kbit & 31
                const[kf] |= (key[kb] << koff) & M32
                if koff > 24:
                    const[kf + 1] |= key[kb] >> (32 - koff)
            oh = guard.clone()
            for fj, km in enumerate(kmask):
                if km:
                    oh &= ((wf[fj] ^ const[fj]) & km) == 0
            base = ovf_base[l] + j * n_idx
            ov_m = scalars[base]
            best = torch.where(oh & (ov_m > 0), ((ov_m - 1) << 6) | l, best)
            if has_space:
                ov_s = scalars[base + 1]
                bestb = torch.where(oh & (ov_s > 0),
                                    ((ov_s - 1) << 6) | (l + lil), bestb)
    if has_space:
        return best.to(torch.int32), bestb.to(torch.int32)
    return best.to(torch.int32)


def match(text: torch.Tensor, n, tabs: DeviceTables):
    """M (and Mb) for ``text`` (uint8 [N], valid bytes ``n``: an int, or
    a 0-dim int32 tensor on the text's device, read there): the CUDA
    kernel for a CUDA tensor, the plain version for a CPU one.  Outputs
    are int32 holding the u32 words."""
    if not isinstance(n, torch.Tensor) and not 0 <= n <= text.numel():
        raise ValueError(f"n={n} outside [0, {text.numel()}]")
    if text.device.type == "cpu":
        return match_plain(text, n, tabs)
    if tabs.max_len + (tabs.lil_off if tabs.has_space else 0) > 63:
        raise ValueError(f"keys of {tabs.max_len} bytes: a match word holds "
                         "its length in 6 bits, so keys end at 63 bytes "
                         "(the virtual space included)")
    dev = text.device
    N = text.numel()
    _build.check(text, "text", torch.uint8, dev, (N,))
    m = torch.empty(N, dtype=torch.int32, device=dev)
    mb = torch.empty(N, dtype=torch.int32, device=dev) if tabs.has_space \
        else m
    args = match_args(text, n, tabs, m, mb)
    _build.launch("match", args, dev)
    return (m, mb) if tabs.has_space else m


def match_args(text: torch.Tensor, n, tabs: DeviceTables,
               m: torch.Tensor, mb: torch.Tensor) -> _build.MatchArgs:
    """The kernel's argument struct for these tensors, each checked;
    ``n`` as ``match`` takes it.  The struct holds its scalar ``n`` alive
    (``keep``)."""
    dev, N = text.device, text.numel()
    for name in ("fields", "disp", "single", "space_single", "scalars",
                 "desc", "len_cls", "filt"):
        _build.check(getattr(tabs, name), name, torch.int32, dev)
    _build.check(tabs.ovf_keys, "ovf_keys", torch.uint8, dev)
    n_t = _build.scalar_arg(n, "n", N, dev)
    args = _build.MatchArgs(
        text=text.data_ptr(), fields=tabs.fields.data_ptr(),
        disp=tabs.disp.data_ptr(), single=tabs.single.data_ptr(),
        space_single=tabs.space_single.data_ptr(),
        scalars=tabs.scalars.data_ptr(), desc=tabs.desc.data_ptr(),
        len_cls=tabs.len_cls.data_ptr(), ovf_keys=tabs.ovf_keys.data_ptr(),
        m=m.data_ptr(), mb=mb.data_ptr(), n=n_t.data_ptr(), N=N,
        max_len=tabs.max_len, idx1_bits=tabs.idx1_bits,
        has_space=int(tabs.has_space), lil_off=tabs.lil_off,
        filt=tabs.filt.data_ptr(), filt_log2=tabs.filt_log2,
        n_cls=tabs.desc.shape[0], disp_words=tabs.disp.numel())
    args.keep = n_t
    return args

