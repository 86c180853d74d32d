"""The 6-branch ungreedy decision at every position and forward-delete row.

Port of ``tokenmonster_tpu/ops/pallas_decide.py::make_decide_kernel`` and
``resolve_tokens``.  The kernel is ``decide_kernel`` in
``csrc/tm_kernels.cu`` (per-position code ``tmk::decide_stage`` and
``tmk::decide_tile_at``);
``decide_plain`` is the same function in PyTorch.  Score ints, NEG and the
first-hit tie order are those of go/tokenmonster.go:1057, :1075-1108,
:1132-1133.

Outputs (the ``ops/decision.py`` contract):
  ctl = delta(6b) | fd'<<6 | has_tok<<7 | has_del<<8 | miss<<9
  tok = dict idx (S bits) | branch w3 (2b) << S; w3 == 3 marks a literal id
shape (N,) for a vocabulary without a delete token, else (2, N), row fd.
S is the tables' ``w3_shift`` (``ops/tables.py::w3_shift``): 20 where the
JAX package's Pallas engine serves the vocabulary, so the words are its
words bit for bit, and 21 to 24 for vocabularies of 2^20 entries or more
(the fewest bits that hold every index and literal id), which the JAX
package tokenizes on its XLA decision engine.

One difference from the JAX kernel, which clamps every advance to at least
one byte: at fd = 1 a branch to an alternative of length 1 (the virtual
space alone) advances 0 bytes and leaves the chain at (p, fd = 0), as the
native tokenizer does (``i += len1 - fd``).  The JAX package's device path
parts from native there.
"""

from __future__ import annotations

import torch

from . import _build
from .tables import DeviceTables, del_bit

NEG = -1000000


def decide_plain(m: torch.Tensor, mb: torch.Tensor | None,
                 text: torch.Tensor, n, tabs: DeviceTables):
    """PyTorch version of the decide kernel.  ``m``/``mb``: int32 [N] match
    words (``mb`` None without a delete token); ``text``: uint8 [N]; ``n``:
    an int or a 0-dim tensor.  The unk id and flag are read from
    ``tabs.literals`` as the kernel reads them.  Reads past N see zeros, as
    the JAX kernel's zero margin rows do."""
    N = m.numel()
    dev = m.device
    S = tabs.w3_shift
    pad = torch.zeros(128, dtype=torch.int64, device=dev)
    mp = torch.cat([m.long() & 0xFFFFFFFF, pad])
    tp = torch.cat([text.long(), pad])
    pos = torch.arange(N, device=dev)
    meta = tabs.meta.long()
    bb = tabs.bb.long()[tp]            # zero bytes map through begin-byte
    mF0 = meta[0][mp >> 6]             # zero words fetch index 0's meta
    mF1 = meta[1][mp >> 6]
    if tabs.has_delete:
        mbp = torch.cat([mb.long() & 0xFFFFFFFF, pad])
        bF0 = meta[0][mbp >> 6]
        bF1 = meta[1][mbp >> 6]
    lil = tabs.lil_off
    unk_token, has_unk = tabs.literals.long()[:2]

    def win(arr, delta):
        return arr[pos + delta.clamp(0, 127)]

    def fd_row(fd):
        mf, F0, F1 = (mbp, bF0, bF1) if fd else (mp, mF0, mF1)
        mf, F0, F1 = mf[:N], F0[:N], F1[:N]
        cur_idx = mf >> 6
        cur_len = (mf & 63) - fd * lil
        found = mf != 0
        of, onw = F0 & 0xFF, (F0 >> 8) & 0xFF
        olen1, olen2 = (F0 >> 16) & 0xFF, (F0 >> 24) & 0xFF
        af1, anw1 = F1 & 0xFF, (F1 >> 8) & 0xFF
        af2, anw2 = (F1 >> 16) & 0xFF, (F1 >> 24) & 0xFF
        do_eval = found & (pos + cur_len < n) & (
            ((of & 32) == 0) | (win(bb, cur_len) != 12))
        has_alt1 = do_eval & (olen1 > 0)
        has_alt2 = has_alt1 & (olen2 > 0)
        valid_first = [do_eval, has_alt1, has_alt2]
        first_len = [cur_len, olen1 - fd, olen2 - fd]
        f_first = [of, af1, af2]
        fnw = [onw - fd, anw1 - fd, anw2 - fd]
        scores, scores_b = [], []
        for r in range(3):
            delta3 = torch.where(valid_first[r], first_len[r], cur_len)
            m3 = win(mp, delta3)
            s_len = m3 & 63
            valid_nb = valid_first[r] & (m3 != 0)
            sF0 = win(mF0, delta3)
            sf, snw = sF0 & 0xFF, (sF0 >> 8) & 0xFF
            nb_nb = win(bb, delta3 + s_len)
            bl = first_len[r] + s_len
            base = (bl + (f_first[r] >> 7) + (sf >> 7)
                    + (fnw[r] - 1).clamp(min=0) + (snw - 1).clamp(min=0)
                    + ((sf >> 2) & 1) + ((nb_nb >> 2) & 1)
                    + (fnw[r] + snw + (nb_nb >> 3)) * 100)
            ded = ((f_first[r] & 1 & (sf >> 1)) * 103
                   + ((f_first[r] >> 3) & 1 & (sf >> 4)) * 100
                   + (sf & 1 & nb_nb) * 3)
            if r > 0:
                ded = ded + (bl < cur_len) * 100 + (bl == cur_len) * 10000
            scores.append(torch.where(valid_nb, base - ded, NEG))
            if not tabs.has_delete:
                continue
            mb3 = win(mbp, delta3)
            sbF0 = win(bF0, delta3)
            secb_lenf = mb3 & 63
            secb_len = secb_lenf - lil
            sfb, snwb = sbF0 & 0xFF, (sbF0 >> 8) & 0xFF
            want_b = (valid_nb & ((sf & 2) != 0) & (nb_nb == 1) & (snw == 0)
                      & (secb_lenf > s_len + 1))
            nb_b = win(bb, delta3 + secb_len)
            bl = first_len[r] + secb_len
            base = (bl + (f_first[r] >> 7) + (sfb >> 7)
                    + (fnw[r] - 1).clamp(min=0) + (snwb - 1).clamp(min=0)
                    + ((nb_b >> 2) & 1)
                    + (fnw[r] + snwb + (nb_b >> 3)) * 100)
            ded = ((f_first[r] & 1) * 103
                   + ((f_first[r] >> 3) & 1 & (sfb >> 4)) * 100
                   + (sfb & 1 & nb_b) * 3 + 1)
            if r > 0:
                ded = ded + (bl < cur_len) * 100 + (bl == cur_len) * 10000
            scores_b.append(torch.where(want_b, base - ded, NEG))
        s = torch.stack(scores + scores_b)
        mx = s.max(dim=0).values
        any_branch = mx != NEG
        # first hit in the order s1 > s2 > s3 > s1b > s2b > s3b
        w6 = (s == mx).to(torch.int8).argmax(dim=0)
        w3 = w6 % 3
        is_b = any_branch & (w6 >= 3)
        adv = torch.stack(first_len).gather(0, w3[None]).squeeze(0)
        new_pos_rel = torch.where(found, torch.where(any_branch, adv,
                                                     cur_len), 1)
        miss = ~found & (pos < n)
        has_tok = found | (miss & (has_unk != 0))
        # an alternative branch may advance 0 bytes (fd 1, an alternative
        # that is the virtual space alone); the JAX kernel clamps it to 1
        lo = torch.where(any_branch & (w3 > 0), 0, 1)
        ctl = (torch.maximum(new_pos_rel, lo).clamp(max=63)
               | (is_b * ((1 << 6) | (1 << 8)))
               | (has_tok * (1 << 7)) | (miss * (1 << 9)))
        tok = torch.where(miss, (3 << S) | unk_token,
                          cur_idx | (w3 << S))
        return ctl.to(torch.int32), tok.to(torch.int32)

    if not tabs.has_delete:
        return fd_row(0)
    rows = [fd_row(0), fd_row(1)]
    return (torch.stack([rows[0][0], rows[1][0]]),
            torch.stack([rows[0][1], rows[1][1]]))


def decide(m: torch.Tensor, mb: torch.Tensor | None, text: torch.Tensor,
           n, tabs: DeviceTables):
    """(ctl, tok) for match words ``m``/``mb`` (int32 [N]; ``mb`` None
    without a delete token) over ``text`` (uint8 [N]), ``n`` valid bytes
    (an int, or a 0-dim int32 tensor on their device): the CUDA kernel for
    CUDA tensors, the plain version for CPU ones."""
    N = m.numel()
    if not isinstance(n, torch.Tensor) and not 0 <= n <= N:
        raise ValueError(f"n={n} outside [0, {N}]")
    if (mb is None) == tabs.has_delete:
        raise ValueError("mb is required exactly for delete-token vocabs")
    if m.device.type == "cpu":
        return decide_plain(m, mb, text, n, tabs)
    dev = m.device
    _build.check(m, "m", torch.int32, dev, (N,))
    if mb is not None:
        _build.check(mb, "mb", torch.int32, dev, (N,))
    _build.check(text, "text", torch.uint8, dev, (N,))
    rows = 2 if tabs.has_delete else 1
    _build.check(tabs.entries, "entries", torch.int32, dev,
                 (rows, tabs.entries.shape[1], 4))
    _build.check(tabs.bb, "bb", torch.int32, dev, (256,))
    _build.check(tabs.literals, "literals", torch.int32, dev, (3,))
    n_t = _build.scalar_arg(n, "n", N, dev)
    ctl = torch.empty((rows, N), dtype=torch.int32, device=dev)
    tok = torch.empty((rows, N), dtype=torch.int32, device=dev)
    args = _build.DecideArgs(
        m=m.data_ptr(), mb=(mb if mb is not None else m).data_ptr(),
        text=text.data_ptr(), entries=tabs.entries.data_ptr(),
        bb=tabs.bb.data_ptr(), ctl=ctl.data_ptr(), tok=tok.data_ptr(),
        n=n_t.data_ptr(), literals=tabs.literals.data_ptr(), N=N,
        n_entries=tabs.entries.shape[1], has_delete=int(tabs.has_delete),
        lil_off=tabs.lil_off, w3_shift=tabs.w3_shift)
    _build.launch("decide", args, dev)
    if rows == 1:
        return ctl[0], tok[0]
    return ctl, tok


def resolve_words(words: torch.Tensor, tabs: DeviceTables) -> torch.Tensor:
    """The id each compacted token word emits, on the words' device: idx |
    w3<<S (S the tables' ``w3_shift``) through ``ids3``, w3 == 3 marking a
    literal id; the delete marker ``del_bit(S)`` is not read.  int64 out,
    one id a word."""
    S = tabs.w3_shift
    w = words.long()
    idx = w & ((1 << S) - 1)
    w3 = (w >> S) & 3
    flat = tabs.ids3.long().reshape(-1) & 0xFFFFFFFF
    res = flat[(idx * 3 + w3.clamp(max=2)).clamp(max=flat.numel() - 1)]
    return torch.where(w3 == 3, idx, res)


def resolve_device(words: torch.Tensor, tabs: DeviceTables) -> torch.Tensor:
    """Compacted token words to emitted ids, on the words' device:
    ``resolve_words``, and the delete token spliced in after each word
    with ``del_bit(S)`` (a boolean index, which reads its count back to
    the host).  Port of
    ``tokenmonster_tpu/ops/pallas_decide.py::resolve_tokens``; int64 out."""
    res = resolve_words(words, tabs)
    if not tabs.has_delete:
        return res
    dele = (words.long() & del_bit(tabs.w3_shift)) != 0
    pair = torch.stack([res, torch.full_like(res, tabs.delete_token)], 1)
    keep = torch.stack([torch.ones_like(dele), dele], 1)
    return pair[keep]
