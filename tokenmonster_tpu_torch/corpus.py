"""Inputs for measurements and card checks: real text from the running
interpreter's standard library (``.py`` and ``.txt`` files in sorted path
order, made the same way on any machine with the same Python version), a
one-row variant of a vocabulary, and one staged main-path dispatch."""

from __future__ import annotations

import os

from .core.vocab import Vocab
from .ops.scan import MARGIN, GpuTokenizer


def one_row_vocab(vocab):
    """A capcode-0 vocabulary on the same token bytes: no delete token, so
    match and decide run their one-row variants."""
    v = Vocab()
    v._generate(tokens=list(vocab.tokens), charset=1,
                normalize_string="none", using_capcode=0, level=5,
                reset_token_ids=True)
    return v


def main_dispatch(vocab, raw: bytes, device, chunk: int = 2048,
                  lanes: int = 512):
    """One full dispatch of ``lanes`` lanes of ``chunk`` bytes of
    ``vocab.normalize(raw)``, staged on ``device`` as the main path stages
    it.  Returns (tokenizer, buffer uint8 [N], n)."""
    tk = GpuTokenizer(vocab, chunk=chunk, device=device)
    data = vocab.normalize(raw)[:(lanes - 1) * chunk + MARGIN]
    staged = tk.stage(data)
    if staged.lanes != lanes:
        raise ValueError(f"{len(data)} bytes stage {staged.lanes} lanes, "
                         f"not {lanes}")
    buf, n, _last = staged.bufs[0]
    return tk, buf, n


def single_byte_values(vocab) -> set:
    """Byte values that have a one-byte token: a text made only of these
    has a match at every position, so no byte of it is missing."""
    return {t[0] for t in vocab.tokens if len(t) == 1}


def stdlib_text(vocab, min_bytes: int):
    """At least ``min_bytes`` raw bytes of standard-library files (fewer if
    the library is smaller).  With a ``vocab``, every line whose normalized
    form holds a byte without a one-byte token is dropped: a missing byte
    in a vocabulary without an unk token sends a whole text to the host
    fallback, which a measurement of the device path must not take.  With
    None every line is kept (the trainer scores missing bytes).  Returns
    (text, number of lines dropped)."""
    root = os.path.dirname(os.__file__)
    paths = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        paths += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith((".py", ".txt"))]
    ok = single_byte_values(vocab) if vocab is not None else None
    kept, total, dropped = [], 0, 0
    for path in sorted(paths):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            continue
        for line in data.splitlines(keepends=True):
            if ok is None or set(vocab.normalize(line)) <= ok:
                kept.append(line)
                total += len(line)
            else:
                dropped += 1
        if total >= min_bytes:
            break
    return b"".join(kept), dropped
