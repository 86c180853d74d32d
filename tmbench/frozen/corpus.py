"""The traffic's text, frozen from ``tokenmonster_tpu_torch/corpus.py`` at
commit 6d463e6b506c (``single_byte_values``, ``stdlib_text``, copied whole): the
running interpreter's standard library, ``.py`` and ``.txt`` files in
sorted path order, lines whose normalized bytes lack a one-byte token
dropped where a vocabulary is given.  The copy stays as it is when the
source changes."""

import os


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
