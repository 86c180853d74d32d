"""mergetokens / comparetokens equivalents (training/mergetokens.go,
training/comparetokens.go).

Copy of ``tokenmonster_tpu/train/tools.py``."""

from __future__ import annotations

from .getalltokens import load_tokens_file, save_tokens_with_scores


def merge_tokens(inputs: list, output):
    """Set-union of .tok files (mergetokens.go): header from the first."""
    header = None
    union = set()
    specials = []
    for path in inputs:
        d = load_tokens_file(path)
        if header is None:
            header = d
        union.update(d["tokens"])
        if d.get("specials"):
            for s in d["specials"]:
                if s not in specials:
                    specials.append(s)
    toks = sorted(union, key=lambda t: (len(t), t))
    save_tokens_with_scores(output, header, toks,
                            None if not specials else [0.0] * len(toks),
                            specials or None)
    return len(toks)


def compare_tokens(path_a, path_b):
    """Set differences between two .tok files (comparetokens.go).

    Returns (only_in_a, only_in_b, common)."""
    a = set(load_tokens_file(path_a)["tokens"])
    b = set(load_tokens_file(path_b)["tokens"])
    key = lambda t: (len(t), t)  # noqa: E731
    return (sorted(a - b, key=key), sorted(b - a, key=key),
            sorted(a & b, key=key))
