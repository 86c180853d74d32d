"""Export/convert vocabularies: the exportvocab pipeline.

Equivalent of training/exportvocab.go: builds a final ``.vocab`` from a
trained ``.tok`` file (picking the best file in a results directory), an
input YAML, or an existing vocabulary; supports resize, adding special
tokens and single-byte classes, unk token, and YAML export.

Copy of ``tokenmonster_tpu/train/exportvocab.py``, its known faults kept
(ROADMAP.md §3): ``.tok`` output drops the UNK row, and a vocabulary is
written with a zero specials count where the reference writes none.
"""

from __future__ import annotations

import os
import re

from ..core.vocab import Vocab
from .getalltokens import load_tokens_file

_FINAL_RE = re.compile(r"^(\d+)_\d+\.tok$")


def best_tok_in_dir(path) -> str:
    """Pick the best (lowest-score-prefix) final file, else an interval file
    (exportvocab.go:210-246 semantics)."""
    best = None
    best_score = None
    fallback = None
    for name in sorted(os.listdir(path)):
        m = _FINAL_RE.match(name)
        if m:
            score = int(m.group(1))
            if best_score is None or score < best_score:
                best_score = score
                best = os.path.join(path, name)
        elif name.endswith(".tok") and fallback is None:
            fallback = os.path.join(path, name)
    if best:
        return best
    if fallback:
        return fallback
    raise FileNotFoundError(f"no .tok files in {path}")


def export_vocab(input_path=None, input_yaml=None, input_vocab=None,
                 output=None, output_yaml=None, resize: int = 0,
                 add_special_tokens=(), add_single_bytes=(),
                 exclude_other_bytes: bool = False, unk: bool | None = None,
                 reset_token_ids: bool = False,
                 order_by_score: bool = False,
                 output_tokens=None) -> Vocab:
    """Build and optionally save a vocabulary.  ``add_single_bytes`` accepts
    any of: "256", "128", "ascii", "utf8", "extended".  ``output_tokens``
    converts the vocabulary back to a trainvocab-compatible ``.tok`` file
    (exportvocab.go:364-384)."""
    if not (input_path or input_yaml or input_vocab):
        raise ValueError("an input is required")

    reserve = 0
    for cls in add_single_bytes:
        reserve |= {"256": 1, "128": 2, "utf8": 4, "ascii": 8,
                    "extended": 16}[str(cls).lower()]
    if exclude_other_bytes:
        reserve |= 32

    tokens = []
    scores = []
    encoded_specials = []
    charset = 0
    using_capcode = 0
    norm_code = 0
    level = 0
    reserve2 = 0
    vocab = Vocab()

    if input_vocab:
        vocab = Vocab.load(input_vocab)
    if input_path:
        if os.path.isdir(input_path):
            input_path = best_tok_in_dir(input_path)
        d = load_tokens_file(input_path)
        using_capcode = d["using_capcode"]
        charset = d["charset"]
        norm_code = d["norm_flag"]
        level = d["level"]
        reserve2 = d["reserve"]
        tokens = d["tokens"]
        scores = d["scores"] or []
        encoded_specials = d["specials"] or []
        if not scores and resize > 0:
            raise ValueError("cannot resize an untrained tokens file")

    yaml_data = None
    if input_yaml:
        with open(input_yaml, "rb") as f:
            yaml_data = f.read()

    from ..core.normalize import Normalizer
    vocab._generate(
        yaml_data=yaml_data, tokens=tokens, scores=scores,
        special_tokens=[s.encode() if isinstance(s, str) else bytes(s)
                        for s in add_special_tokens],
        special_tokens_encoded=encoded_specials,
        charset=charset, normalize_string=str(Normalizer(norm_code)),
        using_capcode=using_capcode, level=level,
        reserve=reserve | reserve2, resize=resize,
        reset_token_ids=reset_token_ids)

    if unk is True:
        vocab.enable_unk_token()
    elif unk is False:
        vocab.disable_unk_token()

    if output:
        vocab.save(output)
    if output_tokens:
        save_vocab_as_tokens(vocab, output_tokens)
    if output_yaml:
        with open(output_yaml, "wb") as f:
            f.write(vocab.export_yaml(order_by_score))
    return vocab


def save_vocab_as_tokens(vocab: Vocab, path) -> int:
    """Convert a vocabulary back to a trainvocab-usable ``.tok`` file
    (exportvocab.go:364-384: TokensDetailed tokens + scores, type-2 entries
    doubled into the specials list, vocab header bytes).  The UNK
    pseudo-entry (empty token) is not a trainable candidate and is skipped.
    Returns the number of tokens written."""
    from .getalltokens import save_tokens_with_scores
    infos = [i for i in vocab.tokens_detailed() if i["token"]]
    header = {
        "using_capcode": vocab.using_capcode,
        "charset": vocab.charset,
        "norm_flag": vocab.normalizer.flag,
        "level": vocab.level,
        "reserve": vocab.reserve,
    }
    save_tokens_with_scores(
        path, header,
        [i["token"] for i in infos],
        [i["score"] for i in infos],
        [i["token"] for i in infos if i["type"] == 2])
    return len(infos)
