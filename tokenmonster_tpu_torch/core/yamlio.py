"""YAML vocabulary import/export.

Schema: go/tokenmonster.go:3805-3829 (YamlVocab/YamlItem) and the annotated
example yaml_guide/example.yaml.  Export format: go/tokenmonster.go:3843-4027
(ExportYAML, escapeYAML, TokenMonsterHexEncode{...}).
"""

from __future__ import annotations

import binascii
from dataclasses import dataclass, field

import numpy as np
import yaml


@dataclass
class YamlItem:
    token: str = ""
    id: int | None = None
    score: float = 0.0
    encoded: bool = False

    def token_bytes(self) -> bytes:
        """Decode, handling TokenMonsterHexEncode{...} (go :4015-4027)."""
        s = self.token
        if s.startswith("TokenMonsterHexEncode{") and s.endswith("}"):
            inner = s[len("TokenMonsterHexEncode{"):-1]
            try:
                return binascii.unhexlify(inner)
            except binascii.Error:
                raise ValueError(f"Invalid TokenMonster hex encoding: {s}")
        return s.encode("utf-8", errors="surrogateescape")


@dataclass
class YamlVocab:
    charset: str = ""
    normalization: str = ""
    capcode: int = 0
    training_param: int | None = None
    reset_token_ids: bool = False
    include_256_bytes: bool = False
    include_128_bytes: bool = False
    include_utf8_bytes: bool = False
    include_ascii_bytes: bool = False
    include_extended_bytes: bool = False
    exclude_other_bytes: bool = False
    unk: bool = False
    unk_id: int | None = None
    regular: list[YamlItem] = field(default_factory=list)
    special: list[YamlItem] = field(default_factory=list)
    delete: list[YamlItem] = field(default_factory=list)


def _items(raw) -> list[YamlItem]:
    out = []
    for entry in raw or []:
        if not isinstance(entry, dict):
            continue
        item = YamlItem()
        tok = entry.get("token")
        if tok is not None:
            item.token = str(tok)
        if entry.get("id") is not None:
            item.id = int(entry["id"])
        if entry.get("score") is not None:
            item.score = float(entry["score"])
        item.encoded = bool(entry.get("encoded", False))
        out.append(item)
    return out


def parse(data: bytes) -> YamlVocab:
    raw = yaml.safe_load(data.decode("utf-8", errors="surrogateescape"))
    v = YamlVocab()
    if not isinstance(raw, dict):
        return v
    v.charset = str(raw.get("charset", "")).lower()
    v.normalization = str(raw.get("normalization", "") or "")
    v.capcode = int(raw.get("capcode", 0) or 0)
    if raw.get("training-param") is not None:
        v.training_param = int(raw["training-param"])
    v.reset_token_ids = bool(raw.get("reset-token-ids", False))
    v.include_256_bytes = bool(raw.get("include-256-bytes", False))
    v.include_128_bytes = bool(raw.get("include-128-bytes", False))
    v.include_utf8_bytes = bool(raw.get("include-utf8-bytes", False))
    v.include_ascii_bytes = bool(raw.get("include-ascii-bytes", False))
    v.include_extended_bytes = bool(raw.get("include-extended-bytes", False))
    v.exclude_other_bytes = bool(raw.get("exclude-other-bytes", False))
    v.unk = bool(raw.get("unk", False))
    if raw.get("unk-id") is not None:
        v.unk_id = int(raw["unk-id"])
    v.regular = _items(raw.get("tokens"))
    v.special = _items(raw.get("special"))
    v.delete = _items(raw.get("delete"))
    return v


_ESCAPES = {
    0x00: "\\0", 0x08: "\\b", 0x09: "\\t", 0x0A: "\\n",
    0x0B: "\\v", 0x0C: "\\f", 0x0D: "\\r",
    0x5C: "\\\\", 0x22: "\\\"",
}


def escape_token(token: bytes) -> str:
    """go/tokenmonster.go:3970-4008."""
    try:
        s = token.decode("utf-8")
    except UnicodeDecodeError:
        return '"TokenMonsterHexEncode{%s}"' % token.hex()
    out = ['"']
    for ch in s:
        esc = _ESCAPES.get(ord(ch))
        out.append(esc if esc is not None else ch)
    out.append('"')
    return "".join(out)


def _fmt_float(v: float) -> str:
    # Go strconv.FormatFloat(value, 'f', -1, 32): shortest decimal that
    # round-trips through float32, never scientific notation.
    s = np.format_float_positional(np.float32(v), unique=True, trim="-")
    return s


def export_yaml(vocab, order_by_score: bool = False) -> bytes:
    """go/tokenmonster.go:3843-3968."""
    lines: list[str] = []
    lines.append("charset: utf-8" if vocab.charset == 1 else
                 ("charset: utf-16" if vocab.charset == 2 else "charset: none"))
    lines.append('normalization: "%s"' % str(vocab.normalizer).lower())
    lines.append("capcode: %d" % vocab.using_capcode)
    if vocab.level < 5:
        lines.append("training-param: %d" % ((vocab.reserve << 3) | vocab.level))
    from .tokenmeta import DOES_NOT_EXIST
    if vocab.unk_token != DOES_NOT_EXIST:
        lines.append("unk: true")
        lines.append("unk-id: %d" % vocab.unk_token)
    lines.append("tokens:")

    entries = [(i, float(vocab.score[i])) for i in range(len(vocab.tokens))
               if vocab.score[i] > -0.5]
    regular = [(i, s) for i, s in entries if not (vocab.flag[i] & 64)]
    special = [(i, s) for i, s in entries if vocab.flag[i] & 64]
    if order_by_score:
        regular.sort(key=lambda t: (-t[1], t[0]))
        special.sort(key=lambda t: (-t[1], t[0]))

    def emit(i: int, score: float):
        lines.append("    - token:   %s" % escape_token(vocab.tokens[i]))
        lines.append("      id:      %d" % int(vocab.id[i]))
        if score > 0:
            lines.append("      score:   %s" % _fmt_float(score))
        lines.append("      encoded: true")

    for i, s in regular:
        emit(i, s)
    if special:
        lines.append("special:")
        for i, s in special:
            emit(i, s)
    return ("\n".join(lines) + "\n").encode("utf-8", errors="surrogateescape")
