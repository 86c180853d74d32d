"""Import external tokenizer vocabularies (GPT-2 / LLaMa style).

Equivalent of yaml_guide/convert_gpt2tokenizer.py and
convert_llamatokenizer.py, but fully offline: reads a HF ``vocab.json``-style
mapping (token string -> id) or a sentencepiece-style token list and builds a
TokenMonster-format vocabulary via the same YAML-intermediary semantics
(charset utf-8, capcode 0, normalization none, hex-encoded tokens).

Copy of ``tokenmonster_tpu/train/imports.py`` on this package's
``core.vocab`` and ``core.yamlio``: host code, no torch work.
"""

from __future__ import annotations

import json

from ..core.vocab import Vocab

# GPT-2 byte-level BPE printable-byte aliases (convert_gpt2tokenizer.py:25-35
# discovers these dynamically; they are fixed for all GPT-2 style tokenizers).
GPT2_SPACE = "Ġ"     # Ġ
GPT2_NEWLINE = "Ċ"   # Ċ
GPT2_CARRIAGE = "č"  # č
GPT2_TAB = "ĉ"       # ĉ


def gpt2_byte_decoder() -> dict[str, int]:
    """The standard GPT-2 unicode->byte mapping (bytes_to_unicode inverse)."""
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def import_gpt2_json(json_path, special_tokens=("<|endoftext|>",),
                     full_byte_decode: bool = True) -> Vocab:
    """Build a vocabulary from a GPT-2 ``vocab.json`` mapping.

    With ``full_byte_decode`` (default) every token is decoded through the
    GPT-2 byte-level alphabet (exact).  The reference converter
    (convert_gpt2tokenizer.py:48-52) only maps space/newline/CR/tab; set
    ``full_byte_decode=False`` to reproduce that behaviour.
    """
    with open(json_path, "r", encoding="utf-8") as f:
        mapping = json.load(f)
    decoder = gpt2_byte_decoder() if full_byte_decode else None
    specials = set(special_tokens)
    tokens: list[bytes] = []
    ids: list[int] = []
    special_list: list[tuple[bytes, int]] = []
    for token, tid in mapping.items():
        if token in specials:
            special_list.append((token.encode("utf-8"), tid))
            continue
        if full_byte_decode:
            data = bytes(decoder.get(ch, None) if decoder.get(ch) is not None
                         else None for ch in token) if all(
                ch in decoder for ch in token) else None
            if data is None:
                # not byte-alphabet encoded (plain special-ish token)
                data = token.encode("utf-8")
        else:
            data = (token.replace(GPT2_SPACE, " ").replace(GPT2_NEWLINE, "\n")
                    .replace(GPT2_CARRIAGE, "\r").replace(GPT2_TAB, "\t")
                    .encode("utf-8"))
        tokens.append(data)
        ids.append(tid)
    return build_imported_vocab(tokens, ids, special_list)


def build_imported_vocab(tokens: list[bytes], ids: list[int],
                         specials: list[tuple[bytes, int]] = (),
                         normalization: str = "none",
                         unk_id: int | None = None) -> Vocab:
    """Assemble an imported vocabulary: charset utf-8, capcode 0.

    Uses the same construction path as the YAML importer (exportvocab-style):
    tokens are pre-encoded, ids preserved.
    """
    v = Vocab()
    # pre-seed id assignments via the YAML semantics without YAML parsing
    from ..core import yamlio
    y = yamlio.YamlVocab()
    y.charset = "utf-8"
    y.normalization = normalization
    y.capcode = 0
    if unk_id is not None:
        y.unk = True
        y.unk_id = unk_id
    for tok, tid in zip(tokens, ids):
        item = yamlio.YamlItem()
        item.token = "TokenMonsterHexEncode{%s}" % tok.hex()
        item.id = tid
        item.encoded = True
        y.regular.append(item)
    for tok, tid in specials:
        item = yamlio.YamlItem()
        item.token = "TokenMonsterHexEncode{%s}" % tok.hex()
        item.id = tid
        item.encoded = True
        y.special.append(item)
    v._generate_from_parsed_yaml(y)
    return v


def _pb_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _pb_fields(buf: bytes):
    """Iterate (field_no, wire_type, value) over a protobuf message body."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _pb_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _pb_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _pb_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


# sentencepiece ModelProto.SentencePiece.type values
SP_NORMAL, SP_UNKNOWN, SP_CONTROL, SP_USER_DEFINED, SP_UNUSED, SP_BYTE = (
    1, 2, 3, 4, 5, 6)

_SP_HEX = __import__("re").compile(r"^<0x([0-9A-Fa-f]{2})>$")


def read_sentencepiece_model(path):
    """Offline ``tokenizer.model`` (sentencepiece ModelProto) reader.

    No sentencepiece/protobuf dependency: parses the two message levels the
    import needs — ModelProto.pieces (field 1), SentencePiece.piece/score/
    type (fields 1/2/3).  Returns a list of (piece_str, score, type) in file
    order (ids are implicit positions, as in sentencepiece).
    """
    import struct

    with open(path, "rb") as f:
        buf = f.read()
    pieces = []
    for field, wire, val in _pb_fields(buf):
        if field != 1 or wire != 2:
            continue
        piece, score, ptype = "", 0.0, SP_NORMAL
        for f2, w2, v2 in _pb_fields(val):
            if f2 == 1 and w2 == 2:
                piece = v2.decode("utf-8", errors="surrogateescape")
            elif f2 == 2 and w2 == 5:
                score = struct.unpack("<f", v2)[0]
            elif f2 == 3 and w2 == 0:
                ptype = v2
        pieces.append((piece, score, ptype))
    return pieces


def import_sentencepiece_model(path) -> Vocab:
    """Build a vocabulary from a real LLaMa ``tokenizer.model`` file,
    reproducing convert_llamatokenizer.py:9-80 semantics exactly:
    charset utf-8, capcode 0, normalization leadingspace; ``<0xNN>`` byte
    pieces decode to raw bytes; '▁' becomes a space; the UNKNOWN piece
    becomes the unk token; CONTROL pieces (bos/eos) become special tokens.
    """
    pieces = read_sentencepiece_model(path)
    tokens: list[bytes] = []
    ids: list[int] = []
    specials: list[tuple[bytes, int]] = []
    unk_id = None
    for i, (piece, _score, ptype) in enumerate(pieces):
        if ptype == SP_UNKNOWN:
            unk_id = i
            continue
        if ptype in (SP_CONTROL, SP_UNUSED):
            specials.append((piece.encode("utf-8"), i))
            continue
        m = _SP_HEX.match(piece)
        if ptype == SP_BYTE or m:
            data = bytes([int(m.group(1), 16)]) if m else piece.encode()
        else:
            data = piece.replace("▁", " ").encode(
                "utf-8", errors="surrogateescape")
        tokens.append(data)
        ids.append(i)
    return build_imported_vocab(tokens, ids, specials,
                                normalization="leadingspace", unk_id=unk_id)


def import_sentencepiece_tokens(tokens: list[bytes], ids=None,
                                specials: list[tuple[bytes, int]] = ()) -> Vocab:
    """Build from a LLaMa-style sentencepiece token list ("▁" = space),
    mirroring convert_llamatokenizer.py."""
    decoded = []
    out_ids = []
    for i, t in enumerate(tokens):
        s = t.decode("utf-8", errors="surrogateescape").replace("▁", " ")
        decoded.append(s.encode("utf-8", errors="surrogateescape"))
        out_ids.append(ids[i] if ids is not None else i)
    return build_imported_vocab(decoded, out_ids, specials)
