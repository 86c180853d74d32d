"""The Vocab object: load/save, construction, mutation, introspection.

This is the TPU-framework equivalent of the reference core library's Vocab
(go/tokenmonster.go:38-107, 2599-3801).  Token metadata is kept as numpy
struct-of-arrays aligned with dictionary index order so the TPU trie/kernel
builders (ops/) can consume it zero-copy.
"""

from __future__ import annotations

import numpy as np

from .. import tracing
from ..utils.runes import decode_rune
from . import capcode as cc
from .binio import Reader, Writer
from .dictionary import Dictionary, sort_key
from .normalize import Normalizer
from .tokenmeta import (
    DOES_NOT_EXIST, classify_token, compute_alternatives, is_alphanum_tm,
)

MAX_TOKEN_LEN = 40

# test hook: set True to force the pure-Python metadata pass
_FORCE_PYTHON_META = False


def apply_capcode(data: bytes, using_capcode: int) -> bytes:
    if using_capcode == 2:
        return cc.encode(data)
    if using_capcode == 1:
        return cc.no_capcode_encode(data)
    return data


def normalize_and_capcode(data: bytes, using_capcode: int,
                          normalizer: Normalizer) -> bytes:
    """go/tokenmonster.go:242-253."""
    with tracing.span("nfd", len(data)):
        data = normalizer.normalize(data)
    with tracing.span("capcode", len(data)):
        return apply_capcode(data, using_capcode)


def normalize_safe(b: bytes, using_capcode: int, normalizer: Normalizer) -> bytes:
    """Normalize avoiding double capcode encoding (go/tokenmonster.go:256-285)."""
    if using_capcode == 2:
        if any(v in (cc.DELETE_TOKEN, cc.CHARACTER_TOKEN, cc.WORD_TOKEN) for v in b):
            return b
        return cc.encode(normalizer.normalize(b))
    if using_capcode == 1:
        if cc.NO_CAPCODE_DELETE_TOKEN in b:
            return b
        return cc.no_capcode_encode(normalizer.normalize(b))
    return normalizer.normalize(b)


def can_have_unk_token(n_single_bytes: int, using_capcode: int) -> bool:
    """go/tokenmonster.go:438-443."""
    return (n_single_bytes < 256 and using_capcode != 2) or n_single_bytes < 233


# --- reserve-byte charsets (go/tokenmonster.go:301-357) ---

def _gen_ascii(table, using_capcode):
    for i in range(32, 127):
        if using_capcode != 2 or not (65 <= i <= 90 and i not in (67, 87, 68)):
            table[i] = True
    table[9] = table[10] = table[13] = True
    if using_capcode == 1:
        table[127] = True


def _gen_utf8(table, using_capcode):
    _gen_ascii(table, using_capcode)
    for i in range(0x80, 0xC0):
        table[i] = True
    for i in range(0xC2, 0xF5):
        table[i] = True


def _gen_128(table, using_capcode):
    for i in range(128):
        if using_capcode != 2 or not (65 <= i <= 90 and i not in (67, 87, 68)):
            table[i] = True


def _gen_256(table, using_capcode):
    for i in range(256):
        if using_capcode != 2 or not (65 <= i <= 90 and i not in (67, 87, 68)):
            table[i] = True


def _gen_extended(table, using_capcode, normalizer):
    s = "£€©®™°%¢¥—–•‘’“”áéíóúýàèìòùâêîôûäëïöüñãõçåæœ"
    if using_capcode != 2 and not normalizer.specified_lowercase():
        s += "ÁÉÍÓÚÝÀÈÌÒÙÂÊÎÔÛÄËÏÖÜÑÃÕÇÅÆŒ"
    for b in normalizer.normalize(s.encode("utf-8")):
        table[b] = True
    _gen_ascii(table, using_capcode)


class Vocab:
    """A TokenMonster-compatible vocabulary with TPU-friendly array storage."""

    def __init__(self):
        self.dictionary = Dictionary()
        self.tokens: list[bytes] = []          # dictionary order
        self.flag = np.zeros(0, np.uint8)
        self.nwords = np.zeros(0, np.uint8)
        self.index1 = np.zeros(0, np.uint32)
        self.index2 = np.zeros(0, np.uint32)
        self.len1 = np.zeros(0, np.int32)
        self.len2 = np.zeros(0, np.int32)
        self.id = np.zeros(0, np.uint32)
        self.id1 = np.zeros(0, np.uint32)
        self.id2 = np.zeros(0, np.uint32)
        self.score = np.zeros(0, np.float32)
        self.reverse: list[bytes | None] = []
        self.deleted: list[tuple[bytes, int, float]] = []
        self.begin_byte = np.zeros(256, np.uint8)
        self.vocab_size = 0
        self.max_token_length = 0
        self.delete_token = DOES_NOT_EXIST
        self.unk_token = DOES_NOT_EXIST
        self.using_capcode = 0
        self.charset = 0
        self.level = 0
        self.reserve = 0
        self.normalizer = Normalizer(0)

    # ---------- introspection (go/tokenmonster.go:2360-2597) ----------

    def __len__(self):
        return self.vocab_size

    def has_unk(self) -> bool:
        return self.unk_token != DOES_NOT_EXIST

    def unk(self) -> int:
        return self.unk_token

    def capcode(self) -> int:
        return self.using_capcode

    def mode(self) -> int:
        return self.level

    def normalization(self) -> str:
        return str(self.normalizer)

    def normalization_code(self) -> int:
        return self.normalizer.flag

    def highest_token_id(self) -> int:
        return len(self.reverse) - 1

    def num_deleted_tokens(self) -> int:
        return len(self.deleted)

    def single_bytes_training_code(self) -> int:
        return self.reserve

    def id_to_token(self, token_id: int):
        if 0 <= token_id < len(self.reverse):
            return self.reverse[token_id]
        return None

    def token_to_id(self, b: bytes):
        idx, found = self.dictionary.find(b)
        if found:
            return int(self.id[idx]), True
        return 0, False

    def single_byte_tokens(self) -> bytes:
        out = bytearray()
        for t in self.tokens:
            if len(t) == 1:
                out.append(t[0])
            else:
                break
        return bytes(out)

    def num_single_byte_tokens(self) -> int:
        n = 0
        for t in self.tokens[:max(0, len(self.tokens) - 1)]:
            if len(t) == 1:
                n += 1
            else:
                break
        return n

    def token_list(self) -> list[bytes]:
        """All tokens (excluding UNK and "duplicate" entries); go :2456-2467."""
        return [t for t, s in zip(self.tokens, self.score) if s > -0.5]

    def tokens_detailed(self):
        """go/tokenmonster.go:2377-2413. Returns list of dicts."""
        infos = []
        for i, t in enumerate(self.tokens):
            if self.score[i] < -0.5:
                continue
            typ = 0
            if len(t) == 1:
                typ = 1
            elif self.flag[i] & 64:
                typ = 2
            infos.append({
                "id": int(self.id[i]),
                "token": t,
                "token_decoded": self.denormalize(t),
                "type": typ,
                "score": float(self.score[i]),
            })
        if self.unk_token != DOES_NOT_EXIST:
            infos.append({"id": int(self.unk_token), "token": b"",
                          "token_decoded": b"", "type": 3, "score": 0.0})
        return infos

    def special_tokens(self):
        return [i for i in self.tokens_detailed() if i["type"] == 2]

    def num_special_tokens(self) -> int:
        return int(np.count_nonzero((self.flag & 64) & (self.score > -0.5)))

    def denormalize(self, b: bytes) -> bytes:
        if self.using_capcode == 2:
            return cc.decode(b)
        if self.using_capcode == 1:
            return cc.no_capcode_decode(b)
        return b

    def normalize(self, data: bytes) -> bytes:
        return normalize_and_capcode(data, self.using_capcode, self.normalizer)

    # ---------- save / load (go/tokenmonster.go:2599-2736) ----------

    def save(self, path):
        w = Writer()
        w.write_byte(self.using_capcode)
        w.write_byte(self.charset)
        w.write_byte(self.normalizer.flag)
        w.write_byte(self.level)
        w.write_byte(self.reserve)
        w.write_byte(0)
        w.write_byte(0)
        w.write_byte(0)
        w.write_uint24(self.unk_token)
        w.write_uint24(self.vocab_size)
        w.write_uint24(len(self.reverse))
        w.write_uint24(len(self.tokens))
        w.write_uint24(self.delete_token)
        w.write_byte(self.max_token_length)
        for i, token in enumerate(self.tokens):
            w.write_bytes8(token)
            w.write_byte(int(self.flag[i]))
            w.write_byte(int(self.nwords[i]))
            idx1 = int(self.index1[i])
            idx2 = int(self.index2[i])
            if (idx1 > i and idx1 != DOES_NOT_EXIST) or (idx2 > i and idx2 != DOES_NOT_EXIST):
                raise ValueError("Vocabulary is corrupt and cannot be saved")
            w.write_uint24(idx1)
            w.write_uint24(idx2)
            w.write_uint24(int(self.id[i]))
            w.write_float32(float(self.score[i]))
        for i in range(256):
            w.write_byte(int(self.begin_byte[i]))
        w.write_uint24(len(self.deleted))
        for token, token_id, score in self.deleted:
            w.write_bytes8(token)
            w.write_uint24(token_id)
            w.write_float32(score)
        w.to_file(path)

    @classmethod
    def load(cls, path) -> "Vocab":
        r = Reader.from_file(path)
        return cls._load_reader(r)

    @classmethod
    def loads(cls, data: bytes) -> "Vocab":
        return cls._load_reader(Reader(data))

    @classmethod
    def _load_reader(cls, r: Reader) -> "Vocab":
        v = cls()
        v.using_capcode = r.read_byte()
        v.charset = r.read_byte()
        v.normalizer = Normalizer(r.read_byte())
        v.level = r.read_byte()
        v.reserve = r.read_byte()
        r.read_byte(); r.read_byte(); r.read_byte()
        if v.charset > 2 or v.using_capcode > 2:
            raise ValueError("Not a valid TokenMonster vocabulary.")
        v.unk_token = r.read_uint24()
        v.vocab_size = r.read_uint24()
        n_reverse = r.read_uint24()
        n_info = r.read_uint24()
        v.delete_token = r.read_uint24()
        v.max_token_length = r.read_byte()

        v.tokens = []
        v.flag = np.zeros(n_info, np.uint8)
        v.nwords = np.zeros(n_info, np.uint8)
        v.index1 = np.zeros(n_info, np.uint32)
        v.index2 = np.zeros(n_info, np.uint32)
        v.len1 = np.zeros(n_info, np.int32)
        v.len2 = np.zeros(n_info, np.int32)
        v.id = np.zeros(n_info, np.uint32)
        v.id1 = np.zeros(n_info, np.uint32)
        v.id2 = np.zeros(n_info, np.uint32)
        v.score = np.zeros(n_info, np.float32)
        v.reverse = [None] * n_reverse

        for i in range(n_info):
            key = r.read_bytes8()
            if len(key) > MAX_TOKEN_LEN:
                raise ValueError("Not a valid TokenMonster vocabulary.")
            v.tokens.append(key)
            v.dictionary.add(key)
            v.flag[i] = r.read_byte()
            v.nwords[i] = r.read_byte()
            idx1 = r.read_uint24()
            v.index1[i] = idx1
            if idx1 != DOES_NOT_EXIST:
                v.len1[i] = len(v.tokens[idx1])
                v.id1[i] = v.id[idx1]
            idx2 = r.read_uint24()
            v.index2[i] = idx2
            if idx2 != DOES_NOT_EXIST:
                v.len2[i] = len(v.tokens[idx2])
                v.id2[i] = v.id[idx2]
            v.id[i] = r.read_uint24()
            v.score[i] = r.read_float32()
            v.reverse[v.id[i]] = key
        for i in range(256):
            v.begin_byte[i] = r.read_byte()
        n_deleted = r.read_uint24()
        for _ in range(n_deleted):
            tok = r.read_bytes8()
            did = r.read_uint24()
            dscore = r.read_float32()
            v.deleted.append((tok, did, dscore))
        if not r.eof():
            raise ValueError("Not a valid TokenMonster vocabulary.")
        v.dictionary.build()
        # The file is written in dictionary order; verify (cpp :1352-1357).
        for i, t in enumerate(v.tokens):
            if v.dictionary.index[t] != i:
                raise ValueError("Vocabulary file is not in canonical order.")
        return v

    # ---------- modification API (go/tokenmonster.go:2740-2895) ----------

    def add_token(self, token: bytes):
        self._generate(add_tokens=[token])

    def add_special_token(self, token: bytes):
        self._generate(special_tokens=[token])

    def delete_token_bytes(self, token: bytes):
        self._generate(delete_tokens=[token])

    def delete_token_by_id(self, token_id: int):
        yml = ("delete:\n  - id: %d" % token_id).encode()
        self._generate(yaml_data=yml)

    def add_tokens(self, add_tokens, special_tokens=None, size: int = 0):
        self._generate(add_tokens=add_tokens, special_tokens=special_tokens or [],
                       resize=size)

    def add_special_tokens(self, special_tokens, size: int = 0):
        self._generate(special_tokens=special_tokens, resize=size)

    def delete_tokens(self, delete_tokens, size: int = 0):
        self._generate(delete_tokens=delete_tokens, resize=size)

    def modify(self, add_tokens=None, special_tokens=None, delete_tokens=None,
               size: int = 0, reset_token_ids: bool = False):
        self._generate(add_tokens=add_tokens or [], special_tokens=special_tokens or [],
                       delete_tokens=delete_tokens or [], resize=size,
                       reset_token_ids=reset_token_ids)

    def modify_from_yaml(self, yml: bytes, size: int = 0, reset_token_ids: bool = False):
        self._generate(yaml_data=yml, resize=size, reset_token_ids=reset_token_ids)

    def resize(self, size: int):
        self._generate(resize=size)

    def reset_token_ids(self):
        self._generate(reset_token_ids=True)

    def enable_unk_token(self) -> bool:
        """go/tokenmonster.go:2857-2880."""
        if len(self.reverse) == 0:
            self.unk_token = DOES_NOT_EXIST - 1
            return True
        if self.unk_token != DOES_NOT_EXIST:
            return True
        if not can_have_unk_token(self.num_single_byte_tokens(), self.using_capcode):
            return False
        self.vocab_size += 1
        for i, v in enumerate(self.reverse):
            if v is None:
                self.unk_token = i
                return True
        self.unk_token = len(self.reverse)
        self.reverse.append(None)
        return True

    def disable_unk_token(self):
        if self.unk_token == DOES_NOT_EXIST:
            return
        if self.unk_token == len(self.reverse) - 1:
            self.reverse = self.reverse[:self.unk_token]
        self.unk_token = DOES_NOT_EXIST
        if self.vocab_size > 0:
            self.vocab_size -= 1

    # ---------- the builder (go/tokenmonster.go:2898-3801) ----------

    def _generate(self, yaml_data: bytes | None = None, tokens=None, scores=None,
                  add_tokens=None, delete_tokens=None, special_tokens=None,
                  special_tokens_encoded=None, charset: int = 0,
                  normalize_string: str = "", using_capcode: int = 0,
                  level: int = 0, reserve: int = 0, resize: int = 0,
                  reset_token_ids: bool = False):
        tokens = list(tokens or [])
        scores = list(scores or [])
        add_tokens = list(add_tokens or [])
        delete_tokens = list(delete_tokens or [])
        special_tokens = list(special_tokens or [])
        original_special_tokens = list(special_tokens_encoded or [])

        if len(self.tokens) == 0 and self.unk_token == 0:
            self.unk_token = DOES_NOT_EXIST

        enable_unk = False
        display_reserve = 0
        y = None
        from . import yamlio
        if isinstance(yaml_data, yamlio.YamlVocab):
            y = yaml_data
        elif yaml_data is not None and len(yaml_data) > 3:
            y = yamlio.parse(yaml_data)
        if y is not None:
            if y.charset in ("utf8", "utf-8"):
                charset = 1
            elif y.charset in ("utf16", "utf-16"):
                charset = 2
            normalize_string = y.normalization
            using_capcode = max(using_capcode, y.capcode)
            reset_token_ids = reset_token_ids or y.reset_token_ids
            if y.include_256_bytes:
                reserve |= 1
            if y.include_128_bytes:
                reserve |= 2
            if y.include_utf8_bytes:
                reserve |= 4
            if y.include_ascii_bytes:
                reserve |= 8
            if y.include_extended_bytes:
                reserve |= 16
            if y.exclude_other_bytes:
                reserve |= 32
            if y.unk:
                enable_unk = True
                if y.unk_id is not None:
                    if not (0 <= y.unk_id < DOES_NOT_EXIST):
                        raise ValueError("UnkId must be between 0 and 16777213")
                    self.unk_token = y.unk_id
            if y.training_param is not None:
                v16 = y.training_param & 0xFFFF
                if self.level == 0 and level == 0:
                    level = v16 & 7
                display_reserve = (v16 >> 3) & 0xFF
            elif level == 0:
                level = 5

        if len(self.tokens) == 0:
            self.charset = charset
            self.using_capcode = using_capcode
            self.level = level
            self.normalizer = Normalizer(normalize_string or 0)
        else:
            charset = self.charset
            using_capcode = self.using_capcode

        char_table = [False] * 256
        if reserve & 1:
            _gen_256(char_table, using_capcode)
        if reserve & 2:
            _gen_128(char_table, using_capcode)
        if reserve & 4:
            _gen_utf8(char_table, using_capcode)
        if reserve & 8:
            _gen_ascii(char_table, using_capcode)
        if reserve & 16:
            _gen_extended(char_table, using_capcode, self.normalizer)
        exclude_other_bytes = bool(reserve & 32)
        self.reserve |= reserve

        special_map: set[bytes] = set()
        scores_map: dict[bytes, float] = {}
        ids_map: dict[bytes, int] = {}
        used: set[int] = set()
        deleter: set[bytes] = set()
        delete_by_id: set[int] = set()

        if y is not None:
            for item in y.regular:
                tok = item.token_bytes()
                if not tok:
                    continue
                if not item.encoded:
                    tok = normalize_and_capcode(tok, using_capcode, self.normalizer)
                tokens.append(tok)
                if item.score and item.score > 0:
                    scores_map[tok] = item.score
                if item.id is not None:
                    if not (0 <= item.id < DOES_NOT_EXIST - 1):
                        raise ValueError("Id must be between 0 and 16777213")
                    ids_map[tok] = item.id
                    used.add(item.id)
            for item in y.special:
                tok = item.token_bytes()
                if not tok:
                    continue
                if not item.encoded:
                    tok = normalize_and_capcode(tok, using_capcode, self.normalizer)
                original_special_tokens.append(tok)
                if item.score and item.score > 0:
                    scores_map[tok] = item.score
                if item.id is not None:
                    if not (0 <= item.id < DOES_NOT_EXIST - 1):
                        raise ValueError("Id must be between 0 and 16777213")
                    ids_map[tok] = item.id
                    used.add(item.id)
            for item in y.delete:
                tok = item.token_bytes()
                if tok:
                    if not item.encoded:
                        tok = normalize_and_capcode(tok, using_capcode, self.normalizer)
                    deleter.add(tok)
                if item.id is not None:
                    if not (0 <= item.id < DOES_NOT_EXIST - 1):
                        raise ValueError("Id must be between 0 and 16777213")
                    delete_by_id.add(item.id)

        deleted_tokens_set: set[bytes] = set()
        original_tokens: list[bytes] = []
        new_special_tokens: list[bytes] = []

        if len(self.tokens) > 0:
            for i, tok in enumerate(self.tokens):
                sc = float(self.score[i])
                if sc > 0:
                    scores_map[tok] = sc
                tid = int(self.id[i])
                if tok not in ids_map:
                    if tid not in used:
                        ids_map[tok] = tid
                        used.add(tid)
                if tid in delete_by_id:
                    deleted_tokens_set.add(tok)
                else:
                    if len(tok) == 1:
                        if not exclude_other_bytes:
                            char_table[tok[0]] = True
                    elif self.flag[i] & 64:
                        if sc > -0.5:
                            original_special_tokens.append(tok)
                    else:
                        if sc > -0.5:  # negative score marks "duplicate" tokens
                            original_tokens.append(tok)
        for i, sc in enumerate(scores):
            if sc > 0:
                scores_map[tokens[i]] = sc
        for tok, did, dscore in self.deleted:
            if dscore > 0:
                scores_map[tok] = dscore
            if did != DOES_NOT_EXIST:
                if tok not in ids_map and did not in used:
                    ids_map[tok] = did
                    used.add(did)
            deleted_tokens_set.add(tok)

        # Add and delete tokens
        for v in delete_tokens:
            v = bytes(v)
            if 0 < len(v) <= MAX_TOKEN_LEN:
                deleter.add(v)
                deleter.add(normalize_safe(v, using_capcode, self.normalizer))
        for special in special_tokens:
            special = bytes(special)
            if 0 < len(special) <= MAX_TOKEN_LEN:
                special = normalize_and_capcode(special, using_capcode, self.normalizer)
                if special not in deleter:
                    new_special_tokens.append(special)
                    deleter.add(special)
                    special_map.add(special)
        for special in original_special_tokens:
            special = bytes(special)
            if len(special) > 0 and special not in deleter:
                new_special_tokens.append(special)
                deleter.add(special)
                special_map.add(special)

        counter: set[bytes] = set()

        def admit(v: bytes, apply_char_table: bool = True):
            if v in deleter:
                deleted_tokens_set.add(v)
                return
            for special in new_special_tokens:
                if special in v:
                    deleted_tokens_set.add(v)
                    return
            if len(v) == 1:
                if apply_char_table:
                    char_table[v[0]] = True
            else:
                counter.add(v)

        for v in tokens:
            v = bytes(v)
            if 0 < len(v) <= MAX_TOKEN_LEN:
                admit(v, apply_char_table=not exclude_other_bytes)
        for v in original_tokens:
            if len(v) > 0:
                admit(v, apply_char_table=not exclude_other_bytes)
        for v in add_tokens:
            v = bytes(v)
            if len(v) > 0:
                v = normalize_and_capcode(v, using_capcode, self.normalizer)
                if len(v) <= MAX_TOKEN_LEN:
                    if v in deleter:
                        continue
                    if any(special in v for special in new_special_tokens):
                        continue
                    # addTokens is never excluded by exclude-other-bytes
                    admit(v, apply_char_table=True)

        token_list = sorted(counter, key=sort_key)
        single_chars = bytes(i for i in range(256) if char_table[i])
        total = len(token_list) + len(new_special_tokens) + len(single_chars)

        # Resize vocabulary (smaller)  (go :3286-3320)
        if enable_unk or self.unk_token != DOES_NOT_EXIST:
            resize -= 1
        to_delete = total - resize
        if resize > 0 and to_delete > 0:
            token_set = {t: i for i, t in enumerate(token_list)}
            deleted_count = 0
            for target, _sc in sorted(scores_map.items(), key=lambda kv: (kv[1], sort_key(kv[0]))):
                if len(target) == 1:
                    continue
                ii = token_set.get(target)
                if ii is not None and token_list[ii] is not None:
                    deleted_tokens_set.add(target)
                    token_list[ii] = None
                    deleted_count += 1
                if deleted_count >= to_delete:
                    break
            token_list = [t for t in token_list if t is not None]

        # Define deleted tokens  (go :3322-3342)
        self.deleted = []
        for v in sorted(deleted_tokens_set, key=sort_key):
            sc = scores_map.get(v, 0.0)
            idx = ids_map.get(v, DOES_NOT_EXIST)
            if reset_token_ids:
                idx = DOES_NOT_EXIST
            self.deleted.append((v, idx, sc))

        # Resize vocabulary (larger)  (go :3344-3361)
        if resize > 0 and to_delete < 0:
            to_resurrect = min(-to_delete, len(self.deleted))
            order = sorted(range(len(self.deleted)),
                           key=lambda i: (-self.deleted[i][2], i))
            extra = set(token_list)
            for i in order[:to_resurrect]:
                extra.add(self.deleted[i][0])
            token_list = sorted(extra, key=sort_key)

        # Full sorted token list  (go :3363-3378)
        dic1 = sorted(
            set([bytes([b]) for b in single_chars]) | set(token_list)
            | set(t for t in new_special_tokens if len(t) > 0),
            key=sort_key)

        # Determine vocabulary size and set unkToken  (go :3380-3398)
        total = len(dic1)
        if ((reset_token_ids and self.unk_token != DOES_NOT_EXIST)
                or (enable_unk and self.unk_token == DOES_NOT_EXIST)
                or self.unk_token == DOES_NOT_EXIST - 1):
            if total not in used or reset_token_ids:
                self.unk_token = total
            else:
                idx = 0
                while idx in used:
                    idx += 1
                self.unk_token = idx
        if self.unk_token != DOES_NOT_EXIST and not can_have_unk_token(
                len(single_chars), using_capcode):
            self.unk_token = DOES_NOT_EXIST
        if self.unk_token != DOES_NOT_EXIST:
            total += 1
        self.vocab_size = total

        # Highest ID  (go :3401-3418)
        max_id = self.vocab_size
        if reset_token_ids:
            ids_map = {}
            used = set()
        else:
            for idx in ids_map.values():
                if idx + 1 > max_id:
                    max_id = idx + 1
            if self.unk_token != DOES_NOT_EXIST:
                if self.unk_token + 1 > max_id:
                    max_id = self.unk_token + 1
                used.add(self.unk_token)

        # Assign IDs; build the full dictionary incl. "D " duplicates
        # (go :3420-3470)
        dictionary = Dictionary()
        self.reverse = [None] * max_id
        self._decode_cache = None  # _decode_raw's blob/offset view
        add_prefix = bytes([cc.DELETE_TOKEN]) + b" "
        if using_capcode == 1:
            add_prefix = bytes([cc.NO_CAPCODE_DELETE_TOKEN]) + b" "
        next_id = 0
        while next_id in used:
            next_id += 1
        dup_entries: list[tuple[bytes, int]] = []
        has_specials = len(new_special_tokens) > 0
        for token in dic1:
            if token in ids_map:
                index1 = ids_map[token]
                inc = False
            else:
                index1 = next_id
                inc = True
            self.reverse[index1] = token
            dictionary.add(token)
            ids_map[token] = index1
            r, _ = decode_rune(token, charset)
            if using_capcode != 0 and is_alphanum_tm(r, using_capcode):
                s2 = add_prefix + token
                if has_specials and token in special_map:
                    special_map.add(s2)
                if len(s2) <= MAX_TOKEN_LEN:
                    dictionary.add(s2)
                    ids_map[s2] = index1
                    scores_map[s2] = -1.0
                    dup_entries.append((s2, index1))
            if inc:
                next_id += 1
                while next_id in used:
                    next_id += 1
        dictionary.build()

        # deleteToken: index first, ID later  (go :3473-3483)
        self.delete_token = DOES_NOT_EXIST
        delete_index = DOES_NOT_EXIST
        if self.using_capcode == 2:
            idx, found = dictionary.find(bytes([cc.DELETE_TOKEN]))
            if found:
                delete_index = idx
        elif self.using_capcode == 1:
            idx, found = dictionary.find(bytes([cc.NO_CAPCODE_DELETE_TOKEN]))
            if found:
                delete_index = idx

        # Classification + alternatives  (go :3485-3777)
        self.max_token_length = dictionary.longest_length()
        n = len(dictionary)
        self.tokens = dictionary.keys
        self.flag = np.zeros(n, np.uint8)
        self.nwords = np.zeros(n, np.uint8)
        self.index1 = np.full(n, DOES_NOT_EXIST, np.uint32)
        self.index2 = np.full(n, DOES_NOT_EXIST, np.uint32)
        self.len1 = np.zeros(n, np.int32)
        self.len2 = np.zeros(n, np.int32)
        self.id = np.zeros(n, np.uint32)
        self.id1 = np.zeros(n, np.uint32)
        self.id2 = np.zeros(n, np.uint32)
        self.score = np.zeros(n, np.float32)
        for i, token in enumerate(dictionary.keys):
            self.id[i] = ids_map[token]
            self.score[i] = scores_map.get(token, 0.0)

        # The classification + alternatives pass runs in native code when
        # available (tm_build_meta — same computation, ~100x faster; the
        # pure-Python path below is the oracle and covers UTF-16).
        meta = None
        if charset != 2 and not _FORCE_PYTHON_META:
            try:
                from .. import native as _native
                special_mask = None
                if has_specials:
                    special_mask = np.fromiter(
                        (1 if t in special_map else 0 for t in dictionary.keys),
                        np.uint8, count=n)
                meta = _native.native_build_meta(
                    dictionary.keys, using_capcode, special_mask)
            except Exception:
                meta = None
        if meta is not None:
            (self.flag, self.nwords, self.index1, self.index2,
             self.len1, self.len2, self.begin_byte) = meta
            idx1c = np.minimum(self.index1, max(0, n - 1)).astype(np.int64)
            idx2c = np.minimum(self.index2, max(0, n - 1)).astype(np.int64)
            if n:
                self.id1 = np.where(self.len1 > 0, self.id[idx1c], 0).astype(np.uint32)
                self.id2 = np.where(self.len2 > 0, self.id[idx2c], 0).astype(np.uint32)
        else:
            begin_counts = np.zeros((256, 4), np.uint32)
            for i, token in enumerate(dictionary.keys):
                if has_specials and token in special_map:
                    self.flag[i] = 64
                    continue
                flag, nwords, min_alt_size, bucket = classify_token(
                    token, charset, using_capcode)
                begin_counts[token[0]][bucket] += 1
                self.flag[i] = flag
                self.nwords[i] = nwords
                idx1, len1, idx2, len2 = compute_alternatives(
                    token, dictionary, charset, using_capcode, min_alt_size)
                self.index1[i] = idx1
                self.index2[i] = idx2
                self.len1[i] = len1
                self.len2[i] = len2
                if len1 > 0:
                    self.id1[i] = self.id[idx1]
                    if len2 > 0:
                        self.id2[i] = self.id[idx2]

            # beginByte majority vote  (go :3779-3788)
            self.begin_byte = np.zeros(256, np.uint8)
            for i in range(256):
                c = begin_counts[i]
                if c[1] > c[0] and c[1] > c[2] and c[1] > c[3] and c[1] > 2:
                    self.begin_byte[i] = 1          # letter
                elif c[0] > c[1] and c[0] > c[2] and c[0] > c[3] and c[0] > 2:
                    self.begin_byte[i] = 4 + 8      # space
                elif c[3] > c[0] and c[3] > c[1] and c[3] > c[2] and c[3] > 2:
                    self.begin_byte[i] = 2 + 8      # punctuation or capcode

        if delete_index != DOES_NOT_EXIST:
            self.delete_token = int(self.id[delete_index])

        self.dictionary = dictionary
        if self.reserve == 0:
            self.reserve = display_reserve
        self._native_handle = None  # rebuilt lazily against the new arrays

    def _generate_from_parsed_yaml(self, y, resize: int = 0,
                                   reset_token_ids: bool = False):
        """Build from a pre-parsed YamlVocab (bypasses YAML text parsing)."""
        self._generate(yaml_data=y, resize=resize, reset_token_ids=reset_token_ids)

    # ---------- tokenize / decode entry points ----------

    def _native_vocab(self):
        """Lazily-built native tokenizer handle (None if unavailable).

        Invalidated by _generate; the pure-Python loop in core/tokenizer.py
        remains the oracle and is used directly by the parity tests."""
        nv = getattr(self, "_native_handle", None)
        if nv is None:
            try:
                from .. import native
                nv = native.NativeVocab(self)
            except Exception:
                nv = False
            self._native_handle = nv
        return nv or None

    def tokenize(self, data: bytes):
        from .tokenizer import tokenize as _tokenize
        if self.max_token_length == 0:
            return np.zeros(0, np.uint32), 0
        normalized = self.normalize(data)
        nv = self._native_vocab()
        if nv is not None:
            return nv.tokenize(normalized)
        return _tokenize(self, normalized)

    def count(self, data: bytes):
        from .tokenizer import tokenize_count as _count
        if self.max_token_length == 0:
            return 0, 0
        normalized = self.normalize(data)
        nv = self._native_vocab()
        if nv is not None:
            ids, missing = nv.tokenize(normalized)
            return len(ids), missing
        return _count(self, normalized)

    def tokenize_to_serialized(self, data: bytes, encoding_length: int = 0,
                               ):
        from .tokenizer import serialize_tokens
        if encoding_length <= 1:
            encoding_length = 2 if len(self.reverse) <= 65536 else 3
        ids, missing = self.tokenize(data)
        return serialize_tokens(ids, encoding_length), encoding_length, missing

    def deserialize(self, data: bytes, encoding_length: int = 0) -> np.ndarray:
        from .tokenizer import deserialize_tokens
        if encoding_length == 0:
            encoding_length = 2 if len(self.reverse) <= 65536 else 3
        return deserialize_tokens(data, encoding_length)

    def decode(self, tokens) -> bytes:
        data = self._decode_raw(tokens)
        if self.using_capcode == 2:
            return cc.decode(data)
        if self.using_capcode == 1:
            return cc.no_capcode_decode(data)
        return data

    def decode_serialized(self, b: bytes, encoding_length: int = 0) -> bytes:
        return self.decode(self.deserialize(b, encoding_length))

    def _decode_raw(self, tokens) -> bytes:
        """id stream -> concatenated token bytes, vectorised: a cached
        (blob, offsets, lengths) view of the reverse table turns decode into
        two numpy gathers + one repeat (the reference decodes at 163-186
        MB/s natively, tokenmonster-cpp/README.md:70; a per-token Python
        loop is ~100x slower)."""
        ids = np.asarray(tokens).astype(np.int64, copy=False).reshape(-1)
        n_tokens = len(self.reverse)
        if ids.size == 0 or n_tokens == 0:
            return b""
        cache = getattr(self, "_decode_cache", None)
        if cache is None or cache[3] != n_tokens:
            lens = np.fromiter(
                (0 if t is None else len(t) for t in self.reverse),
                np.int64, n_tokens)
            offs = np.zeros(n_tokens + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            blob = np.frombuffer(
                b"".join(t for t in self.reverse if t is not None), np.uint8)
            cache = (blob, offs, lens, n_tokens)
            self._decode_cache = cache
        blob, offs, lens, _ = cache
        valid = (ids >= 0) & (ids < n_tokens)
        if not valid.all():
            ids = ids[valid]
        tl = lens[ids]
        total = int(tl.sum())
        if total == 0:
            return b""
        try:
            from .. import native
            out = native.native_decode(ids, blob, offs, n_tokens, total)
            if out is not None:
                return out
        except Exception:
            pass
        # numpy fallback — source indices: per token t, offs[t] + (0..len-1)
        ends = np.cumsum(tl)
        within = np.arange(total, dtype=np.int64) - np.repeat(ends - tl, tl)
        src = np.repeat(offs[:-1][ids], tl) + within
        return blob[src].tobytes()

    def new_decoder(self):
        from .decoder import StreamDecoder
        return StreamDecoder(self)

    # ---------- YAML ----------

    def export_yaml(self, order_by_score: bool = False) -> bytes:
        from . import yamlio
        return yamlio.export_yaml(self, order_by_score)

    @classmethod
    def from_yaml(cls, yml: bytes) -> "Vocab":
        v = cls()
        v._generate(yaml_data=yml)
        return v

    @classmethod
    def new(cls, tokens, special_tokens, charset: int, normalization: str,
            using_capcode: int, include_256_bytes=False, include_128_bytes=False,
            include_utf8_bytes=False, include_ascii_bytes=False,
            include_extended_bytes=False, exclude_other_bytes=False) -> "Vocab":
        reserve = ((1 if include_256_bytes else 0)
                   | (2 if include_128_bytes else 0)
                   | (4 if include_utf8_bytes else 0)
                   | (8 if include_ascii_bytes else 0)
                   | (16 if include_extended_bytes else 0)
                   | (32 if exclude_other_bytes else 0))
        v = cls()
        v._generate(add_tokens=tokens, special_tokens=special_tokens,
                    charset=charset, normalize_string=normalization,
                    using_capcode=using_capcode, level=5, reserve=reserve,
                    reset_token_ids=True)
        return v
