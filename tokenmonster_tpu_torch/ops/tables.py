"""Device-resident tables of the tokenization kernels.

Port of ``tokenmonster_tpu/ops/scan.py::DeviceVocab`` as the Pallas engine
uses it, without the Aho-Corasick automaton that only the XLA engines read.
The numpy arrays are the JAX package's: the hash-match planes come from
``ops/hashmatch.py`` (this package's copy of the JAX package's numpy CHD
placement), and the few numpy helpers that live in jax-importing modules
there are copied below, each naming its original.
``tests/test_torch_tables.py`` holds every copy equal to its original.
``DeviceTables`` carries them to a device as buffers (a trainer superset
only its match tables); ``CandidateTables`` is one trainer candidate's
masked view of a superset's, in REMAP mode: its own tables at its own
indices, with ``rank`` mapping superset indices to them.
``from_reference_tables`` takes a placement built by the JAX package
(its ``HashMatchTables``) into this package's class, field by field.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ..core.tokenmeta import DOES_NOT_EXIST
from .hashmatch import (SEED, ClassTable, HashMatchTables, build_hashmatch,
                        compose_fields, disp_plane)

# Per-class descriptor layout: the D_* enum of csrc/tm_kernels.cuh.
(D_LEN, D_S, D_BBITS, D_SALT, D_NF, D_FOFF, D_STRIDE, D_DOFF, D_NOVF,
 D_OVF_BYTES, D_OVF_SCALARS, D_NSCALE, D_SCALE) = range(13)
DESC_W = 32
MAX_SCALE = DESC_W - D_SCALE

# Token words are idx | w3 << S (ops/decide.py).  Below MAX_ENTRIES
# dictionary entries S is W3_SHIFT, the JAX package's Pallas words; from
# there S is the fewest bits from W3_SHIFT_WIDE up to ID_BITS that hold
# every dictionary index and the unk and delete ids (``w3_shift``).
# ID_BITS, the format's 24-bit ids, is also the width of the kernels' index
# fields, which hold idx+1 (``tmk::HIT_IDX_BITS`` in csrc/tm_kernels.cuh),
# so a placement holds up to 2^24 - 2 entries (``placement_limit``): every
# vocabulary of the format.
MAX_ENTRIES = 1 << 20
W3_SHIFT = 20
W3_SHIFT_WIDE = 21
ID_BITS = 24


def del_bit(w3_shift: int) -> int:
    """The "delete token follows" marker of a compacted token word, above
    the word's two w3 bits."""
    return 1 << (w3_shift + 2)


def check_w3_shift(w3_shift: int) -> None:
    """Raise for an S that no table takes (``w3_shift``)."""
    if not W3_SHIFT <= w3_shift <= ID_BITS:
        raise ValueError(f"w3_shift {w3_shift} outside [{W3_SHIFT}, "
                         f"{ID_BITS}]")

# The match kernel's key filter: two bits per (key length, key hash), set
# for every key of the placement, so a probe with either bit clear cannot
# hit.  Bit 1: the top bits of x = (h + l*LEN_MULT)*MULT; bit 2: the top
# bits of (x ^ x >> 15) * MULT2 (u32).
FILTER_MULT = 0x27D4EB2F
FILTER_MULT2 = 0x2C1B3C6D
FILTER_LEN_MULT = 0x9E3779B9
FILTER_BITS_PER_KEY = 16
FILTER_MAX_LOG2 = 20        # at most 2^20 bits (128 KiB of shared memory)


def from_reference_tables(tables) -> HashMatchTables:
    """``tables`` as this package's ``HashMatchTables``: returned as it is
    when it is one already; a placement of the JAX package
    (``tokenmonster_tpu.ops.hashmatch.HashMatchTables``, or any dataclass
    with the same fields) is copied field by field, its class tables
    likewise, sharing the numpy arrays.  Raises TypeError for anything
    else."""
    if isinstance(tables, HashMatchTables):
        return tables

    def copy(obj, cls):
        try:
            return cls(**{f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(cls)})
        except AttributeError as e:
            raise TypeError(f"{type(obj).__name__} is not a hash-match "
                            f"placement: {e}") from e

    out = copy(tables, HashMatchTables)
    out.classes = [copy(c, ClassTable) for c in tables.classes]
    return out


def single_tbl(single: np.ndarray, alive: np.ndarray | None = None):
    """(2,128) int32 direct table of idx+1 by byte value; with ``alive``
    (bool per dictionary index) dead entries read 0.
    Copy of ``tokenmonster_tpu/ops/pallas_match.py::_single_tbl`` (numpy
    out)."""
    sv = single.astype(np.int64)
    if alive is not None:
        live = alive[np.maximum(sv, 0)]
        sv = np.where((sv >= 0) & live, sv, -1)
    return (sv + 1).astype(np.int32).reshape(2, 128)


def flat_tables(tables: HashMatchTables, alive: np.ndarray | None = None):
    """The match kernel's table tuple: composed field planes per class,
    displacement planes per class, the single-byte table and (delete-token
    vocabularies) the space-stripped single-byte table.  With ``alive``
    the slots and singles of dead tokens have their indices zeroed: the
    same placement then matches as the sub-dictionary of live tokens.
    Copy of ``tokenmonster_tpu/ops/pallas_match.py::flat_tables`` (numpy
    out)."""
    args = [compose_fields(c, alive) for c in tables.classes]
    args += [disp_plane(c) for c in tables.classes]
    args.append(single_tbl(tables.single, alive))
    if tables.has_space:
        args.append(single_tbl(tables.space_single, alive))
    return tuple(args)


def smem_scalars(tables: HashMatchTables,
                 alive: np.ndarray | None = None) -> np.ndarray:
    """[space_empty+1, then per class per overflow key its main idx+1 (and
    space idx+1 for merged tables)], each 0 when absent or dead in
    ``alive``.
    Copy of ``tokenmonster_tpu/ops/pallas_match.py::smem_scalars``."""
    def live1(i):
        if i < 0 or (alive is not None and not alive[i]):
            return 0
        return i + 1

    out = [live1(tables.space_empty)]
    for c in tables.classes:
        for mi, si in zip(c.ovf_idx, c.ovf_idx_space):
            out.append(live1(mi))
            if tables.has_space:
                out.append(live1(si))
    return np.asarray(out, np.int32)


def build_meta_planes(vocab):
    """Per-token metadata planes keyed by dictionary index:
      0: flag | nwords<<8 | len1<<16 | len2<<24
      1: aflag1 | anw1<<8 | aflag2<<16 | anw2<<24
    Returns (planes (2, R, 128) int32, bb_plane (2, 128) float32).
    Copy of ``tokenmonster_tpu/ops/pallas_decide.py::build_meta_planes``."""
    n = len(vocab.tokens)
    i1c = np.minimum(vocab.index1.astype(np.int64), max(n - 1, 0))
    i2c = np.minimum(vocab.index2.astype(np.int64), max(n - 1, 0))
    has1 = vocab.len1 > 0
    has2 = vocab.len2 > 0
    af1 = np.where(has1, vocab.flag[i1c], 0).astype(np.int64)
    anw1 = np.where(has1, vocab.nwords[i1c], 0).astype(np.int64)
    af2 = np.where(has2, vocab.flag[i2c], 0).astype(np.int64)
    anw2 = np.where(has2, vocab.nwords[i2c], 0).astype(np.int64)
    f0 = (vocab.flag.astype(np.int64)
          | (vocab.nwords.astype(np.int64) << 8)
          | (vocab.len1.astype(np.int64) << 16)
          | (vocab.len2.astype(np.int64) << 24))
    f1 = af1 | (anw1 << 8) | (af2 << 16) | (anw2 << 24)
    R = meta_width(n) // 128
    planes = np.zeros((2, R, 128), np.int32)
    for j, f in enumerate((f0, f1)):
        p = np.zeros(R * 128, np.int32)
        p[:n] = f.astype(np.int32)
        planes[j] = p.reshape(R, 128)
    bb = np.zeros(256, np.float32)
    bb[:] = vocab.begin_byte.astype(np.float32)
    return planes, bb.reshape(2, 128)


E_WORDS = 4   # csrc/tm_kernels.cuh E_WORDS
MAX_TOKEN_LEN = 63   # a match word holds a length in 6 bits


def check_alternative_lengths(planes: np.ndarray) -> None:
    """Raise for planes of ``build_meta_planes`` that hold an alternative
    longer than MAX_TOKEN_LEN: the decide kernel relies on a second token
    lying within 63 positions of its first."""
    f0 = planes[0].reshape(-1).view(np.uint32)
    longest = max(int((f0 >> 16 & 0xFF).max(initial=0)),
                  int((f0 >> 24).max(initial=0)))
    if longest > MAX_TOKEN_LEN:
        raise ValueError(f"an alternative token of {longest} bytes is "
                         f"longer than {MAX_TOKEN_LEN}")


@functools.lru_cache(maxsize=None)
def _entry_luts(rows: int, device: torch.device):
    """``decide_entries``' tables of 256 on ``device``: a first token's
    flag bits by branch and flag byte (3 x 256, flat), and by fd row its
    word-count share by word count and an alternative's length field by
    length; then the byte columns of the two planes in the order flags,
    word counts, lengths, and the three branches' offsets into the
    first."""
    v = np.arange(256, dtype=np.int64)
    bits = (v & 1) << 7 | (v >> 3 & 1) << 8 | (v >> 7) << 9
    first = np.concatenate([bits | (v >> 5 & 1), bits, bits])
    fd = np.arange(rows, dtype=np.int64)[:, None]
    fnw = v[None] - fd
    share = (np.maximum(fnw - 1, 0) + 100 * fnw + 100) << 9
    length = np.maximum(v[None] - fd, 0) << 24
    cols = np.array([0, 4, 6, 1, 5, 7, 2, 3], np.int64)
    branch = np.array([0, 256, 512], np.int64)
    return tuple(torch.from_numpy(a).to(device) for a in (
        first.astype(np.int32), share.astype(np.int32),
        length.astype(np.int32), cols, branch))


def decide_entries(meta: torch.Tensor, rows: int) -> torch.Tensor:
    """The decide kernel's table, (rows, R*128, E_WORDS) int32 on
    ``meta``'s device, from the planes of ``build_meta_planes`` (``meta``,
    (2, R*128), checked by ``check_alternative_lengths``): for fd row
    ``fd`` and a token as the first of branch r (0: the match itself, 1
    and 2: its alternatives), with f the first token's flag and fnw its
    word count less fd, word r is
      bit 0 (word 0)     the match's flag bit 5
      bits 1-2 (word 0)  how many alternatives stand: 0, 1 or 2
      bit 7  f & 1       bit 8  f >> 3 & 1
      bits 9-23          (f >> 7) + max(fnw - 1, 0) + 100 fnw + 100
      bits 24-31 (words 1, 2)  the alternative's length less fd
    (everything of a branch's score that depends on the first token
    alone), and word 3 the token's flag and word count (plane 0's low 16
    bits), which the kernel reads of a second token.  Every field is a
    function of one byte of the planes, so each is read from a table of
    256 (``_entry_luts``): about 20 torch ops, so a candidate's table is
    built on the card from its uploaded planes."""
    first, share, length, cols, branch = _entry_luts(rows, meta.device)
    n = meta.shape[1]
    # the planes' bytes, little endian: flag, nwords, len1, len2 of plane
    # 0, then aflag1, anw1, aflag2, anw2 of plane 1
    b = meta.contiguous().view(torch.uint8).view(2, n, 4).permute(1, 0, 2)
    b = b.reshape(n, 8).long().index_select(1, cols)
    f, nw, lens = b[:, :3], b[:, 3:6], b[:, 6:]
    words = first[f + branch] + share[:, nw]
    words[:, :, 1:] += length[:, lens]
    stands = (lens > 0).int()
    words[:, :, 0] += (stands[:, 0] * (1 + stands[:, 1])) << 1
    second = (meta[0] & 0xFFFF).expand(rows, n)
    return torch.cat([words, second[:, :, None]], dim=-1)


def ids3(vocab) -> np.ndarray:
    """(n, 3) u32 emitted ids of each dictionary index by branch (id, id1,
    id2), as ``tokenmonster_tpu/ops/pallas_decide.py::resolve_tokens``
    builds them."""
    return np.stack([vocab.id, vocab.id1, vocab.id2], axis=1).astype(np.uint32)


def class_descriptors(tables: HashMatchTables, flat: tuple):
    """Flatten the per-class geometry for the match kernel; ``flat`` is
    ``flat_tables(tables)``.

    Returns (desc (n_cls, DESC_W) int32, len_cls (max_len+1,) int32 class of
    each key length or -1, fields int32, disp int32, ovf_keys uint8): the
    class planes concatenated, with each class's offsets in ``desc``.  The
    displacement planes keep only their packed words (one per two
    buckets), not the TPU layout's row padding, so they are compact enough
    for the match kernel to hold in shared memory."""
    classes = tables.classes
    max_len = max((c.length for c in classes), default=0)
    n_idx = 2 if tables.has_space else 1
    desc = np.zeros((len(classes), DESC_W), np.int64)
    len_cls = np.full(max_len + 1, -1, np.int32)
    fields, disp, ovf = [], [], []
    f_off = d_off = o_off = 0
    s_off = 1                      # scalars[0] is space_empty+1
    for ci, c in enumerate(classes):
        planes = flat[ci]
        dp = flat[len(classes) + ci].reshape(-1)[:-(-max(2, 1 << c.b_bits)
                                                   // 2)]
        scale = c.scale
        if len(scale) > MAX_SCALE:
            raise ValueError(f"class {c.length}: {len(scale)} NAF terms of "
                             f"S={c.S} exceed {MAX_SCALE}")
        d = desc[ci]
        d[D_LEN], d[D_S], d[D_BBITS] = c.length, c.S, c.b_bits
        salt = c.salt & 0xFFFFFFFF
        d[D_SALT] = salt - (1 << 32) if salt >= 1 << 31 else salt
        d[D_NF], d[D_FOFF] = c.n_fields, f_off
        d[D_STRIDE], d[D_DOFF] = planes.shape[1] * 128, d_off
        d[D_NOVF], d[D_OVF_BYTES], d[D_OVF_SCALARS] = (len(c.ovf_keys),
                                                       o_off, s_off)
        d[D_NSCALE] = len(scale)
        for i, (k, sign) in enumerate(scale):
            d[D_SCALE + i] = 2 * k + (1 if sign < 0 else 0)
        len_cls[c.length] = ci
        fields.append(planes.reshape(-1))
        disp.append(dp)
        for k in c.ovf_keys:
            ovf.append(np.frombuffer(bytes(k), np.uint8))
        f_off += planes.size
        d_off += dp.size
        o_off += len(c.ovf_keys) * c.length
        s_off += len(c.ovf_keys) * n_idx
    if f_off >= 1 << 31:
        raise ValueError("hash tables exceed 2^31 words")

    def cat(parts, dtype):
        return np.concatenate(parts).astype(dtype) if parts \
            else np.zeros(1, dtype)
    return (desc.astype(np.int32), len_cls, cat(fields, np.int32),
            cat(disp, np.int32), cat(ovf, np.uint8))


def _key_hashes(keys: np.ndarray) -> np.ndarray:
    """``hashmatch.poly_hash`` of each row of a (K, l) uint8 key array."""
    h = np.full(len(keys), SEED, np.uint32)
    for j in range(keys.shape[1]):
        h = h * np.uint32(257) + keys[:, j].astype(np.uint32)
        h ^= h >> np.uint32(11)
    return h


def filter_mix(h: np.ndarray, length: int):
    """The two u32 words whose top bits index a window's filter bits."""
    x = (h + np.uint32((length * FILTER_LEN_MULT) & 0xFFFFFFFF)) \
        * np.uint32(FILTER_MULT)
    return x, (x ^ (x >> np.uint32(15))) * np.uint32(FILTER_MULT2)


def key_filter(tables: HashMatchTables):
    """The match kernel's key filter: (words int32 [2^(log2-5)], log2).  For
    every key of every class (placed or overflow), the two bits at the top
    ``log2`` bits of the words of ``filter_mix(h, l)`` (h the key's poly
    hash, l its length) are set; a text window with either bit clear holds
    no key of that length, so the kernel skips its probe.  About
    FILTER_BITS_PER_KEY bits per key, at most 2^FILTER_MAX_LOG2 bits: at
    16 bits per key two bits leave a false-positive rate near
    (1 - exp(-2/16))^2 = 1.4%.  A trainer superset's filter serves every
    candidate masked from it."""
    parts = []
    for c in tables.classes:
        keys = c.slot_keys[c.occupied].reshape(-1, c.length)
        if c.ovf_keys:
            keys = np.concatenate([keys, np.frombuffer(
                b"".join(bytes(k) for k in c.ovf_keys),
                np.uint8).reshape(-1, c.length)])
        parts += filter_mix(_key_hashes(keys), c.length)
    h = np.concatenate(parts) if parts else np.zeros(0, np.uint32)
    log2 = max(int(len(h) // 2 * FILTER_BITS_PER_KEY - 1).bit_length(), 5)
    log2 = min(log2, FILTER_MAX_LOG2)
    bit = (h >> np.uint32(32 - log2)).astype(np.int64)
    words = np.zeros(1 << (log2 - 5), np.uint32)
    np.bitwise_or.at(words, bit >> 5, np.uint32(1) << (bit & 31).astype(
        np.uint32))
    return words.view(np.int32), log2


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def w3_shift(vocab) -> int:
    """S of ``vocab``'s token words: W3_SHIFT where the JAX package's
    Pallas engine takes the vocabulary (fewer than MAX_ENTRIES entries,
    its unk and delete ids below MAX_ENTRIES:
    ``tokenmonster_tpu/ops/scan.py:512-518``), else the fewest bits from
    W3_SHIFT_WIDE that hold every dictionary index and the unk and delete
    ids (at most ID_BITS)."""
    literals = [int(t) & 0xFFFFFF for t in (vocab.unk_token,
                                            vocab.delete_token)
                if t != DOES_NOT_EXIST]
    n = len(vocab.tokens)
    if n < MAX_ENTRIES and all(t < MAX_ENTRIES for t in literals):
        return W3_SHIFT
    return max(W3_SHIFT_WIDE, max([n - 1, *literals]).bit_length())


def placement_limit() -> int:
    """The most dictionary entries a hash placement holds: the kernels'
    index fields pack idx+1 in ID_BITS bits."""
    return (1 << ID_BITS) - 2


def check_placement(n: int) -> None:
    """Raise for a vocabulary of ``n`` entries that no placement holds."""
    if n > placement_limit():
        raise NotImplementedError(
            f"{n} dictionary entries: the kernels' index fields pack idx+1 "
            f"in {ID_BITS} bits, so a hash placement holds at most "
            f"{placement_limit()} entries")


def meta_width(n: int) -> int:
    """Dictionary slots of ``build_meta_planes`` for ``n`` tokens: rows of
    128, a multiple of 8 rows, at least 8."""
    return max(8, -(-n // 128 // 8) * 8) * 128


def bucket_width(n: int) -> int:
    """Slots of a trainer candidate's padded tables (``CandidateTables``)
    for ``n`` tokens: rows of 128, a power of two of rows, at least 8, as
    the JAX package buckets a REMAP candidate's planes and ids
    (``tokenmonster_tpu/train/score_helpers.py``), so candidates of one
    bucket share a captured score chain."""
    rows = 8
    while rows * 128 < n:
        rows <<= 1
    return rows * 128


def _vocab_config(tabs, vocab, literals: bool = True) -> torch.Tensor:
    """The per-vocabulary kernel scalars: literal ids and row layout.
    ``literals``: check that the unk and delete ids fit the decide
    kernel's literal field of ``tabs.w3_shift`` bits (not for match-only
    superset tables, whose candidates bring their own).  Returns the
    literals the device reads, int32 [unk id, has unk, delete id] on the
    host: decide's unk word and the score epilogue's delete id, read
    through a pointer, so that one captured score chain serves every
    candidate of a superset."""
    tabs.lil_off = 2 if vocab.charset == 2 else 1
    tabs.has_delete = vocab.delete_token != DOES_NOT_EXIST
    tabs.has_unk = vocab.unk_token != DOES_NOT_EXIST
    tabs.unk_token = int(vocab.unk_token) & 0xFFFFFF
    tabs.delete_token = int(vocab.delete_token) & 0xFFFFFF
    for name, tok in (("unk", tabs.unk_token), ("delete", tabs.delete_token)):
        if (literals and getattr(tabs, f"has_{name}")
                and tok >= 1 << tabs.w3_shift):
            raise NotImplementedError(
                f"{name} id {tok} does not fit the {tabs.w3_shift}-bit "
                "literal field of the token words")
    if tabs.has_space != tabs.has_delete:
        raise ValueError("hash tables carry the space-stripped entries "
                         "iff the vocabulary has a delete token")
    return torch.tensor([tabs.unk_token, int(tabs.has_unk),
                         tabs.delete_token], dtype=torch.int32)


class DeviceTables(nn.Module):
    """Every table the four kernels read, as buffers of one module, so
    ``.to(device)`` moves them together.

    Match: the flat composed field planes, displacement planes, the
    single-byte tables, the scalar vector (``smem_scalars``), the class
    descriptors, the overflow keys and the key filter (``key_filter``).
    Decide: the two meta planes (``meta``, what the plain version
    indexes), the kernel's table built from them (``decide_entries``) and
    the begin-byte table.  Id resolution:
    ``ids3``.  ``literals``: the unk id, whether there is an unk token,
    and the delete id (``_vocab_config``).  All integer buffers hold u32
    bit patterns as int32.
    ``w3_shift``: S of the token words (``w3_shift``), which decide,
    follow, compact and id resolution take from here.

    ``match_only`` (a trainer superset) carries the match tables only:
    ``meta``, ``entries``, ``bb`` and ``ids3`` are None, and its
    candidates bring their own at candidate size.  The placement's index
    fields (idx+1) must fit the kernels' ID_BITS bits, or the
    constructor raises."""

    def __init__(self, vocab, tables, match_only: bool = False):
        super().__init__()
        tables = from_reference_tables(tables)
        n = len(vocab.tokens)
        self.n_entries = n
        self.match_only = match_only
        self.rank = None              # the superset's own indices
        n_cls = len(tables.classes)
        self.idx1_bits = tables.classes[0].idx1_bits if n_cls else 21
        check_placement(n)
        if self.idx1_bits > ID_BITS:
            raise NotImplementedError(
                f"the placement packs idx+1 in {self.idx1_bits} bits, wider "
                f"than the kernels' {ID_BITS}-bit index fields")
        self.w3_shift = w3_shift(vocab)
        flat = flat_tables(tables)
        desc, len_cls, fields, disp, ovf = class_descriptors(tables, flat)
        self.register_buffer("fields", _t(fields))
        self.register_buffer("disp", _t(disp))
        self.register_buffer("single", _t(flat[2 * n_cls].reshape(-1)))
        space = (flat[2 * n_cls + 1] if tables.has_space
                 else np.zeros((2, 128), np.int32))
        self.register_buffer("space_single", _t(space.reshape(-1)))
        self.register_buffer("scalars", _t(smem_scalars(tables)))
        self.register_buffer("desc", _t(desc))
        self.register_buffer("len_cls", _t(len_cls))
        self.register_buffer("ovf_keys", _t(ovf))
        filt, self.filt_log2 = key_filter(tables)
        self.register_buffer("filt", _t(filt))
        if self.match_only:
            for name in ("meta", "entries", "bb", "ids3"):
                self.register_buffer(name, None)
        else:
            planes, bb = build_meta_planes(vocab)
            check_alternative_lengths(planes)
            self.register_buffer("meta", _t(planes.reshape(2, -1)))
            self.register_buffer("entries", decide_entries(
                self.meta, 2 if vocab.delete_token != DOES_NOT_EXIST else 1))
            self.register_buffer("bb", _t(bb.reshape(-1).astype(np.int32)))
            self.register_buffer("ids3", _t(ids3(vocab).view(np.int32)))

        # host-side geometry: kernel scalars and the plain versions' loops
        self.classes = tables.classes
        self.max_len = len(len_cls) - 1
        self.has_space = bool(tables.has_space)
        self.register_buffer("literals", _vocab_config(
            self, vocab, literals=not self.match_only))


# The tensors a trainer candidate brings to its superset's match tables
# (``CandidateTables``): what a captured score chain copies in before each
# replay.
PER_CANDIDATE = ("fields", "single", "space_single", "scalars", "meta",
                 "entries", "bb", "ids3", "rank", "literals")


class CandidateTables:
    """A candidate vocabulary seen through its superset's match-only
    ``DeviceTables``, in the JAX package's REMAP mode: the superset's hash
    placement with the candidate's dead tokens masked out, so the match
    kernel runs the candidate with no placement of its own (the trainer's
    per-candidate masking; ``tokenmonster_tpu/train/score_helpers.py``),
    and decide, follow and id resolution on tables of the candidate's own
    size.

    Per candidate, uploaded to the superset's device: the alive-masked
    ``fields``, ``single``, ``space_single`` and ``scalars``, with their
    superset counterparts' shapes and types; its ``meta`` planes (2,
    ``bucket_width(n)``), ``ids3`` (``bucket_width(n)``, 3) and ``bb``,
    at candidate indices, zero past its n entries (its ``entries``,
    (rows, ``bucket_width(n)``, 4), are built there from the planes);
    ``rank``, int32 per superset index, each live index's candidate
    index, through which the tokenizer maps every match word before
    decide (``ops/scan.py::remap_matches``); its unk and delete ids, on
    the host and as ``literals`` on the device.  So every
    tensor of a candidate has a shape fixed by its superset and its
    bucket (``PER_CANDIDATE``), which a captured score chain takes as
    static inputs.  Shared with the superset and never written: ``disp``,
    ``desc``, ``len_cls``, ``ovf_keys``, the key filter and the host
    geometry.  Any other shape raises ValueError; a candidate of
    MAX_ENTRIES entries or more raises
    NotImplementedError: a candidate's token words are W3_SHIFT words, as
    every trainer candidate (a vocabulary of a trainer's size) fits
    them."""

    def __init__(self, base: DeviceTables, vocab, flat: tuple,
                 scalars: np.ndarray, planes: np.ndarray, bb: np.ndarray,
                 ids3_c: np.ndarray, rank: np.ndarray):
        n = len(vocab.tokens)
        if n >= MAX_ENTRIES:
            raise NotImplementedError(
                f"candidate of {n} entries: a candidate's token words pack "
                f"{W3_SHIFT}-bit dictionary indices, so candidates of 2^20 "
                "entries or more are not supported")
        for name in ("disp", "desc", "len_cls", "ovf_keys", "filt",
                     "filt_log2", "classes", "max_len", "idx1_bits",
                     "has_space"):
            setattr(self, name, getattr(base, name))
        n_cls = len(base.classes)
        space = (flat[2 * n_cls + 1] if base.has_space
                 else np.zeros((2, 128), np.int32))
        fields = (np.concatenate([flat[ci].reshape(-1) for ci in range(n_cls)])
                  if n_cls else np.zeros(1, np.int32))
        own = {"fields": fields, "single": flat[2 * n_cls].reshape(-1),
               "space_single": space.reshape(-1), "scalars": scalars,
               "meta": planes.reshape(2, -1),
               "bb": bb.reshape(-1).astype(np.int32),
               "ids3": ids3_c.view(np.int32), "rank": rank}
        want = {k: (tuple(getattr(base, k).shape), getattr(base, k).dtype)
                for k in ("fields", "single", "space_single", "scalars")}
        want.update(meta=((2, bucket_width(n)), torch.int32),
                    bb=((256,), torch.int32),
                    ids3=((bucket_width(n), 3), torch.int32),
                    rank=((base.n_entries,), torch.int32))
        for name, arr in own.items():
            t = _t(arr)
            shape, dtype = want[name]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(
                    f"{name}: candidate {t.dtype}{tuple(t.shape)} differs "
                    f"from the required {dtype}{shape}")
            setattr(self, name, t.to(base.fields.device))
        check_alternative_lengths(planes)
        self.entries = decide_entries(
            self.meta, 2 if vocab.delete_token != DOES_NOT_EXIST else 1)
        self.w3_shift = W3_SHIFT
        self.literals = _vocab_config(self, vocab).to(base.fields.device)


def space_prefix(vocab) -> bytes | None:
    """The virtual space the forward-delete branches probe with, or None
    for a vocabulary without a delete token (as TpuTokenizer picks it)."""
    if vocab.delete_token == DOES_NOT_EXIST:
        return None
    return b" \x00" if vocab.charset == 2 else b" "


def upload_tables(vocab, hashmatch_tables=None, device="cuda",
                  match_only: bool = False) -> DeviceTables:
    """Carry a vocabulary's kernel tables (``match_only``: its match
    tables) to ``device``.  The hash-match tables are a numpy placement
    (``build_hashmatch``): pass one, this package's or the JAX package's
    (``from_reference_tables``), to share one build, or leave None to
    build it here.  A vocabulary of more entries than a placement holds
    (``placement_limit``) raises before anything is built."""
    check_placement(len(vocab.tokens))
    if hashmatch_tables is None:
        hashmatch_tables = build_hashmatch(vocab.tokens,
                                           space_prefix=space_prefix(vocab))
    return DeviceTables(vocab, from_reference_tables(hashmatch_tables),
                        match_only).to(device)
