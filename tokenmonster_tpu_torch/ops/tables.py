"""Device-resident tables of the tokenization kernels.

Port of ``tokenmonster_tpu/ops/scan.py::DeviceVocab`` as the Pallas engine
uses it, without the Aho-Corasick automaton that only the XLA engines read.
The numpy arrays are the JAX package's: the hash-match planes come from
``ops/hashmatch.py`` (this package's copy of the JAX package's numpy CHD
placement), and the few numpy helpers that live in jax-importing modules
there are copied below, each naming its original.
``tests/test_torch_tables.py`` holds every copy equal to its original.
``DeviceTables`` carries them to a device as buffers; ``CandidateTables``
is one trainer candidate's masked view of a superset's.
``from_reference_tables`` takes a placement built by the JAX package
(its ``HashMatchTables``) into this package's class, field by field.
"""

from __future__ import annotations

import dataclasses

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

MAX_ENTRIES = 1 << 20   # token words pack 20-bit dictionary indices
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
    R = max(8, -(-n // 128 // 8) * 8)
    planes = np.zeros((2, R, 128), np.int32)
    for j, f in enumerate((f0, f1)):
        p = np.zeros(R * 128, np.int32)
        p[:n] = f.astype(np.int32)
        planes[j] = p.reshape(R, 128)
    bb = np.zeros(256, np.float32)
    bb[:] = vocab.begin_byte.astype(np.float32)
    return planes, bb.reshape(2, 128)


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


def _vocab_config(tabs, vocab) -> None:
    """The per-vocabulary kernel scalars: literal ids and row layout."""
    tabs.lil_off = 2 if vocab.charset == 2 else 1
    tabs.has_delete = vocab.delete_token != DOES_NOT_EXIST
    tabs.has_unk = vocab.unk_token != DOES_NOT_EXIST
    tabs.unk_token = int(vocab.unk_token) & 0xFFFFFF
    tabs.delete_token = int(vocab.delete_token) & 0xFFFFFF
    for name, tok in (("unk", tabs.unk_token), ("delete", tabs.delete_token)):
        if getattr(tabs, f"has_{name}") and tok >= MAX_ENTRIES:
            raise NotImplementedError(
                f"{name} id {tok} does not fit the 20-bit literal field")
    if tabs.has_space != tabs.has_delete:
        raise ValueError("hash tables carry the space-stripped entries "
                         "iff the vocabulary has a delete token")


class DeviceTables(nn.Module):
    """Every table the four kernels read, as buffers of one module, so
    ``.to(device)`` moves them together.

    Match: the flat composed field planes, displacement planes, the
    single-byte tables, the scalar vector (``smem_scalars``), the class
    descriptors, the overflow keys and the key filter (``key_filter``).  Decide: the two meta planes and the
    begin-byte table.  Id resolution: ``ids3``.  All integer buffers hold
    u32 bit patterns as int32."""

    def __init__(self, vocab, tables):
        super().__init__()
        tables = from_reference_tables(tables)
        if len(vocab.tokens) >= MAX_ENTRIES:
            raise NotImplementedError(
                "token words pack 20-bit dictionary indices: vocabularies "
                "of 2^20 entries or more are not supported yet")
        flat = flat_tables(tables)
        desc, len_cls, fields, disp, ovf = class_descriptors(tables, flat)
        n_cls = len(tables.classes)
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
        planes, bb = build_meta_planes(vocab)
        self.register_buffer("meta", _t(planes.reshape(2, -1)))
        self.register_buffer("bb", _t(bb.reshape(-1).astype(np.int32)))
        self.register_buffer("ids3", _t(ids3(vocab).view(np.int32)))

        # host-side geometry: kernel scalars and the plain versions' loops
        self.classes = tables.classes
        self.max_len = len(len_cls) - 1
        self.idx1_bits = tables.classes[0].idx1_bits if n_cls else 21
        self.has_space = bool(tables.has_space)
        _vocab_config(self, vocab)


class CandidateTables:
    """A candidate vocabulary seen through its superset's ``DeviceTables``:
    the superset's hash placement with the candidate's dead tokens masked
    out, so the match and decide kernels run the candidate at superset
    dictionary positions with no placement of its own (the trainer's
    per-candidate masking; ``tokenmonster_tpu/train/score_helpers.py``).

    Per candidate, uploaded to the superset's device: the alive-masked
    ``fields``, ``single``, ``space_single`` and ``scalars``; the
    candidate's ``meta`` planes and ``ids3`` at superset positions and its
    ``bb``; its unk and delete ids.  Shared with the superset and never
    written: ``disp``, ``desc``, ``len_cls``, ``ovf_keys``, the key filter
    and the host geometry.  Every per-candidate tensor has its superset counterpart's
    shape and type, or the constructor raises: the geometry never changes
    between candidates."""

    def __init__(self, base: DeviceTables, vocab, flat: tuple,
                 scalars: np.ndarray, planes: np.ndarray, bb: np.ndarray,
                 ids3_sup: np.ndarray):
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
               "ids3": ids3_sup.view(np.int32)}
        for name, arr in own.items():
            sup = getattr(base, name)
            t = _t(arr)
            if t.shape != sup.shape or t.dtype != sup.dtype:
                raise ValueError(
                    f"{name}: candidate {t.dtype}{tuple(t.shape)} differs "
                    f"from the superset's {sup.dtype}{tuple(sup.shape)}")
            setattr(self, name, t.to(sup.device))
        _vocab_config(self, vocab)


def space_prefix(vocab) -> bytes | None:
    """The virtual space the forward-delete branches probe with, or None
    for a vocabulary without a delete token (as TpuTokenizer picks it)."""
    if vocab.delete_token == DOES_NOT_EXIST:
        return None
    return b" \x00" if vocab.charset == 2 else b" "


def upload_tables(vocab, hashmatch_tables=None, device="cpu") -> DeviceTables:
    """Carry a vocabulary's kernel tables to ``device``.  The hash-match
    tables are a numpy placement (``build_hashmatch``): pass one, this
    package's or the JAX package's (``from_reference_tables``), to share
    one build, or leave None to build it here."""
    if hashmatch_tables is None:
        hashmatch_tables = build_hashmatch(vocab.tokens,
                                           space_prefix=space_prefix(vocab))
    return DeviceTables(vocab, from_reference_tables(hashmatch_tables)).to(
        device)
