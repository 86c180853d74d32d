"""Device-resident tables of the tokenization kernels.

Port of ``tokenmonster_tpu/ops/scan.py::DeviceVocab`` as the Pallas engine
uses it, without the Aho-Corasick automaton that only the XLA engines read.
The numpy arrays are the JAX package's own: the hash-match planes come from
``tokenmonster_tpu.ops.hashmatch`` (imported, framework-free), and the few
numpy helpers that live in jax-importing modules are copied below, each
naming its original.  ``tests/test_torch_tables.py`` holds every copy equal
to its original.  ``DeviceTables`` carries them to a device as buffers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tokenmonster_tpu.core.tokenmeta import DOES_NOT_EXIST
from tokenmonster_tpu.ops.hashmatch import (HashMatchTables, build_hashmatch,
                                            compose_fields, disp_plane)

# Per-class descriptor layout: the D_* enum of csrc/tm_kernels.cuh.
(D_LEN, D_S, D_BBITS, D_SALT, D_NF, D_FOFF, D_STRIDE, D_DOFF, D_NOVF,
 D_OVF_BYTES, D_OVF_SCALARS, D_NSCALE, D_SCALE) = range(13)
DESC_W = 32
MAX_SCALE = DESC_W - D_SCALE


def single_tbl(single: np.ndarray) -> np.ndarray:
    """(2,128) int32 direct table of idx+1 by byte value.
    Copy of ``tokenmonster_tpu/ops/pallas_match.py::_single_tbl`` (without
    the trainer's per-candidate ``alive`` mask)."""
    sv = single.astype(np.int64)
    return (sv + 1).astype(np.int32).reshape(2, 128)


def flat_tables(tables: HashMatchTables) -> tuple:
    """The match kernel's table tuple: composed field planes per class,
    displacement planes per class, the single-byte table and (delete-token
    vocabularies) the space-stripped single-byte table.
    Copy of ``tokenmonster_tpu/ops/pallas_match.py::flat_tables`` (numpy
    out, without ``alive``)."""
    args = [compose_fields(c) for c in tables.classes]
    args += [disp_plane(c) for c in tables.classes]
    args.append(single_tbl(tables.single))
    if tables.has_space:
        args.append(single_tbl(tables.space_single))
    return tuple(args)


def smem_scalars(tables: HashMatchTables) -> np.ndarray:
    """[space_empty+1, then per class per overflow key its main idx+1 (and
    space idx+1 for merged tables)], each 0 when absent.
    Copy of ``tokenmonster_tpu/ops/pallas_match.py::smem_scalars`` (without
    ``alive``)."""
    se = tables.space_empty
    out = [se + 1 if se >= 0 else 0]
    for c in tables.classes:
        for mi, si in zip(c.ovf_idx, c.ovf_idx_space):
            out.append(mi + 1 if mi >= 0 else 0)
            if tables.has_space:
                out.append(si + 1 if si >= 0 else 0)
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
    class planes concatenated, with each class's offsets in ``desc``."""
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
        dp = flat[len(classes) + ci].reshape(-1)
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


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


class DeviceTables(nn.Module):
    """Every table the four kernels read, as buffers of one module, so
    ``.to(device)`` moves them together.

    Match: the flat composed field planes, displacement planes, the
    single-byte tables, the scalar vector (``smem_scalars``), the class
    descriptors and the overflow keys.  Decide: the two meta planes and the
    begin-byte table.  Id resolution: ``ids3``.  All integer buffers hold
    u32 bit patterns as int32."""

    def __init__(self, vocab, tables: HashMatchTables):
        super().__init__()
        if len(vocab.tokens) >= 1 << 20:
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
        planes, bb = build_meta_planes(vocab)
        self.register_buffer("meta", _t(planes.reshape(2, -1)))
        self.register_buffer("bb", _t(bb.reshape(-1).astype(np.int32)))
        self.register_buffer("ids3", _t(ids3(vocab).view(np.int32)))

        # host-side geometry: kernel scalars and the plain versions' loops
        self.classes = tables.classes
        self.max_len = len(len_cls) - 1
        self.idx1_bits = tables.classes[0].idx1_bits if n_cls else 21
        self.has_space = bool(tables.has_space)
        self.lil_off = 2 if vocab.charset == 2 else 1
        self.has_delete = vocab.delete_token != DOES_NOT_EXIST
        self.has_unk = vocab.unk_token != DOES_NOT_EXIST
        self.unk_token = int(vocab.unk_token) & 0xFFFFFF
        self.delete_token = int(vocab.delete_token) & 0xFFFFFF
        for name, tok in (("unk", self.unk_token),
                          ("delete", self.delete_token)):
            if getattr(self, f"has_{name}") and tok >= 1 << 20:
                raise NotImplementedError(
                    f"{name} id {tok} does not fit the 20-bit literal field")
        if self.has_space != self.has_delete:
            raise ValueError("hash tables carry the space-stripped entries "
                             "iff the vocabulary has a delete token")


def space_prefix(vocab) -> bytes | None:
    """The virtual space the forward-delete branches probe with, or None
    for a vocabulary without a delete token (as TpuTokenizer picks it)."""
    if vocab.delete_token == DOES_NOT_EXIST:
        return None
    return b" \x00" if vocab.charset == 2 else b" "


def upload_tables(vocab, hashmatch_tables: HashMatchTables | None = None,
                  device="cpu") -> DeviceTables:
    """Carry a vocabulary's kernel tables to ``device``.  The hash-match
    tables are the JAX package's numpy tables (``build_hashmatch``); pass
    them to share one build with it, or leave None to build them here."""
    if hashmatch_tables is None:
        hashmatch_tables = build_hashmatch(vocab.tokens,
                                           space_prefix=space_prefix(vocab))
    return DeviceTables(vocab, hashmatch_tables).to(device)
