"""Wire-protocol-compatible RPC server (tokenmonsterserver equivalent).

Implements the stdin/stdout binary protocol of
training/tokenmonsterserver.go:186-288 — 12-byte request header (u8 job,
u32 id, u56 payload length), 9-byte response header (u8 status, u64
length/value), protocol VERSION 5, all 20 job types — so clients written
against the reference server (including the reference Python binding's
``_communicate``) interoperate.

Copy of ``tokenmonster_tpu/server.py``, with one difference: it holds each
vocabulary as this package's ``api.Vocab`` on a ``device`` ("cuda" by
default, "cpu" for the kernels' plain versions), so tokenize requests take
the API's routes, inputs of ``Vocab.TPU_THRESHOLD`` bytes or more the
device path; everything else goes through the vocabulary's ``core``, as
the JAX server's does.  The responses are the JAX server's byte for byte.
"""

from __future__ import annotations

import os
import struct
import sys
import threading
import time

import numpy as np

from .api import Vocab, load, new
from .core.tokenizer import serialize_tokens
from .ops.scan import check_device

HEADER_IS_LENGTH = 0
HEADER_IS_ID = 1
HEADER_IS_EMPTY = 2
HEADER_IS_2VAL = 3
ERROR_ID_DOES_NOT_EXIST = 10
ERROR_ID_IS_UNLOADED = 11
ERROR_FILE_CANNOT_OPEN = 12
ERROR_NORMALIZATION_FAILED = 13
ERROR_READ_FAILED = 14
ERROR_INVALID_JOB = 15
ERROR_YAML_INVALID = 16
VERSION = 5


def _u32(b, off=0):
    return struct.unpack_from("<I", b, off)[0]


def _u64(b, off=0):
    return struct.unpack_from("<Q", b, off)[0]


def _u56(b, off=0):
    return int.from_bytes(b[off:off + 7], "little")


class TokenMonsterServer:
    """In-process server core; transport provided by serve_stdio.  Its
    vocabularies tokenize on ``device`` (raises for "cuda" without a
    card)."""

    def __init__(self, device="cuda"):
        self.device = check_device(device)
        self.vocabs: list[Vocab | None] = []
        self.deleted_vocabs: list[int] = []
        self.decoders: list = []
        self.deleted_decoders: list[int] = []

    # ---- helpers ----

    def _alloc(self, pool, deleted, obj) -> int:
        if deleted:
            i = deleted.pop()
            pool[i] = obj
            return i
        pool.append(obj)
        return len(pool) - 1

    def _vocab(self, vid):
        if vid >= len(self.vocabs):
            return None, bytes([ERROR_ID_DOES_NOT_EXIST]) + bytes(8)
        v = self.vocabs[vid]
        if v is None:
            return None, bytes([ERROR_ID_IS_UNLOADED]) + bytes(8)
        return v, None

    @staticmethod
    def _hdr9(status, value=0):
        return bytes([status]) + struct.pack("<Q", value)

    @staticmethod
    def _hdr9_id(status, value):
        return bytes([status]) + struct.pack("<I", value) + bytes(4)

    @staticmethod
    def _hdr9_2val(status, a, b):
        return bytes([status]) + struct.pack("<II", a, b)

    @staticmethod
    def _encoding_length(vocab):
        return 2 if len(vocab) <= 65536 else 4

    @staticmethod
    def _serialized(vocab: Vocab, data: bytes, encoding_length: int) -> bytes:
        """The ids of ``data`` through ``vocab``'s routes, serialized."""
        ids = None
        if data and vocab.core.max_token_length:
            ids = vocab.tokenize(data)
        return serialize_tokens(np.zeros(0, np.uint32) if ids is None
                                else ids, encoding_length)

    # ---- request handler: returns response bytes ----

    def handle(self, job: int, vid: int, data: bytes) -> bytes:
        if job == 0:
            return self._hdr9_id(HEADER_IS_ID, VERSION)

        if job == 1 or job == 20:  # tokenize / count
            vocab, err = self._vocab(vid)
            if err:
                return err
            n_batches = _u32(data)
            off = 4
            outs = []
            status = HEADER_IS_LENGTH
            enc_len = self._encoding_length(vocab)
            for _ in range(n_batches):
                ln = _u64(data, off)
                off += 8
                body = data[off:off + ln]
                off += ln
                if job == 1:
                    outs.append(self._serialized(vocab, body, enc_len))
                else:
                    n, _miss = vocab.core.count(body)
                    outs.append(n)
            if job == 1:
                payload = struct.pack("<I", n_batches) + b"".join(
                    struct.pack("<Q", len(o)) + o for o in outs)
            else:
                payload = struct.pack("<I", n_batches) + b"".join(
                    struct.pack("<Q", o) for o in outs)
            return self._hdr9(status, len(payload)) + payload

        if job in (2, 3, 4):  # decode, encoding length == job
            vocab, err = self._vocab(vid)
            if err:
                return err
            n_batches = _u32(data)
            off = 4
            outs = []
            for _ in range(n_batches):
                ln = _u64(data, off)
                off += 8
                body = data[off:off + ln]
                off += ln
                outs.append(vocab.core.decode_serialized(body, job))
            payload = struct.pack("<I", n_batches) + b"".join(
                struct.pack("<Q", len(o)) + o for o in outs)
            return self._hdr9(HEADER_IS_LENGTH, len(payload)) + payload

        if job == 5:  # new decoder
            vocab, err = self._vocab(vid)
            if err:
                return err
            did = self._alloc(self.decoders, self.deleted_decoders,
                              vocab.core.new_decoder())
            return self._hdr9_id(HEADER_IS_ID, did)

        if job == 6:  # delete decoder
            if vid < len(self.decoders):
                self.decoders[vid] = None
                self.deleted_decoders.append(vid)
            return self._hdr9(HEADER_IS_EMPTY)

        if job in (7, 8, 9):  # streaming decode, encoding length = job - 5
            if vid >= len(self.decoders) or self.decoders[vid] is None:
                return self._hdr9(ERROR_READ_FAILED)
            out = self.decoders[vid].decode_serialized(data, job - 5)
            return self._hdr9(HEADER_IS_LENGTH, len(out)) + out

        if job == 10:  # load vocab
            ln = data[0]
            fname = data[1:1 + ln].decode("utf-8")
            try:
                vocab = load(fname, device=self.device)
            except Exception:
                return self._hdr9(ERROR_FILE_CANNOT_OPEN)
            nid = self._alloc(self.vocabs, self.deleted_vocabs, vocab)
            return self._hdr9_id(HEADER_IS_ID, nid)

        if job == 11:  # unload vocab
            if vid < len(self.vocabs):
                self.vocabs[vid] = None
                self.deleted_vocabs.append(vid)
            return self._hdr9(HEADER_IS_EMPTY)

        if job == 12:  # save vocab
            vocab, err = self._vocab(vid)
            if err:
                return err
            ln = data[0]
            fname = data[1:1 + ln].decode("utf-8")
            try:
                vocab.save(fname)
            except OSError:
                return self._hdr9(ERROR_FILE_CANNOT_OPEN)
            return self._hdr9(HEADER_IS_EMPTY)

        if job == 14:  # modify vocab
            vocab, err = self._vocab(vid)
            if err:
                return err
            reset_ids = data[0] == 1
            if data[1] == 1:
                vocab.disable_unk_token()
            elif data[1] == 2:
                vocab.enable_unk_token()
            off = 2

            def read_list(off):
                n = _u32(data, off)
                off += 4
                out = []
                for _ in range(n):
                    ln = data[off]
                    out.append(data[off + 1:off + 1 + ln])
                    off += 1 + ln
                return out, off
            to_add, off = read_list(off)
            to_delete, off = read_list(off)
            to_add_special, off = read_list(off)
            resize = _u32(data, off)
            if to_add or to_delete or to_add_special or resize or reset_ids:
                vocab.modify(add_special_tokens=to_add_special,
                             add_regular_tokens=to_add,
                             delete_tokens=to_delete, resize=resize,
                             reset_token_ids=reset_ids)
            return self._hdr9_2val(HEADER_IS_2VAL, len(vocab),
                                   vocab.core.highest_token_id() + 1)

        if job == 15:  # list tokens detailed
            vocab, err = self._vocab(vid)
            if err:
                return err
            info = vocab.core.tokens_detailed()
            parts = [struct.pack("<I", len(info))]
            for v in info:
                raw = v["token"]
                dec = v["token_decoded"]
                parts.append(struct.pack("<I", v["id"]))
                parts.append(bytes([len(raw), len(dec), v["type"]]))
                parts.append(struct.pack("<f", v["score"]))
                parts.append(raw)
                parts.append(dec)
            payload = b"".join(parts)
            return self._hdr9(HEADER_IS_LENGTH, len(payload)) + payload

        if job == 16:  # delete token by id
            vocab, err = self._vocab(vid)
            if err:
                return err
            vocab.delete_token_by_id(_u32(data))
            return self._hdr9_2val(HEADER_IS_2VAL, len(vocab),
                                   vocab.core.highest_token_id() + 1)

        if job == 17:  # modify by YAML
            vocab, err = self._vocab(vid)
            if err:
                return err
            try:
                vocab.modify_from_yaml(data)
            except Exception:
                return self._hdr9(ERROR_YAML_INVALID)
            return self._hdr9_2val(HEADER_IS_2VAL, len(vocab),
                                   vocab.core.highest_token_id() + 1)

        if job == 18:  # new vocab from YAML
            try:
                vocab = new(data, device=self.device)
            except Exception:
                return self._hdr9(ERROR_YAML_INVALID)
            nid = self._alloc(self.vocabs, self.deleted_vocabs, vocab)
            core = vocab.core
            temp = bytes([core.using_capcode, core.charset,
                          core.normalizer.flag, core.level])
            temp += struct.pack("<IIII", len(core), nid,
                                core.unk_token & 0xFFFFFFFF,
                                core.highest_token_id() + 1)
            return self._hdr9(HEADER_IS_LENGTH, 20) + temp

        if job == 19:  # export YAML
            vocab, err = self._vocab(vid)
            if err:
                return err
            out = vocab.export_yaml(len(data) > 0 and data[0] == 1)
            return self._hdr9(HEADER_IS_LENGTH, len(out)) + out

        return self._hdr9(ERROR_INVALID_JOB)


def serve_stdio(idle_exit_seconds: int | None = None, device="cuda"):
    """Serve the protocol over stdin/stdout (like the reference subprocess),
    tokenizing on ``device``.

    The reference's zombie controller self-kills when the parent is gone and
    the server has been idle 6h (tokenmonsterserver.go:144-156); pass
    ``idle_exit_seconds`` to enable equivalent behaviour."""
    server = TokenMonsterServer(device)
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    last_access = time.time()

    if idle_exit_seconds:
        def zombie():
            while True:
                time.sleep(60)
                if (time.time() - last_access > idle_exit_seconds
                        or os.getppid() == 1):
                    os._exit(0)
        threading.Thread(target=zombie, daemon=True).start()

    while True:
        header = stdin.read(12)
        if len(header) < 12:
            return
        job = header[0]
        vid = _u32(header, 1)
        length = _u56(header, 5)
        data = stdin.read(length) if length else b""
        resp = server.handle(job, vid, data)
        stdout.write(resp)
        stdout.flush()
        last_access = time.time()
