"""ctypes loader/builder for the native host runtime (tm_native.cpp).

Copy of ``tokenmonster_tpu/native/__init__.py`` for this package.  The C++
source began as the JAX package's; its encoders size their output from
the encoding, the id scans bound their buffers, and the capcode encoder
copies the runs between the bytes that need a decision.  The library is
built with g++ on first use into
``build/tokenmonster_tpu_torch/native/<hash>/`` under the repository root
(the hash covers the source, the flags and the host CPU, since the build
targets ``-march=native``).  Builds are serialized across processes by an
``fcntl`` lock and write through a per-process temporary file, so processes
that start at once (test workers on a fresh checkout) cannot break each
other's build; a failed first load is retried once under the lock.

``get_lib`` returns None when the library cannot be built, and the core
modules then take their pure-Python paths, as in the JAX package.  The
device path and the trainer reach the library through ``load_native`` and
``NativeVocab``, which raise instead: they have no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import subprocess
import threading

import numpy as np

from .. import tracing

_lock = threading.Lock()
_lib = None
_tables_set = False
_tables_refs = []

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tm_native.cpp")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "tokenmonster_tpu_torch", "native")
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared",
             "-std=c++17", "-pthread")


def _cpu_tag() -> str:
    """The host CPU's model and feature flags: a -march=native build is
    reused only on the CPU it was built for."""
    try:
        with open("/proc/cpuinfo") as f:
            info = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(info)))
    except OSError:
        return platform.processor() or platform.machine()


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                       + _cpu_tag().encode() + b"\0")
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "tm_native.so")


def _build_lib():
    """Compile the library unless this hash is built already; the caller
    holds the build lock."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC], check=True,
                   capture_output=True)
    os.replace(tmp, so)
    return so


def _load(so):
    lib = ctypes.CDLL(so)
    lib.tm_vocab_new.restype = ctypes.c_void_p
    lib.tm_vocab_new.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int]
    lib.tm_vocab_free.argtypes = [ctypes.c_void_p]
    lib.tm_tokenize.restype = ctypes.c_int64
    lib.tm_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.tm_tokenize_parallel.restype = ctypes.c_int64
    lib.tm_tokenize_parallel.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.tm_tokenize_score.restype = ctypes.c_int64
    lib.tm_tokenize_score.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.tm_ac_build.restype = ctypes.c_void_p
    lib.tm_ac_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.tm_ac_states.restype = ctypes.c_uint32
    lib.tm_ac_states.argtypes = [ctypes.c_void_p]
    lib.tm_ac_export.restype = None
    lib.tm_ac_export.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.tm_ac_free.argtypes = [ctypes.c_void_p]
    lib.tm_build_meta.restype = None
    lib.tm_build_meta.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.tm_set_tables.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.tm_sorted_windows.restype = None
    lib.tm_sorted_windows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    lib.tm_capcode_encode.restype = ctypes.c_int64
    lib.tm_capcode_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p]
    lib.tm_nocapcode_encode.restype = ctypes.c_int64
    lib.tm_nocapcode_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p]
    for name in ("tm_capcode_decode", "tm_nocapcode_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
    lib.tm_decode.restype = ctypes.c_int64
    lib.tm_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p]
    lib.tm_filter_batch.restype = None
    lib.tm_filter_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    return lib


def get_lib():
    """Load (building if needed) the native library; None if unavailable.
    A failed first attempt is retried once, under the build lock."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib if _lib != "unavailable" else None
        os.makedirs(BUILD_ROOT, exist_ok=True)
        err = None
        with open(os.path.join(BUILD_ROOT, "build.lock"), "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            for _attempt in range(2):
                try:
                    _lib = _load(_build_lib())
                    return _lib
                except Exception as e:     # noqa: BLE001 - logged below
                    err = e
        logging.getLogger(__name__).warning(
            "native tm_native build/load failed (%s); pure-Python oracle "
            "paths remain functional but are much slower", err)
        _lib = "unavailable"
        return None


def load_native():
    """The native library, built if needed.  Raises RuntimeError when it
    cannot be built or loaded: the device path and the trainer have no
    pure-Python fallback."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {library_path()} "
                           "could not be built with g++ or loaded")
    return lib


def ensure_tables(lib) -> bool:
    """Upload the Unicode classification tables (once per process)."""
    global _tables_set
    if _tables_set:
        return True
    from ..utils import chartypes as ct
    props = np.ascontiguousarray(ct.props_table())
    lower = np.ascontiguousarray(ct.lower_table())
    upper = np.ascontiguousarray(ct.upper_table())
    _tables_refs.extend([props, lower, upper])  # keep alive
    lib.tm_set_tables(props.ctypes.data, lower.ctypes.data, upper.ctypes.data)
    _tables_set = True
    return True


class NativeVocab:
    """Native tokenizer handle for a core Vocab."""

    def __init__(self, vocab):
        self._lib = lib = load_native()
        n = len(vocab.tokens)
        offs = np.zeros(n + 1, np.uint32)
        for i, t in enumerate(vocab.tokens):
            offs[i + 1] = offs[i] + len(t)
        blob = np.frombuffer(b"".join(vocab.tokens), np.uint8) if n else \
            np.zeros(0, np.uint8)
        arrs = dict(
            blob=np.ascontiguousarray(blob),
            offs=np.ascontiguousarray(offs),
            flag=np.ascontiguousarray(vocab.flag),
            nwords=np.ascontiguousarray(vocab.nwords),
            index1=np.ascontiguousarray(vocab.index1),
            index2=np.ascontiguousarray(vocab.index2),
            len1=np.ascontiguousarray(vocab.len1),
            len2=np.ascontiguousarray(vocab.len2),
            id=np.ascontiguousarray(vocab.id),
            id1=np.ascontiguousarray(vocab.id1),
            id2=np.ascontiguousarray(vocab.id2),
            bb=np.ascontiguousarray(vocab.begin_byte),
        )
        self._keepalive = arrs
        self._handle = lib.tm_vocab_new(
            arrs["blob"].ctypes.data, arrs["offs"].ctypes.data, n,
            arrs["flag"].ctypes.data, arrs["nwords"].ctypes.data,
            arrs["index1"].ctypes.data, arrs["index2"].ctypes.data,
            arrs["len1"].ctypes.data, arrs["len2"].ctypes.data,
            arrs["id"].ctypes.data, arrs["id1"].ctypes.data,
            arrs["id2"].ctypes.data, arrs["bb"].ctypes.data,
            vocab.max_token_length, vocab.delete_token, vocab.unk_token,
            vocab.charset)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tm_vocab_free(handle)
            self._handle = None

    def tokenize(self, data: bytes, threads: int | None = None):
        """Tokenize normalized bytes; returns (ids uint32 array, missing).

        Large inputs are scanned thread-parallel with exact speculative
        stitching (identical output to the sequential scan)."""
        n = len(data)
        if n == 0:
            return np.zeros(0, np.uint32), 0
        buf = np.frombuffer(bytes(data), np.uint8)
        # a scan emits at most 3 ids a byte (tm_native.cpp, id_bound); the
        # pages past the ids written are never touched
        out = np.empty(id_bound(n), np.uint32)
        missing = ctypes.c_int64(0)
        if threads is None:
            threads = os.cpu_count() or 1
        if threads > 1 and n >= 64 * 1024:
            count = self._lib.tm_tokenize_parallel(
                self._handle, buf.ctypes.data, n, out.ctypes.data, len(out),
                ctypes.byref(missing), threads)
        else:
            count = self._lib.tm_tokenize(
                self._handle, buf.ctypes.data, n, out.ctypes.data, len(out),
                ctypes.byref(missing))
        _check_scan(count, n)
        return out[:count].copy(), int(missing.value)


def id_bound(n: int) -> int:
    """Ids a scan of ``n`` bytes can emit (``id_bound`` in tm_native.cpp,
    with its proof): 3 a byte."""
    return 3 * n + 8


def _check_scan(count: int, n: int) -> None:
    if count < 0:
        raise RuntimeError(f"the native scan of {n} bytes reached "
                           f"{id_bound(n)} ids, its bound for a scan that "
                           "ends: it would not have ended")


def _add_score_method():
    def tokenize_score(self, data: bytes, score_acc: np.ndarray,
                       miss_mask: np.ndarray | None = None):
        """Trainer scoring pass: accumulates chars-covered per token id into
        score_acc (int64, len >= max id + 1).  Returns (tokensInText,
        missing).  miss_mask (uint8[256], optional) is set at the byte
        values found at unmatched positions (reference worker semantics)."""
        n = len(data)
        if n == 0:
            return 0, 0
        buf = np.frombuffer(bytes(data), np.uint8)
        missing = ctypes.c_int64(0)
        mm_ptr = miss_mask.ctypes.data if miss_mask is not None else None
        n_tokens = self._lib.tm_tokenize_score(
            self._handle, buf.ctypes.data, n, score_acc.ctypes.data,
            ctypes.byref(missing), mm_ptr)
        _check_scan(n_tokens, n)
        return int(n_tokens), int(missing.value)
    NativeVocab.tokenize_score = tokenize_score


def native_ac_build(keys: list, indices, lengths):
    """Build the dense reversed-key AC DFA natively.

    Returns (dfa uint32[n_states*257], out uint32[n_states], n_states) or
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(keys)
    offs = np.zeros(n + 1, np.uint32)
    for i, t in enumerate(keys):
        offs[i + 1] = offs[i] + len(t)
    blob = np.ascontiguousarray(
        np.frombuffer(b"".join(keys), np.uint8) if n else np.zeros(0, np.uint8))
    idx = np.ascontiguousarray(np.asarray(indices, np.uint32))
    lens = np.ascontiguousarray(np.asarray(lengths, np.uint32))
    h = lib.tm_ac_build(blob.ctypes.data, offs.ctypes.data, n,
                        idx.ctypes.data, lens.ctypes.data)
    n_states = lib.tm_ac_states(h)
    dfa = np.empty(n_states * 257, np.uint32)
    out = np.empty(n_states, np.uint32)
    lib.tm_ac_export(h, dfa.ctypes.data, out.ctypes.data)
    lib.tm_ac_free(h)
    return dfa, out, int(n_states)


def native_sorted_windows(data: np.ndarray, n: int, width: int,
                          threads: int | None = None):
    """Order positions 0..n-1 of ``data`` by their width-byte window and
    return (order uint32[n], first_diff uint8[n-1]) — the bounded suffix
    sort behind the getalltokens counting engine (tm_sorted_windows).
    ``data`` is uint8 with at least n + width bytes; returns None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if threads is None:
        threads = os.cpu_count() or 1
    # native packing loads 8-byte words: give it 8 bytes of slack
    buf = np.zeros(n + width + 8, np.uint8)
    buf[:min(len(data), n + width)] = data[:n + width]
    order = np.empty(n, np.uint32)
    fd = np.empty(max(n - 1, 0), np.uint8)
    lib.tm_sorted_windows(buf.ctypes.data, n, width, threads,
                          order.ctypes.data, fd.ctypes.data)
    return order, fd


def native_capcode_encode(data: bytes) -> bytes | None:
    """Into a buffer of 2n + 16 bytes, or, where the encoding is longer
    (capcode can triple a text: "1a" encodes as "D 1D a"; the encoder
    then writes no byte past the buffer and returns the length), once more
    into one of the length it returned.  The encoder's call is the span
    ``runs``, whose ``n`` is the input bytes it copied as runs."""
    lib = get_lib()
    if lib is None:
        return None
    ensure_tables(lib)
    n = len(data)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(2 * n + 16, np.uint8)
    runs = ctypes.c_int64(0)
    with tracing.span("runs") as span:
        m = lib.tm_capcode_encode(src.ctypes.data, n, out.ctypes.data,
                                  len(out), ctypes.byref(runs))
        if m > len(out):
            out = np.empty(m, np.uint8)
            m = lib.tm_capcode_encode(src.ctypes.data, n, out.ctypes.data,
                                      m, ctypes.byref(runs))
        span.n = runs.value
    return out[:m].tobytes()


def native_nocapcode_encode(data: bytes) -> bytes | None:
    """Into a buffer of 3n + 16 bytes: each code point is copied after at
    most one two-byte marker."""
    lib = get_lib()
    if lib is None:
        return None
    ensure_tables(lib)
    n = len(data)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(3 * n + 16, np.uint8)
    m = lib.tm_nocapcode_encode(src.ctypes.data, n, out.ctypes.data)
    return out[:m].tobytes()


def native_decode(ids: np.ndarray, blob: np.ndarray, offs: np.ndarray,
                  n_tokens: int, total: int):
    """id stream -> concatenated token bytes via tm_decode.  ``offs`` is
    int64[n_tokens+1]; ``total`` an upper bound on output bytes.  Returns
    bytes or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, np.uint32)
    out = np.empty(max(total, 1), np.uint8)
    m = lib.tm_decode(ids.ctypes.data, len(ids), blob.ctypes.data,
                      offs.ctypes.data, n_tokens, out.ctypes.data)
    return out[:m].tobytes()


def native_filter_batch(keys2d: np.ndarray, level: int, charset: int,
                        capcode: int, words_per_token: int = 0,
                        threads: int | None = None):
    """Batch mode-filter classification (tm_filter_batch): keys2d is a
    (U, L) uint8 array of fixed-length candidate substrings; returns
    int32[U] kept-prefix lengths (-1 = rejected) or None when the native
    library is unavailable.  Exact port of train/filters.py."""
    lib = get_lib()
    if lib is None:
        return None
    ensure_tables(lib)
    u, length = keys2d.shape
    if u == 0:
        return np.zeros(0, np.int32)
    blob = np.ascontiguousarray(keys2d, np.uint8)
    offs = (np.arange(u + 1, dtype=np.int64) * length)
    out = np.empty(u, np.int32)
    if threads is None:
        threads = os.cpu_count() or 1
    lib.tm_filter_batch(blob.ctypes.data, offs.ctypes.data, u,
                        level, charset, capcode, words_per_token,
                        threads, out.ctypes.data)
    return out


def native_capcode_decode(data: bytes, state: "np.ndarray | None" = None):
    """Stateful capcode decode (tm_capcode_decode, the hot loop of the
    reference decode path — tokenmonster-cpp ~186 MB/s).  ``state`` is a
    mutable uint8[4] [in_word, in_char, delete, ignore] carried across
    streaming chunks; None = fresh state.  Returns bytes or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ensure_tables(lib)
    if state is None:
        state = np.zeros(4, np.uint8)
    n = len(data)
    src = np.frombuffer(data, np.uint8)
    # simple uppercase mappings may lengthen UTF-8 (e.g. U+023F -> U+2C7E)
    out = np.empty(2 * n + 16, np.uint8)
    m = lib.tm_capcode_decode(src.ctypes.data if n else None, n,
                              out.ctypes.data, state.ctypes.data)
    return out[:m].tobytes()


def native_nocapcode_decode(data: bytes, state: "np.ndarray | None" = None):
    lib = get_lib()
    if lib is None:
        return None
    ensure_tables(lib)
    if state is None:
        state = np.zeros(4, np.uint8)
    n = len(data)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(n + 16, np.uint8)
    m = lib.tm_nocapcode_decode(src.ctypes.data if n else None, n,
                                out.ctypes.data, state.ctypes.data)
    return out[:m].tobytes()


_add_score_method()


def native_build_meta(tokens: list, using_capcode: int, special_mask):
    """Compute flag/nwords/alternatives/beginByte for a sorted token list.

    Returns (flag u8, nwords u8, index1 u32, index2 u32, len1 i32, len2 i32,
    begin_byte u8[256]) or None if the native library is unavailable.
    Exact port of the classification pass — see tm_build_meta in
    tm_native.cpp and core/tokenmeta.py."""
    lib = get_lib()
    if lib is None:
        return None
    ensure_tables(lib)
    n = len(tokens)
    offs = np.zeros(n + 1, np.uint32)
    for i, t in enumerate(tokens):
        offs[i + 1] = offs[i] + len(t)
    blob = np.frombuffer(b"".join(tokens), np.uint8) if n else np.zeros(0, np.uint8)
    blob = np.ascontiguousarray(blob)
    mask = np.ascontiguousarray(np.asarray(special_mask, np.uint8)) \
        if special_mask is not None else np.zeros(n, np.uint8)
    flag = np.zeros(n, np.uint8)
    nwords = np.zeros(n, np.uint8)
    index1 = np.zeros(n, np.uint32)
    index2 = np.zeros(n, np.uint32)
    len1 = np.zeros(n, np.int32)
    len2 = np.zeros(n, np.int32)
    bb = np.zeros(256, np.uint8)
    lib.tm_build_meta(blob.ctypes.data, offs.ctypes.data, n, using_capcode,
                      mask.ctypes.data, flag.ctypes.data, nwords.ctypes.data,
                      index1.ctypes.data, index2.ctypes.data,
                      len1.ctypes.data, len2.ctypes.data, bb.ctypes.data)
    return flag, nwords, index1, index2, len1, len2, bb


def native_capcode_decode(data: bytes, state: np.ndarray) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    ensure_tables(lib)
    n = len(data)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(2 * n + 16, np.uint8)
    m = lib.tm_capcode_decode(src.ctypes.data, n, out.ctypes.data,
                              state.ctypes.data)
    return out[:m].tobytes()


def native_nocapcode_decode(data: bytes, state: np.ndarray) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    ensure_tables(lib)
    n = len(data)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(n + 16, np.uint8)
    m = lib.tm_nocapcode_decode(src.ctypes.data, n, out.ctypes.data,
                                state.ctypes.data)
    return out[:m].tobytes()
