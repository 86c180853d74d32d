"""Candidate token generation: the getalltokens pipeline.

Equivalent of training/getalltokens.go:1613-1995.  Enumerates every
substring (lengths 2..40 raw for unfiltered mode, 3..41 with the final rune
as lookahead for filtered modes), counts occurrences with chunk/micro-chunk
min-occurrence pruning, applies the mode filters, adds the ~900 extraTokens
(non-strict modes), and writes a ``.tok`` file.

Counting is restructured for vectorization: instead of filtering each of the
~40N substring instances, unique substrings are counted per length with
numpy sort-unique and the filter runs once per unique substring — identical
results (filters are pure functions of the substring bytes).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..core import capcode as cc
from ..core.binio import Writer
from ..core.normalize import Normalizer
from ..utils.runes import decode_utf8
from . import filters as F
from .extra_tokens import EXTRA_TOKENS

log = logging.getLogger("tokenmonster_tpu_torch.getalltokens")

MAX_TOKEN_LENGTH = 40


def _unique_substrings(data: np.ndarray, length: int):
    """All substrings of `length` starting at 0..len(data)-tail, deduped.

    Returns (keys_2d uint8 (U, length), counts int64)."""
    n = len(data) - (MAX_TOKEN_LENGTH + 1)
    if n <= 0:
        return np.zeros((0, length), np.uint8), np.zeros(0, np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(data, length)[:n]
    view = np.ascontiguousarray(windows).view(
        np.dtype((np.void, length))).reshape(-1)
    keys, counts = np.unique(view, return_counts=True)
    return keys.view(np.uint8).reshape(-1, length), counts


def sort_device():
    """The device ``TM_GAT_DEVICE`` names for the window sort, or None for
    the host sort: unset, "" or "0" sort on the host, "1" on the default
    card ("cuda"), any other value is a torch device ("cpu", "cuda:1")."""
    name = os.environ.get("TM_GAT_DEVICE", "")
    if name in ("", "0"):
        return None
    return "cuda" if name == "1" else name


class SortedWindows:
    """One sort of the max-length windows serves every substring length.

    Sorting positions by their (max_len+1)-byte window makes equal prefixes
    of *any* length contiguous; the first-mismatch column between adjacent
    sorted windows then yields per-length group boundaries with cheap
    boolean work — replacing ~40 independent sort-unique passes with one.
    """

    def __init__(self, data: np.ndarray, width: int):
        n = len(data) - (MAX_TOKEN_LENGTH + 1)
        self.n = max(0, n)
        self.width = width
        self.data = data
        self.order_u32 = None      # native path: raw order/first_diff arrays
        self.first_diff_u8 = None  # (sorted_w materialised lazily)
        if self.n == 0:
            return
        order = first_diff = None
        device = sort_device()
        if device is not None:
            # device-assisted suffix sort (ops/device_sort.py): opt-in, as
            # in the JAX package, but with no host fallback: a failure
            # raises.  Tie order may differ from the host sort; run
            # structure (hence counts and .tok bytes) is identical.
            from ..ops.device_sort import device_sorted_windows
            order, first_diff = device_sorted_windows(data, n, width, device)
            self.order_u32 = order
            self.first_diff_u8 = first_diff
        if order is None:
            try:
                from .. import native
                built = native.native_sorted_windows(data, n, width)
                if built is not None:
                    order, first_diff = built
                    self.order_u32 = order
                    self.first_diff_u8 = first_diff
            except Exception:
                pass
        if order is None:
            # numpy fallback: lexsort positions by big-endian packed u64
            # words of the window — numeric radix sorts beat comparison-
            # sorting 41-byte void keys
            n_words = -(-width // 8)
            padded = np.zeros(n + n_words * 8, np.uint8)
            padded[:len(data[:n + width])] = data[:n + width]
            wide = np.lib.stride_tricks.sliding_window_view(
                padded, n_words * 8)[:n]
            words = np.ascontiguousarray(wide).view(">u8").reshape(n, n_words)
            order = np.lexsort(tuple(words[:, i]
                                     for i in range(n_words - 1, -1, -1)))
        self._order = order
        self._first_diff_raw = first_diff
        self._sorted_w = None
        self._first_diff = None

    @property
    def sorted_w(self):
        if self._sorted_w is None:
            windows = np.lib.stride_tricks.sliding_window_view(
                self.data, self.width)[:self.n]
            self._sorted_w = np.ascontiguousarray(windows[self._order])
        return self._sorted_w

    @property
    def first_diff(self):
        if self._first_diff is None:
            if self._first_diff_raw is not None:
                self._first_diff = self._first_diff_raw.astype(np.int64)
            else:
                sw = self.sorted_w
                neq = sw[1:] != sw[:-1]
                # first mismatching column between adjacent rows; width if eq
                any_neq = neq.any(axis=1)
                self._first_diff = np.where(any_neq, neq.argmax(axis=1),
                                            self.width)
        return self._first_diff

    def uniques(self, length: int):
        """(keys_2d uint8 (U, length), counts int64) for one length."""
        if self.n == 0 or length > self.width:
            return np.zeros((0, length), np.uint8), np.zeros(0, np.int64)
        is_start = np.empty(self.n, bool)
        is_start[0] = True
        is_start[1:] = self.first_diff < length
        starts = np.nonzero(is_start)[0]
        counts = np.diff(np.append(starts, self.n))
        return self.sorted_w[starts, :length], counts


class TokenCounter:
    """Counting map with min-occurrence pruning (pansearch.Counter role).

    Bulk accumulation goes through a native fixed-width hash counter
    (tm_counter_*, 48-byte rows) when available — a Python dict collapses at
    trainer scale (a diverse 20 MB micro-chunk yields tens of millions of
    unique candidates).  Small adds (extraTokens) and the final export use a
    plain dict; the native side is materialised into it on first read."""

    def __init__(self):
        self.counts: dict[bytes, int] = {}
        self._h = None
        self._lib = None
        try:
            from .. import native
            lib = native.get_lib()
            if lib is not None:
                import ctypes
                for name, res, args in (
                        ("tm_counter_new", ctypes.c_void_p, []),
                        ("tm_counter_free", None, [ctypes.c_void_p]),
                        ("tm_counter_add_batch", None,
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int64]),
                        ("tm_counter_prune", None,
                         [ctypes.c_void_p, ctypes.c_int64]),
                        ("tm_counter_size", ctypes.c_int64,
                         [ctypes.c_void_p]),
                        ("tm_counter_export", None,
                         [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p])):
                    fn = getattr(lib, name)
                    fn.restype = res
                    fn.argtypes = args
                self._lib = lib
                self._h = lib.tm_counter_new()
        except Exception:
            self._h = None

    def __del__(self):
        h, self._h = self._h, None
        if h and self._lib is not None:
            self._lib.tm_counter_free(h)

    def add(self, token: bytes, count: int = 1):
        self.counts[token] = self.counts.get(token, 0) + count

    def add_rows(self, rows48: np.ndarray, cnts: np.ndarray):
        """Accumulate (U, 48) uint8 token rows (40 token bytes zero-padded,
        byte 40 = length, rest zero) with int64 counts."""
        if len(rows48) == 0:
            return
        if self._h:
            rows48 = np.ascontiguousarray(rows48, np.uint8)
            cnts = np.ascontiguousarray(cnts, np.int64)
            self._lib.tm_counter_add_batch(
                self._h, rows48.ctypes.data, cnts.ctypes.data, len(rows48))
        else:
            lens = rows48[:, 40]
            for row, ln, c in zip(rows48, lens, cnts):
                t = row[:ln].tobytes()
                self.counts[t] = self.counts.get(t, 0) + int(c)

    def _materialize(self):
        h, self._h = self._h, None
        if not h:
            return
        m = int(self._lib.tm_counter_size(h))
        rows = np.empty((m, 48), np.uint8)
        cnts = np.empty(m, np.int64)
        if m:
            self._lib.tm_counter_export(h, rows.ctypes.data, cnts.ctypes.data)
        self._lib.tm_counter_free(h)
        get = self.counts.get
        for row, c in zip(rows, cnts):
            t = row[:row[40]].tobytes()
            self.counts[t] = get(t, 0) + int(c)

    def build_with_min(self, min_occur: int, keep_filter=None):
        if self._h and keep_filter is None:
            if min_occur > 1:
                self._lib.tm_counter_prune(self._h, min_occur)
            if min_occur > 1 and self.counts:
                self.counts = {k: v for k, v in self.counts.items()
                               if v >= min_occur}
            return
        self._materialize()
        if min_occur > 1 or keep_filter is not None:
            self.counts = {
                k: v for k, v in self.counts.items()
                if v >= min_occur and (keep_filter is None or keep_filter(k))}

    def __len__(self):
        self._materialize()
        return len(self.counts)

    def keys_sorted(self):
        self._materialize()
        return sorted(self.counts, key=lambda k: (len(k), k))


def _is_valid_utf8(b: bytes, using_capcode: int) -> bool:
    """getalltokens.go:241-269."""
    if using_capcode != 1:
        try:
            b.decode("utf-8")
            return True
        except UnicodeDecodeError:
            return False
    i = 0
    while i < len(b):
        if b[i] == cc.NO_CAPCODE_DELETE_TOKEN:
            i += 1
            continue
        r, n = decode_utf8(b, i)
        if r == 0xFFFD and (n != 3 or b[i:i + 3] != b"\xef\xbf\xbd"):
            return False
        i += n
    return True


def _is_latin(b: bytes) -> bool:
    """getalltokens.go:230-239: letters must be in Latin script."""
    try:
        s = b.decode("utf-8", errors="surrogateescape")
    except Exception:  # pragma: no cover
        return True
    import unicodedata
    for ch in s:
        if ch.isalpha():
            name = unicodedata.name(ch, "")
            if not ("LATIN" in name or ch in "ʼʻ"):
                return False
    return True


def get_all_tokens(data: bytes, mode, charset: int = 1,
                   normalization: str = "nfd", using_capcode: int = 2,
                   max_token_length: int = MAX_TOKEN_LENGTH,
                   min_occur_total: int = 0, min_occur_singles: int = 0,
                   min_occur_chunk: int = 4, min_occur_micro_chunk: int = 2,
                   chunk_size: int = 100_000_000, micro_chunks: int = 5,
                   only_latin: bool = False, only_valid: bool = False,
                   words_per_token: int = 0, add_extra_tokens: bool = True,
                   pre_normalized: bool = False, prefilter_min_raw: int = 1):
    """Run the pipeline; returns (counter, char_table, header dict)."""
    level = {"unfiltered": 0, "clean": 1, "balanced": 2, "consistent": 3,
             "strict": 4}.get(mode, mode)
    if level >= 3 and using_capcode == 0:
        raise ValueError("modes consistent/strict require capcode 1 or 2")
    normalizer = Normalizer(normalization if normalization else
                            ("nfd" if charset == 1 else 0))
    if normalizer.specified_lowercase() and using_capcode == 2:
        raise ValueError("cannot combine lowercase normalization with capcode 2")

    if not pre_normalized:
        from ..core.vocab import normalize_and_capcode
        data = normalize_and_capcode(bytes(data), using_capcode, normalizer)

    if min_occur_total <= 0:
        min_occur_total = max(1, len(data) // 10_000_000)
    if min_occur_singles <= 0:
        min_occur_singles = min_occur_total

    ctx = F.Ctx(charset, using_capcode, words_per_token)
    filt = F.FILTERS.get(level)

    chunk_size += 4 - (chunk_size % 4)
    arr = np.frombuffer(data, np.uint8)
    n_chunks = max(1, -(-len(arr) // chunk_size))
    micro_size = chunk_size // max(1, micro_chunks)
    micro_size += 4 - (micro_size % 4)

    counter = TokenCounter()
    char_table = np.zeros(256, np.int64)
    filter_cache: dict[bytes, bytes] = {}

    if level == 0:
        lengths = range(2, max_token_length + 1)
    else:
        lengths = range(3, max_token_length + 2)

    pos = 0
    for ci in range(n_chunks):
        chunk = arr[ci * chunk_size:(ci + 1) * chunk_size]
        for mi in range(max(1, micro_chunks)):
            micro = chunk[mi * micro_size:(mi + 1) * micro_size]
            if len(micro) == 0:
                continue
            usable = len(micro) - (max_token_length + 1)
            if usable > 0:
                counts_b = np.bincount(micro[:usable], minlength=256)
                char_table += counts_b
            sw = SortedWindows(micro, max(lengths) if len(micro) else 0)
            # fused native pass: one call walks every length's shared-prefix
            # runs of the sorted order, filters and accumulates — no
            # per-unique Python or numpy materialisation
            if (counter._h and sw.n > 0 and sw.order_u32 is not None
                    and native_count_from_sorted(
                        micro, sw, min(lengths), max(lengths), level,
                        ctx, max_token_length, prefilter_min_raw, counter)):
                pass
            else:
                _count_micro_python(sw, lengths, level, ctx, filt,
                                    filter_cache, counter, max_token_length,
                                    prefilter_min_raw)
            if micro_chunks > 1 and mi < micro_chunks - 1:
                counter.build_with_min(min_occur_micro_chunk)
        if ci < n_chunks - 1:
            counter.build_with_min(min_occur_chunk)
        pos += len(chunk)

    return _finish_get_all_tokens(
        counter, char_table, data, level, using_capcode, charset, normalizer,
        only_latin, only_valid, min_occur_total, min_occur_singles,
        add_extra_tokens)


def native_count_from_sorted(micro, sw, len_lo, len_hi, level, ctx,
                             max_token_length, prefilter_min_raw, counter):
    """Invoke tm_count_from_sorted; returns True on success."""
    try:
        from .. import native
        lib = native.get_lib()
        if lib is None:
            return False
        native.ensure_tables(lib)
        import ctypes
        if not hasattr(lib, "_count_sorted_bound"):
            lib.tm_count_from_sorted.restype = None
            lib.tm_count_from_sorted.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
            lib._count_sorted_bound = True
        data = np.ascontiguousarray(micro, np.uint8)
        order = np.ascontiguousarray(sw.order_u32, np.uint32)
        fd = np.ascontiguousarray(sw.first_diff_u8, np.uint8)
        lib.tm_count_from_sorted(
            data.ctypes.data, sw.n, order.ctypes.data, fd.ctypes.data,
            len_lo, len_hi, level, ctx.charset, ctx.capcode,
            ctx.words_per_token, max_token_length,
            max(1, prefilter_min_raw if level != 0 else 1),
            counter._h, 1)
        return True
    except Exception:
        return False


def _count_micro_python(sw, lengths, level, ctx, filt, filter_cache,
                counter, max_token_length, prefilter_min_raw):
    for length in lengths:
        keys, counts = sw.uniques(length)
        if len(keys) == 0:
            continue
        if prefilter_min_raw > 1 and level != 0:
            # prune rare raw substrings before the (expensive) shape
            # filter — same information loss class as the reference's
            # per-micro-chunk min-occurrence prune
            keep_raw = counts >= prefilter_min_raw
            keys, counts = keys[keep_raw], counts[keep_raw]
            if len(keys) == 0:
                continue
        if level == 0:
            kept_len = np.full(len(keys), length, np.int32)
        else:
            # native batch filter (tm_filter_batch, threaded): one
            # call classifies every unique substring of this length
            # — the reference's threaded filter-pool equivalent
            # (getalltokens.go:1236-1314)
            kept_len = None
            try:
                from .. import native
                kept_len = native.native_filter_batch(
                    keys, level, ctx.charset, ctx.capcode,
                    ctx.words_per_token)
            except Exception:
                kept_len = None
            if kept_len is None:
                # pure-Python fallback: filter results are cached
                # across chunks (text repeats heavily)
                cache = filter_cache
                get = cache.get
                kept_len = np.empty(len(keys), np.int32)
                for j, key in enumerate(keys):
                    raw = key.tobytes()
                    hit = get(raw)
                    if hit is None:
                        tok, ok = filt(ctx, raw)
                        hit = len(tok) if ok else -1
                        cache[raw] = hit
                    kept_len[j] = hit
        ok = (kept_len >= 2) & (kept_len <= max_token_length)
        if not ok.all():
            keys, counts, kept_len = keys[ok], counts[ok], kept_len[ok]
        if len(keys) == 0:
            continue
        u = len(keys)
        rows = np.zeros((u, 48), np.uint8)
        w = min(keys.shape[1], 40)
        rows[:, :w] = keys[:, :w]
        rows[:, :40] *= (np.arange(40)[None, :]
                         < kept_len[:, None]).astype(np.uint8)
        rows[:, 40] = kept_len
        counter.add_rows(rows, counts.astype(np.int64))


def _finish_get_all_tokens(counter, char_table, data, level, using_capcode,
                           charset, normalizer, only_latin, only_valid,
                           min_occur_total, min_occur_singles,
                           add_extra_tokens):
    # final trim + validity filters (getalltokens.go:1932-1958)
    keep = None
    if only_latin and only_valid:
        keep = lambda b: (_is_valid_utf8(b, using_capcode) and _is_latin(b))  # noqa: E731
    elif only_latin:
        keep = _is_latin
    elif only_valid:
        keep = lambda b: _is_valid_utf8(b, using_capcode)  # noqa: E731
    counter.build_with_min(min_occur_total, keep)

    # extra code tokens (getalltokens.go:1962-1975)
    if level < 4 and add_extra_tokens:
        from ..core.vocab import normalize_and_capcode

        def _add_extra(tok):
            # the .vocab format caps keys at 40 bytes (bytes8); capcoded
            # extras can exceed it and would be silently dropped downstream
            if 2 <= len(tok) <= MAX_TOKEN_LENGTH:
                counter.add(tok, 1)

        for v in EXTRA_TOKENS:
            vb = v.encode("utf-8")
            _add_extra(normalize_and_capcode(vb, using_capcode, normalizer))
            _add_extra(normalize_and_capcode(b" " + vb, using_capcode,
                                             normalizer))
            if vb.endswith(b"/"):
                _add_extra(vb + b"D")

    header = {
        "using_capcode": using_capcode,
        "charset": charset,
        "norm_flag": normalizer.flag,
        "level": level,
        "min_occur_singles": min_occur_singles,
    }
    return counter, char_table, header


def save_tokens_file(path, counter: TokenCounter, char_table,
                     header: dict):
    """Write a ``.tok`` file (getalltokens.go:186-228): zlib stream with the
    8-byte header, u64 count, then singles and length-sorted tokens."""
    w = Writer()
    w.write_byte(header["using_capcode"])
    w.write_byte(header["charset"])
    w.write_byte(header["norm_flag"])
    w.write_byte(header["level"])
    w.write_byte(header.get("reserve", 0))
    w.write_byte(0)
    w.write_byte(0)
    w.write_byte(0)
    singles = [i for i in range(256)
               if char_table[i] >= header.get("min_occur_singles", 1)]
    w.write_uint64(len(counter) + len(singles))
    for b in singles:
        w.write_bytes8(bytes([b]))
    for tok in counter.keys_sorted():
        w.write_bytes8(tok)
    w.to_zlib_file(path)


def load_tokens_file(path):
    """Read a ``.tok`` file (exportvocab.go:20-60).  Returns a dict with
    header fields, tokens, optional scores and special tokens."""
    from ..core.binio import Reader
    r = Reader.from_zlib_file(path)
    out = {
        "using_capcode": r.read_byte(),
        "charset": r.read_byte(),
        "norm_flag": r.read_byte(),
        "level": r.read_byte(),
        "reserve": r.read_byte(),
    }
    r.read_byte(); r.read_byte(); r.read_byte()
    n = r.read_uint64()
    tokens = [r.read_bytes8() for _ in range(n)]
    scores = None
    specials = None
    if not r.eof():
        scores = [r.read_float32() for _ in range(n)]
        if not r.eof():
            ns = r.read_uint32()
            specials = [r.read_bytes8() for _ in range(ns)]
            if not r.eof():
                raise ValueError(f"{path} not valid")
    out["tokens"] = tokens
    out["scores"] = scores
    out["specials"] = specials
    return out


def save_tokens_with_scores(path, header: dict, tokens, scores=None,
                            specials=None):
    """trainvocab-style .tok writer (trainvocab.go:412-451)."""
    w = Writer()
    w.write_byte(header["using_capcode"])
    w.write_byte(header["charset"])
    w.write_byte(header["norm_flag"])
    w.write_byte(header["level"])
    w.write_byte(header.get("reserve", 0))
    w.write_byte(0)
    w.write_byte(0)
    w.write_byte(0)
    w.write_uint64(len(tokens))
    for t in tokens:
        w.write_bytes8(t)
    if scores is not None:
        for s in scores:
            w.write_float32(float(s))
        w.write_uint32(len(specials or []))
        for t in (specials or []):
            w.write_bytes8(t)
    w.to_zlib_file(path)
