"""The port's NFD pass (``core/normalize.py::_nfd``), which hands
``unicodedata`` only the runs of non-ASCII bytes of a long text with few of
them, byte for byte against the JAX package's, which normalizes every text
whole: library text on both sides of each threshold, marks after ASCII
letters, singletons that decompose to ASCII, invalid UTF-8, dense text
(which keeps the whole-text route), a seeded fuzz; the separator proven
absent from every NFD of a non-ASCII code point."""

import sys
import unicodedata

import numpy as np
import pytest

from tokenmonster_tpu.core import normalize as jnorm
from tokenmonster_tpu.utils import chartypes as jchartypes
from tokenmonster_tpu_torch.core import normalize as tnorm
from tokenmonster_tpu_torch.corpus import stdlib_text

MIN, SPARSE = tnorm.RUNS_MIN_BYTES, tnorm.RUNS_SPARSITY
BLOCK = tnorm._BLOCK
FLAGS = ["nfd", "nfd lowercase", "accents"]
FILLER = b"The quick brown fox jumps over the lazy dog; x = f(y) + 1.\n"


def _fill(n: int) -> bytes:
    return (FILLER * (n // len(FILLER) + 1))[:n]


def _spaced(n: int, runs: int, mark: str) -> bytes:
    """About ``n`` bytes of ASCII with ``runs`` copies of ``mark`` spread
    evenly, each after an ASCII letter."""
    m = mark.encode()
    gap = (n - runs * len(m)) // runs
    return b"".join(_fill(gap) + m for _ in range(runs)) + _fill(
        n - runs * (gap + len(m)))


@pytest.fixture(scope="module", autouse=True)
def jax_char_tables():
    """The JAX package's character tables (``accents`` reads them), built
    in this process rather than read from its on-disk cache: that cache is
    written through one shared temporary name, so on a fresh checkout
    test processes that first read it at the same time can replace each
    other's half-written file.  Built here, this module neither reads nor
    writes that file."""
    if jchartypes._CACHE is None:
        jchartypes._CACHE = jchartypes._build()


@pytest.fixture(scope="module")
def library():
    text, _ = stdlib_text(None, 11_000_000)
    assert len(text) >= 10_000_000 and not text.isascii()
    return text


def _library_slices(text: bytes) -> dict:
    """Slices that start at a run and end after one: the long ones sparse
    enough for the runs, the short ones below ``RUNS_MIN_BYTES``."""
    arr = np.frombuffer(text, dtype=np.uint8)
    high = np.flatnonzero(arr >= 0x80)
    cases = {}
    for size in (MIN - 1, MIN, MIN + 1, 4 * MIN, 1 << 16, 1 << 20):
        for k, at in enumerate(high[[0, len(high) // 3, 2 * len(high) // 3]]):
            start = max(0, int(at) - size // 2)
            cases[f"library_{size}_{k}"] = text[start:start + size]
    return cases


E_ACUTE = "\u00e9"                   # precomposed: decomposes to e + U+0301
E_MARK = "e\u0301"                   # a mark after an ASCII letter
CASES = {
    "mark_after_letter": _fill(3000) + f"caf{E_MARK} {E_ACUTE}".encode()
    + _fill(9),
    "precomposed_after_letter": _fill(3000) + f"caf{E_ACUTE}".encode(),
    # U+0301 (class 230) before U+0323 (class 220): NFD puts 220 first
    "reordered_marks": _fill(2500) + "a\u0301\u0323 q\u0307\u0323".encode()
    + _fill(600),
    # U+1EA1 (a with dot below) then U+0301, and U+00E1 then U+0323
    "reordered_precomposed": _fill(2500) + "\u1ea1\u0301 \u00e1\u0323".encode()
    + _fill(600),
    # KELVIN SIGN, GREEK QUESTION MARK, GREEK VARIA: each NFD is ASCII
    "singletons_to_ascii": _fill(1500) + "\u212a \u037e \u1fef".encode()
    + _fill(1500),
    "singleton_alone_short": "\u212a\u037e\u1fef".encode(),
    "hangul": _spaced(8000, 20, "\ud55c\uad6d\uc5b4"),
    "only_non_ascii": ("\ud55c\uad6d\uc5b4\u00e9\u00c5" * 300).encode(),
    "only_non_ascii_short": "\u00e9\u00e8\u00c5".encode(),
    "run_at_start": "\u00c9cole \u00e9t\u00e9".encode() + _fill(4000),
    "run_at_end": _fill(4000) + "\u00e0 l'\u00e9t\u00e9".encode(),
    "runs_at_both_ends": "\u00e9".encode() + _fill(4000) + "\u00e8".encode(),
    "one_run_short": _fill(1000) + E_ACUTE.encode() + _fill(1000),
    "invalid_start": b"\xe9" + _fill(4000) + E_ACUTE.encode(),
    "invalid_middle": _fill(2000) + b"\x80" + _fill(2000) + E_ACUTE.encode(),
    "invalid_end": E_ACUTE.encode() + _fill(4000) + b"\xc3",
    "lead_before_ascii": _fill(2000) + b"\xc3A" + _fill(2000),
    "surrogate_encoded": _fill(2000) + b"\xed\xa0\x80" + _fill(2000)
    + E_ACUTE.encode(),
    "invalid_short": b"\xff" + E_ACUTE.encode(),
    "dense_french": ("Le c\u0153ur d\u00e9\u00e7u mais l'\u00e2me na\u00efve,"
                     " r\u00eava au del\u00e0 des \u00eeles. " * 2000).encode(),
    "dense_cjk": ("\u6771\u4eac\u90fd\u306e\u5929\u6c17\u3002 "
                  "\ud55c\uad6d\uc5b4 \u30c6\u30ad\u30b9\u30c8. " * 2000
                  ).encode(),
    # runs that start and end where the scan's blocks meet
    "runs_at_block_edges": _fill(BLOCK) + E_ACUTE.encode()
    + _fill(BLOCK - 4) + E_ACUTE.encode() + _fill(3000),
    "at_sparsity": _spaced(64 * SPARSE, 64, E_ACUTE),
    "past_sparsity": _spaced(64 * SPARSE, 65, E_ACUTE),
}

# the texts the runs route must take (every other long text stays whole)
RUNS_ROUTE = {"mark_after_letter", "precomposed_after_letter",
              "reordered_marks", "reordered_precomposed",
              "singletons_to_ascii", "hangul", "only_non_ascii",
              "run_at_start", "run_at_end", "runs_at_both_ends",
              "runs_at_block_edges", "at_sparsity", "invalid_start", "invalid_middle",
              "invalid_end", "lead_before_ascii", "surrogate_encoded"}
WHOLE_ROUTE = {"singleton_alone_short", "only_non_ascii_short",
               "one_run_short", "invalid_short", "dense_french", "dense_cjk",
               "past_sparsity"}


@pytest.fixture
def routes(monkeypatch):
    """The texts ``_nfd_runs`` was called on."""
    seen = []
    runs = tnorm._nfd_runs

    def spy(b, cuts):
        seen.append(b)
        return runs(b, cuts)
    monkeypatch.setattr(tnorm, "_nfd_runs", spy)
    return seen


def test_cases_are_routed_as_named():
    assert RUNS_ROUTE | WHOLE_ROUTE == set(CASES)
    assert not RUNS_ROUTE & WHOLE_ROUTE


@pytest.mark.parametrize("name", sorted(CASES))
def test_nfd_equals_jax(name, routes):
    raw = CASES[name]
    assert tnorm._nfd(raw) == jnorm._nfd(raw)
    assert (routes == [raw]) == (name in RUNS_ROUTE)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_normalizer_equals_jax(name, flags):
    raw = CASES[name]
    assert (tnorm.Normalizer(flags).normalize(raw)
            == jnorm.Normalizer(flags).normalize(raw))


def test_invalid_utf8_comes_back_unchanged():
    for name in ("invalid_start", "invalid_middle", "invalid_end",
                 "lead_before_ascii", "surrogate_encoded", "invalid_short"):
        assert tnorm._nfd(CASES[name]) == CASES[name], name


@pytest.mark.parametrize("flags", [None] + FLAGS)
def test_library_slices_equal_jax(library, flags, routes):
    cases = _library_slices(library)
    for name, raw in cases.items():
        if flags is None:
            assert tnorm._nfd(raw) == jnorm._nfd(raw), name
        else:
            assert (tnorm.Normalizer(flags).normalize(raw)
                    == jnorm.Normalizer(flags).normalize(raw)), name
    if flags is None:
        took = {len(raw) for raw in routes}
        assert took and min(took) >= MIN
        assert MIN in took and MIN - 1 not in took


def test_sparsity_threshold_is_exact(routes):
    n = 64 * SPARSE
    for runs, route in ((64, True), (65, False)):
        raw = _spaced(n, runs, E_ACUTE)
        assert len(raw) == n
        del routes[:]
        assert tnorm._nfd(raw) == jnorm._nfd(raw)
        assert bool(routes) == route, runs


# marks, precomposed letters, singletons, Hangul, scripts whose NFD
# reorders or expands, letters outside the BMP, code points NFD keeps
POOL = [E_ACUTE, E_MARK, "a\u0301\u0323", "\u1ea1\u0301", "\u212a",
        "\u037e", "\u1fef", "\u2126", "\u212b", "\u00c5", "\ud55c",
        "\uac00", "\u0344", "\u0f73", "\u0958", "\ufb01", "\u2019",
        "\U0001d15e", "\U0001f600", "\u0301", "\u0323\u0301", "\u00bd",
        "\u30ac", "\u0915\u093c", "\u1e9b\u0323", "\u00df"]


def _fuzz_text(rng, n: int, density: float) -> bytes:
    parts, size = [], 0
    while size < n:
        if rng.random() < density:
            piece = "".join(rng.choice(POOL, rng.integers(1, 4))).encode()
        else:
            piece = _fill(int(rng.integers(1, 200)))[::-1]
        parts.append(piece)
        size += len(piece)
    return b"".join(parts)


@pytest.mark.parametrize("seed", range(8))
def test_seeded_fuzz_equals_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    for n in (100, MIN - 10, MIN + 10, 5_000, 40_000, 200_000):
        for density in (0.005, 0.05, 0.3, 0.8):
            raw = _fuzz_text(rng, n, density)
            if rng.random() < 0.2:        # an invalid byte somewhere
                at = int(rng.integers(0, len(raw)))
                raw = raw[:at] + b"\xfe" + raw[at:]
            assert tnorm._nfd(raw) == jnorm._nfd(raw), (n, density)
            for flags in FLAGS:
                assert (tnorm.Normalizer(flags).normalize(raw)
                        == jnorm.Normalizer(flags).normalize(raw))


def test_separator_in_no_nfd_of_a_non_ascii_code_point():
    sep = tnorm._SEP.decode()
    bad = [cp for cp in range(0x80, sys.maxunicode + 1)
           if not 0xD800 <= cp < 0xE000
           and sep in unicodedata.normalize("NFD", chr(cp))]
    assert bad == []


@pytest.mark.parametrize("n", [0, 1, MIN - 1, MIN, 1 << 20])
def test_ascii_comes_back_as_the_same_object(n):
    raw = _fill(n)
    assert tnorm._nfd(raw) is raw
    assert tnorm.Normalizer("nfd").normalize(raw) is raw
