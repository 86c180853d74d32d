"""The port's native capcode encoder (``tm_capcode_encode``), which copies
the runs of bytes that need no decision 16 bytes at a time and takes the
reference's step on the rest, byte for byte against the JAX package's
pure-Python encoder and, where the encoding fits that encoder's buffer of
2n + 16 bytes, its native one: a seeded fuzz over an alphabet dense in
decisions, a decision at every offset of a block, long runs, uppercase
words, the length contract at ``cap``, the run counter, and the ASCII
classes the run scan assumes against the tables the encoder is given."""

import ctypes
import random
from unittest import mock

import numpy as np
import pytest

from tokenmonster_tpu import native as jnative
from tokenmonster_tpu.core import capcode as jcc
from tokenmonster_tpu.utils import chartypes as jchartypes
from tokenmonster_tpu_torch import native
from tokenmonster_tpu_torch.utils import chartypes
from torch_cases import heal_jax_native

FUZZ_CHUNKS, FUZZ_TEXTS = 10, 5_000       # 50,000 texts
ALPHABET = (list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789") + [" "] * 6
            + ["\n", "\r", "D", "C", "W", "'", "’", "^", "`",
               "́", "̈", "̧",          # combining marks
               "É", "Ω", "ǅ", "K", "İ"])
INVALID = [b"\x80", b"\xc3", b"\xff"]
LOWER_RUN = b"the quick brown fox jumps over a lazy dog and its kin "
# decisions the scan flags: an uppercase letter, a lowercase letter after
# punctuation or an apostrophe, a digit after a letter, bytes >= 0x80
# (two-, three- and four-byte code points, a mark, invalid bytes)
DECISIONS = [b"A", b"(x", b".a", b"'s", b"\xe2\x80\x99t", b"^a", b"`a",
             b"x1", b"_9", "é".encode(), "É".encode(), "日".encode(),
             "𝔸".encode(), "áb".encode(), b"\xff", b"\xc3(",
             b"WORDS", b"HTTPServer"]


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both packages' native libraries, and the JAX package's character
    tables built in this process (their on-disk cache is written through
    one shared temporary name, which processes that start at once can
    break)."""
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    if jchartypes._CACHE is None:
        jchartypes._CACHE = jchartypes._build()
    heal_jax_native()


def _python(data: bytes) -> bytes:
    with mock.patch.object(jnative, "native_capcode_encode",
                           lambda d: None):
        return jcc.encode(data)


def _check(data: bytes) -> bytes:
    """The port's encoding of ``data``, held to the JAX package's."""
    got = native.native_capcode_encode(data)
    want = _python(data)
    assert got == want, data
    if len(want) <= 2 * len(data) + 16:
        assert jnative.native_capcode_encode(data) == want, data
    return got


def _encode(data: bytes, cap: int, guard: int = 64):
    """(length returned, buffer of cap bytes, guard bytes after it, run
    bytes) of one call to the port's encoder."""
    lib = native.get_lib()
    native.ensure_tables(lib)
    src = np.frombuffer(data, np.uint8)
    buf = np.full(cap + guard, 0xA5, np.uint8)
    runs = ctypes.c_int64(-1)
    m = lib.tm_capcode_encode(src.ctypes.data, len(data), buf.ctypes.data,
                              cap, ctypes.byref(runs))
    return m, buf[:cap].tobytes(), buf[cap:].tobytes(), runs.value


def _fuzz_text(rnd: random.Random) -> bytes:
    """A text of 0-120 pieces, from a share of the alphabet's decisions
    drawn per text (ASCII lowercase and spaces otherwise) and a few
    invalid bytes."""
    dense = rnd.random()
    parts = []
    for _ in range(rnd.randrange(0, 121)):
        x = rnd.random()
        if x < 0.03:
            parts.append(rnd.choice(INVALID))
        elif x < dense:
            parts.append(rnd.choice(ALPHABET).encode())
        else:
            parts.append(rnd.choice("abcdefghijklm nopqrstu ").encode())
    return b"".join(parts)


@pytest.mark.parametrize("chunk", range(FUZZ_CHUNKS))
def test_fuzz_equals_the_reference(chunk):
    rnd = random.Random(18_000 + chunk)
    for _ in range(FUZZ_TEXTS):
        _check(_fuzz_text(rnd))


@pytest.mark.parametrize("offset", range(18))
def test_decision_at_every_offset_of_a_block(offset):
    """The scan starts after the first byte: each decision lands at
    ``offset`` of its first block (16 and 17: the second block's start),
    multi-byte ones across the block's end at 13-15, and again at the end
    of the text, where fewer than 16 bytes are left."""
    lead = b"a" + LOWER_RUN[:offset]
    for d in DECISIONS:
        _check(lead + d + LOWER_RUN)
        _check(lead + d)
        _check(lead + d + LOWER_RUN[:offset] + d + b"x" * 17)
        _check(LOWER_RUN + d + lead)


@pytest.mark.parametrize("text,decisions", [
    (b"a" * 64, False), (b"a" * 200 + b"B", False), (b" " * 100 + b"x", False),
    (LOWER_RUN * 40, False), (b"x = y + z;  # no caps here\n" * 30, True),
    (b"0123456789 " * 20 + b"a1", False),
    (b"abc\n\r\t !\"#$%&*+,-./:;<=>?@[\\]{|}~ " * 8, False)],
    ids=["a64", "a200_upper", "spaces", "words", "code", "digits", "punct"])
def test_long_runs(text, decisions):
    """Runs of 64 bytes and more; where no decision falls before the last
    16 bytes, every 16-byte block from the second byte on is copied and
    the tail of fewer than 16 takes the step."""
    got = _check(text)
    m, out, _, runs = _encode(text, len(got))
    assert (m, out) == (len(got), got)
    full = (len(text) - 1) // 16 * 16
    assert runs < full if decisions else runs == full


@pytest.mark.parametrize("text", [
    "HELLO WORLD", "ALL CAPS TEXT, THEN SOME MORE OF IT. " * 20,
    "ÉTÉ STRASSE ΚΕΦΑΛΑΙΑ ǄEMAL KELVIN İSTANBUL",
    "HTTPServer XMLHttpRequest iPhone O'NEILL D'ARC AB’CD",
    "ABC\udcffDEF ABC\udc80def É\udcc3ÉÉ", "A" * 300 + "b",
    "WORD1 2WORD A1B2 C3 99LUFTBALLONS ÀÉ́ÎÕ",
    "CAPS^MOD `GRAVE` DCW DC W D C"],
    ids=["two_words", "sentences", "non_ascii", "mixed", "invalid",
         "long_word", "digits", "markers"])
def test_uppercase_words(text):
    _check(text.encode("utf-8", "surrogateescape"))


@pytest.mark.parametrize("text", [b"1a" * 40, b"HELLOworld " * 10,
                                  b"(a" * 30 + LOWER_RUN,
                                  "ÉTÉa ".encode() * 12],
                         ids=["triples", "fixup", "markers", "non_ascii"])
def test_length_contract_at_cap(text):
    """Where the encoding is longer than ``cap`` the encoder writes no byte
    past it and returns the length; at ``cap`` and above it writes the
    encoding whole."""
    want = _check(text)
    for cap in sorted({0, 1, 16, len(text), len(want) // 2, len(want) - 1,
                       len(want), len(want) + 1, 2 * len(text) + 16}):
        m, out, guard, _ = _encode(text, cap)
        assert m == len(want) and guard == b"\xa5" * len(guard), cap
        if cap >= len(want):
            assert out[:m] == want, cap


def test_wrapper_retries_past_twice_the_input():
    text = b"1a" * 500
    assert len(native.native_capcode_encode(text)) == 3 * len(text)


def test_run_bytes_counted():
    """The bytes copied as runs: every byte but those that take the step
    (the first, each decision, the tail under 16 bytes)."""
    text = b"a" + b"b" * 31 + b"(c" + b"d" * 30 + b"E" + b"f" * 40
    want = _check(text)
    m, out, _, runs = _encode(text, len(want))
    assert (m, out) == (len(want), want)
    # "b"*31 and "(": 32 bytes; "d"*30: 30; "f"*39 after the E's step
    # ends its word ("f" closes it): 32 copied, 7 in the tail
    assert runs == 32 + 30 + 32
    assert _encode(b"", 16)[0] == 0 and _encode(b"", 16)[3] == 0


def test_ascii_classes_match_the_tables():
    """The run scan's ASCII ranges are the classes the encoder's tables
    (``chartypes``, uploaded by ``ensure_tables``) give every code point
    below 0x80: letters A-Z and a-z, uppercase A-Z, lowercase a-z, numbers
    0-9, no modifier; the case maps move A-Z and a-z and no other."""
    props = chartypes.props_table()[:128]
    lower, upper = chartypes.lower_table()[:128], chartypes.upper_table()[:128]
    for cp in range(128):
        c = chr(cp)
        is_up, is_lo = "A" <= c <= "Z", "a" <= c <= "z"
        assert bool(props[cp] & chartypes.LETTER) == (is_up or is_lo), cp
        assert bool(props[cp] & chartypes.UPPER) == is_up, cp
        assert bool(props[cp] & chartypes.LOWER) == is_lo, cp
        assert bool(props[cp] & chartypes.NUMBER) == ("0" <= c <= "9"), cp
        assert not props[cp] & chartypes.MODIFIER, cp
        assert lower[cp] == (cp + 32 if is_up else cp), cp
        assert upper[cp] == (cp - 32 if is_lo else cp), cp
