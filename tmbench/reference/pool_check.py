"""A plain check of a getalltokens pool against the corpus it was counted
from.

The rule each entry is held to (getalltokens.go: windows of the
normalized text are counted at every position, so overlapping, and the
counts pruned at micro-chunk, chunk and total level only ever drop
counts; the total's ``-min-occur`` keeps an entry counted at least that
often; singles are counted in their own table, ``-min-occur-byte``;
then the extra code tokens are added whatever the text holds, :1962-1975):

  - the pool's header is the configuration's (capcode, charset,
    normalization, mode);
  - each single byte occurs in the normalized corpus at least
    ``min_occur`` times;
  - each entry of two or more bytes occurs there at least ``min_occur``
    times, overlapping occurrences counted, or is one of the extra code
    tokens as getalltokens adds them: normalized and capcoded, the same
    after a space, and the raw token with "D" after it where it ends in
    "/", of 2 to 40 bytes.

The entries of two or more bytes are checked on a sample drawn from the
seed; the singles all.  Imports nothing of the program and no torch."""

from __future__ import annotations

import random
import struct
import zlib

import numpy as np

from .core.normalize import Normalizer
from .core.vocab import normalize_and_capcode
from .extra_tokens import EXTRA_TOKENS

MAX_TOKEN_LENGTH = 40


def read_pool(path: str) -> tuple:
    """(header dict, tokens) of a ``.tok`` file: a zlib stream of the 8
    header bytes (capcode, charset, normalization, mode, reserve, three
    zeros), the u64 entry count, then each entry as its length byte and
    its bytes."""
    with open(path, "rb") as f:
        data = zlib.decompress(f.read())
    header = dict(zip(("using_capcode", "charset", "norm_flag", "level"),
                      data[:4]))
    (n,) = struct.unpack_from("<Q", data, 8)
    at, tokens = 16, []
    for _ in range(n):
        ln = data[at]
        tokens.append(data[at + 1:at + 1 + ln])
        at += 1 + ln
    if at != len(data):
        raise ValueError(f"{path}: {len(data) - at} bytes past the entries")
    return header, tokens


def extra_forms(capcode: int, norm_flag: int) -> set:
    """The extra code tokens as getalltokens adds them to a pool."""
    normalizer = Normalizer(norm_flag)
    out = set()
    for v in EXTRA_TOKENS:
        vb = v.encode("utf-8")
        forms = [normalize_and_capcode(vb, capcode, normalizer),
                 normalize_and_capcode(b" " + vb, capcode, normalizer)]
        if vb.endswith(b"/"):
            forms.append(vb + b"D")
        out |= {f for f in forms if 2 <= len(f) <= MAX_TOKEN_LENGTH}
    return out


def occurs(text: bytes, token: bytes, times: int) -> bool:
    """Whether ``token`` occurs in ``text`` at least ``times`` times,
    overlapping occurrences counted."""
    at = -1
    for _ in range(times):
        at = text.find(token, at + 1)
        if at < 0:
            return False
    return True


def pool_faults(path: str, normalized: bytes, want: dict, min_occur: int,
                sample: int, seed: int) -> tuple:
    """(entries that break the rule, entries checked) of the pool at
    ``path`` against the ``normalized`` corpus; ``want``: the header
    fields it must have; ``sample`` entries of two or more bytes drawn
    from ``seed``."""
    header, tokens = read_pool(path)
    faults = sum(1 for k, v in want.items() if header.get(k) != v)
    singles = [t for t in tokens if len(t) == 1]
    counts = np.bincount(np.frombuffer(normalized, np.uint8), minlength=256)
    faults += sum(1 for t in singles if counts[t[0]] < min_occur)
    multi = [t for t in tokens if len(t) > 1]
    picked = random.Random(seed).sample(multi, min(sample, len(multi)))
    extras = extra_forms(header.get("using_capcode", 0),
                         header.get("norm_flag", 0))
    faults += sum(1 for t in picked
                  if t not in extras and not occurs(normalized, t, min_occur))
    return faults, len(want) + len(singles) + len(picked)
