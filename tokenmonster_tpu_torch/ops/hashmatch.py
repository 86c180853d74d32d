"""Per-length-class displaced hash tables for the Pallas longest-match
kernel (ops/pallas_match.py).

The reference finds longest matches with a length-bucketed packed-key
search (pansearch; tokenmonster-cpp/src/tokenmonster.cpp:491-877) — a
pointer-chasing structure XLA cannot use (scalar gathers cap at ~94 M/s on
this TPU).  The TPU-native reformulation: for every position p and every
key length l, test membership of text[p:p+l] with a per-lane row-select
over VMEM-resident hash-table planes.

Exactness: each slot stores the key's raw bytes bit-packed into int32
fields; the kernel compares ALL stored key bytes against the text window,
so a hit is an exact dictionary match — no fingerprint uncertainty.

Round-5 layout (the probe diet):
  - slot counts are any multiple of 128 (load ~0.97), not powers of two —
    probe cost is proportional to table rows, and pow2 growth wasted ~30%;
    the slot hash maps to [0, S) with a NAF shift-add high-multiply
    (``scale_to``), value-identical between host build and kernel.
  - slot payload is BIT-PACKED int32 fields: [idx+1 (21b)] ([space idx+1
    (21b)] for merged tables) then the raw key bytes — ceil((21*n_idx +
    8*len)/32) planes instead of len/3 byte-triple planes + an index plane.
  - displacements pack two u16 per int32 plane lane.
  - delete-token vocabularies MERGE the main and space-stripped entries of
    each stripped length into ONE table (two index fields per slot): the
    space-stripped key is a text prefix at p, so one probe per length
    serves both M(p) and Mb(p) — this halves the capcode-2 match cost.

Placement is CHD-style (compress-hash-displace): keys hash to buckets; a
per-bucket displacement is searched so every key lands in a distinct slot;
lookup = hash -> bucket displacement -> slot, collision-free by build.

Hash family (u32 wraparound arithmetic; constant multiplies lower to NAF
shift-add chains in the kernel — the VPU's u32 multiply is emulated):
  h(p, l) = poly hash of bytes, h' = ((h*257 + b) ^ (h*257+b)>>11)
  bucket  = (h * C1) >> (32 - log2 B)
  g       = clip(scale_to(h ^ salt) * C2, 0, S-1)   (NAF high-multiply)
  slot    = g + d[bucket]  (folded once into [0, S))
(salt is searched per class at build so within-bucket g-collisions — which
make a bucket unplaceable — are reshuffled instead of escalating the table
size.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

M_MULT = np.uint32(257)           # mult-free in-kernel: (h<<8)+h
C1 = np.uint32(0x9E3779B1)
C2 = np.uint32(0x85EBCA6B)
SEED = np.uint32(0x811C9DC5)
IDX_BITS = 21                     # max bits per packed index field (idx+1);
                                  # tables store the exact bit-width needed
                                  # for their dictionary (<= 2^20 entries)
MAX_DISP = 65536                  # u16-packed displacement plane


def poly_hash(key: bytes) -> np.uint32:
    """Per-byte recurrence h = (h*257 + b) ^ (h*257+b)>>11 — mult-free in
    the kernel ((h<<8)+h) with an xor-shift to break the affine collision
    structure pure multiplicative updates suffer."""
    h = int(SEED)
    for b in key:
        h = (h * 257 + b) & 0xFFFFFFFF
        h ^= h >> 11
    return np.uint32(h)


def naf_terms(c: int):
    """Signed power-of-two decomposition (non-adjacent form) of a u32
    constant: c = sum(sign << k).  Used to lower constant multiplies to
    shift-add chains — value-identical mod 2^32 to the u32 multiply, but
    ~3x cheaper than the VPU's emulated 32-bit multiply."""
    terms = []
    c = int(c)
    k = 0
    while c:
        if c & 1:
            if c & 3 == 3:
                terms.append((k, -1))
                c += 1
            else:
                terms.append((k, 1))
                c -= 1
        c >>= 1
        k += 1
    return terms


def _top_bits(x: np.uint32, mult: np.uint32, bits: int) -> int:
    if bits == 0:
        return 0
    v = np.uint32((np.uint64(x) * np.uint64(mult)) & np.uint64(0xFFFFFFFF))
    return int(v) >> (32 - bits)


def scale_terms(S: int):
    """NAF terms of S for the [0, S) scaling (S a multiple of 128, so
    every shift 32-k is <= 25 — no undefined full-width shifts)."""
    return naf_terms(S)


def scale_to(x: int, terms, S: int) -> int:
    """Map a u32 hash to [0, S): truncated high-multiply x*S >> 32 as a
    signed NAF shift-add sum (each term truncates < 1, so the sum is
    within +-len(terms) of exact), clipped into range.  The kernel
    computes the IDENTICAL sum in int32 (every partial value < 2^21)."""
    t = 0
    x = int(x) & 0xFFFFFFFF
    for k, sign in terms:
        t += sign * (x >> (32 - k))
    return min(max(t, 0), S - 1)


def g_of(h: int, salt: int, terms, S: int) -> int:
    """The slot hash g in [0, S): C2-mixed then NAF-scaled.  The multiply
    is REQUIRED here: any GF(2)-linear mix (xorshift) makes within-bucket
    g differences salt-invariant, so colliding pairs stay colliding at
    every salt retry and placement fails (measured on the gpt2 l=4
    class)."""
    x = ((int(h) ^ salt) * int(C2)) & 0xFFFFFFFF
    return scale_to(x, terms, S)


@dataclass
class ClassTable:
    """One length class's displaced hash table, in kernel layout.

    Kernel layout is FIELD-MAJOR: slot s lives at (row s>>7, lane s&127) of
    every int32 field plane.  The slot payload bit b sits at bit (b & 31)
    of field plane b >> 5; payload = main idx+1 (21 bits) [+ space idx+1
    (21 bits) for merged delete-token tables] followed by the raw key
    bytes.  An all-zero empty slot can never alias a match (idx stored +1).
    ``fields_keybits`` holds the planes with the index bits ZEROED; the
    index bits are composed in (compose_fields) so the trainer can mask
    candidates per call without rebuilding key data.
    """
    length: int                  # stripped key length (bytes)
    S: int                       # slot count (multiple of 128)
    b_bits: int                  # log2(buckets)
    salt: int                    # g-hash salt (see module doc)
    n_idx: int                   # 1, or 2 for merged main+space tables
    idx1_bits: int               # bits per packed index field
    slot_main: np.ndarray        # (S,) int32 main idx+1 (0 = none)
    slot_space: np.ndarray       # (S,) int32 space idx+1 (0 = none)
    slot_keys: np.ndarray        # (S, length) uint8 raw key bytes
    occupied: np.ndarray         # (S,) bool
    disp: np.ndarray             # (B,) int32 displacements (< MAX_DISP)
    fields_keybits: np.ndarray   # (n_fields, R8, 128) int32, idx bits zero
    n_keys: int = 0
    # keys whose FULL 32-bit hash collides with another key can never be
    # displaced apart (same bucket, same g for every salt) — they leave the
    # hash table and get direct-compare probes in the kernel instead
    ovf_keys: list = field(default_factory=list)    # list[bytes]
    ovf_idx: list = field(default_factory=list)     # main idx or -1
    ovf_idx_space: list = field(default_factory=list)  # space idx or -1

    @property
    def idx_bits(self) -> int:
        return self.idx1_bits * self.n_idx

    @property
    def n_fields(self) -> int:
        return -(-(self.idx_bits + 8 * self.length) // 32)

    @property
    def n_rows(self) -> int:
        """Logical slot rows (S / 128)."""
        return self.S // 128

    @property
    def scale(self):
        return scale_terms(self.S)


def _pack_payload_bits(cls: ClassTable):
    """(n_fields, S) int32 key-byte planes (index bits zero) + per-field
    key masks."""
    nf = cls.n_fields
    S = cls.S
    ib = cls.idx_bits
    l = cls.length
    planes = np.zeros((nf, S), np.uint64)
    kb = cls.slot_keys.astype(np.uint64)           # (S, l)
    for k in range(l):
        bitpos = ib + 8 * k
        f, off = bitpos >> 5, bitpos & 31
        planes[f] |= (kb[:, k] << off) & 0xFFFFFFFF
        if off > 24:
            planes[f + 1] |= kb[:, k] >> (32 - off)
    return planes.astype(np.uint32).view(np.int32).reshape(nf, S)


def key_masks(length: int, n_idx: int, idx1_bits: int = IDX_BITS):
    """Per-field u32 masks covering the key-byte bits."""
    ib = idx1_bits * n_idx
    nf = -(-(ib + 8 * length) // 32)
    masks = [0] * nf
    for k in range(length):
        bitpos = ib + 8 * k
        f, off = bitpos >> 5, bitpos & 31
        masks[f] |= (0xFF << off) & 0xFFFFFFFF
        if off > 24:
            masks[f + 1] |= 0xFF >> (32 - off)
    return masks


def _pad_rows8(a: np.ndarray) -> np.ndarray:
    """Pad a (..., R, 128) plane so R is a multiple of 8 (Mosaic's gather
    lowering rejects sub-8-sublane operands)."""
    r = a.shape[-2]
    r8 = max(8, -(-r // 8) * 8)
    if r8 == r:
        return a
    pad = np.zeros(a.shape[:-2] + (r8 - r, 128), a.dtype)
    return np.concatenate([a, pad], axis=-2)


def compose_fields(cls: ClassTable, alive: np.ndarray | None = None):
    """(n_fields, R8, 128) int32 device planes: key-byte bits + the index
    bits composed from slot_main/slot_space, with dead tokens' indices
    zeroed when ``alive`` is given (the masked tables behave as the
    sub-dictionary — the trainer's per-candidate masking)."""
    nf = cls.n_fields
    S = cls.S
    m = cls.slot_main.astype(np.int64)
    sp = cls.slot_space.astype(np.int64)
    if alive is not None:
        live_m = alive[np.maximum(m - 1, 0)] & (m > 0)
        m = np.where(live_m, m, 0)
        live_s = alive[np.maximum(sp - 1, 0)] & (sp > 0)
        sp = np.where(live_s, sp, 0)
    b = cls.idx1_bits
    flat = cls.fields_keybits.copy().reshape(nf, S)
    fl = flat.view(np.uint32)
    fl[0] |= m.astype(np.uint32) & ((1 << b) - 1)
    if cls.n_idx == 2:
        fl[0] |= (sp.astype(np.uint32) << b) & 0xFFFFFFFF
        if 2 * b > 32:
            fl[1] |= (sp.astype(np.uint32) >> (32 - b)) & ((1 << (2 * b - 32)) - 1)
    return _pad_rows8(flat.reshape(nf, S // 128, 128))


def disp_plane(cls: ClassTable) -> np.ndarray:
    """u16-pair-packed displacement plane: lane i holds buckets 2i, 2i+1.
    (R8, 128) int32."""
    B = 1 << cls.b_bits
    d = np.zeros(max(2, B), np.uint32)
    d[:B] = cls.disp.astype(np.uint32)
    if len(d) % 2:
        d = np.concatenate([d, np.zeros(1, np.uint32)])
    packed = (d[0::2] | (d[1::2] << 16)).view(np.int32)
    rows = -(-len(packed) // 128)
    out = np.zeros(rows * 128, np.int32)
    out[:len(packed)] = packed
    return _pad_rows8(out.reshape(rows, 128))


def build_class_table(length: int, entries: list, load: float = 0.97,
                      n_idx: int = 1,
                      idx1_bits: int = IDX_BITS) -> ClassTable:
    """Build the displaced table for one length class.

    ``entries``: list of (key bytes, main_idx or -1, space_idx or -1).
    Starts at the smallest multiple-of-128 slot count >= K/load and grows
    by 128 on placement failure (after salt reshuffles)."""
    # full-hash collisions are unplaceable at any size/salt (identical h
    # => identical bucket AND g): route all but the first of each h-group
    # to direct-compare overflow probes
    ovf_keys: list = []
    ovf_idx: list = []
    ovf_sp: list = []
    seen: dict = {}
    keep: list = []
    for k, mi, si in entries:
        h = int(poly_hash(k))
        if h in seen:
            ovf_keys.append(k)
            ovf_idx.append(mi)
            ovf_sp.append(si)
        else:
            seen[h] = True
            keep.append((k, mi, si))
    K = len(keep)
    S0 = max(128, -(-int(np.ceil(K / load)) // 128) * 128)
    # among slot counts within ~5% above the load target, prefer the one
    # whose NAF scaling chain is shortest (each term is a kernel shift-add)
    cands = [S0 + 128 * i for i in range(4)]
    S = min(cands, key=lambda s: (len(scale_terms(s)), s))
    h_all = [int(poly_hash(k)) for k, _m, _s in keep]

    for attempt in range(60):
        terms = scale_terms(S)
        b_bits = max(0, (max(S // 4, 1) - 1).bit_length())
        B = 1 << b_bits
        salt = (attempt * 0x9E3779B9) & 0xFFFFFFFF
        g_all = [g_of(h, salt, terms, S) for h in h_all]
        buckets: list[list[int]] = [[] for _ in range(B)]
        for i, h in enumerate(h_all):
            buckets[_top_bits(np.uint32(h), C1, b_bits)].append(i)
        order = sorted(range(B), key=lambda b: -len(buckets[b]))
        occupied = np.zeros(S, bool)
        slot_of = np.full(K, -1, np.int64)
        disp = np.zeros(B, np.int32)
        ok = True
        for b in order:
            ks = buckets[b]
            if not ks:
                continue
            placed = False
            for d in range(min(S, MAX_DISP)):
                slots = []
                bad = False
                for i in ks:
                    s = g_all[i] + d
                    if s >= S:
                        s -= S
                    if occupied[s]:
                        bad = True
                        break
                    slots.append(s)
                if bad or len(set(slots)) != len(ks):
                    continue
                for i, s in zip(ks, slots):
                    occupied[s] = True
                    slot_of[i] = s
                disp[b] = d
                placed = True
                break
            if not placed:
                ok = False
                break
        if ok:
            break
        if attempt % 3 == 2:   # two salt reshuffles before growing
            S += 128
    else:
        raise RuntimeError(f"CHD build failed for length {length} ({K} keys)")

    slot_main = np.zeros(S, np.int32)
    slot_space = np.zeros(S, np.int32)
    slot_keys = np.zeros((S, length), np.uint8)
    for i, (k, mi, si) in enumerate(keep):
        s = int(slot_of[i])
        slot_keys[s] = np.frombuffer(k, np.uint8)
        if mi >= 0:
            slot_main[s] = mi + 1
        if si >= 0:
            slot_space[s] = si + 1
    cls = ClassTable(length=length, S=S, b_bits=b_bits, salt=salt,
                     n_idx=n_idx, idx1_bits=idx1_bits, slot_main=slot_main,
                     slot_space=slot_space, slot_keys=slot_keys,
                     occupied=occupied, disp=disp,
                     fields_keybits=None, n_keys=K,
                     ovf_keys=ovf_keys, ovf_idx=ovf_idx, ovf_idx_space=ovf_sp)
    cls.fields_keybits = _pack_payload_bits(cls).reshape(
        cls.n_fields, S // 128, 128)
    return cls


@dataclass
class HashMatchTables:
    """All class tables + auxiliary arrays for one dictionary.

    Delete-token vocabularies (``has_space``): the tokenizer's b-branches
    probe the dictionary with a space-prefixed window (the ``lilbuf``
    probes, go/tokenmonster.go:1029-1036, 1088-1108).  Only keys BEGINNING
    with the space prefix can match such a window, so the stripped keys
    {k[len(pre):]} index the same text prefix at p as the main keys — the
    classes carry BOTH index fields and one probe per length serves M(p)
    and Mb(p).  Reported space-match length includes the prefix."""
    classes: list[ClassTable]
    single: np.ndarray           # (256,) i32: dict index of 1-byte key or -1
    max_len: int
    n_keys: int
    has_space: bool = False
    space_single: np.ndarray = None  # (256,) idx of stripped 1-byte key
    space_empty: int = -1        # dict idx of the bare prefix token, or -1
    lil_off: int = 1             # len(space prefix): 1 (UTF-8) / 2 (UTF-16)

    def nbytes(self) -> int:
        return sum(c.fields_keybits.nbytes + c.disp.nbytes
                   for c in self.classes)

    def device_nbytes(self) -> int:
        """VMEM bytes of the composed kernel planes (8-row padding and the
        u16-packed displacement planes included) — the number the trainer
        gates its superset pool on."""
        total = 2 * 2 * 128 * 4   # single tables
        for c in self.classes:
            r8 = max(8, -(-c.n_rows // 8) * 8)
            total += c.n_fields * r8 * 128 * 4
            packed = -(-max(2, 1 << c.b_bits) // 2)
            dr8 = max(8, -(-(-(-packed // 128)) // 8) * 8)
            total += dr8 * 128 * 4
        return total


def build_hashmatch(keys: list[bytes], indices=None,
                    space_prefix: bytes | None = None) -> HashMatchTables:
    """Build tables from dictionary keys (sorted order = index order).

    ``space_prefix`` (b" " for byte/UTF-8 charsets, b" \\x00" for UTF-16-LE)
    merges the space-stripped entries into the main classes (dual index
    fields); None for vocabularies without a delete token."""
    if indices is None:
        indices = list(range(len(keys)))
    single = np.full(256, -1, np.int32)
    space_single = np.full(256, -1, np.int32) if space_prefix else None
    space_empty = -1
    lil_off = len(space_prefix) if space_prefix else 1
    n_idx = 2 if space_prefix is not None else 1

    by_len: dict[int, dict[bytes, list]] = {}

    def _slot(k: bytes):
        e = by_len.setdefault(len(k), {})
        got = e.get(k)
        if got is None:
            got = e[k] = [k, -1, -1]
        return got

    max_len = 0
    for k, i in zip(keys, indices):
        k = bytes(k)
        max_len = max(max_len, len(k))
        if len(k) == 1:
            single[k[0]] = i
        elif len(k) >= 2:
            _slot(k)[1] = i
        if space_prefix is not None and k.startswith(space_prefix):
            s = k[len(space_prefix):]
            if len(s) == 0:
                space_empty = i
            elif len(s) == 1:
                space_single[s[0]] = i
            else:
                _slot(s)[2] = i

    # exact index bit-width for this dictionary (idx+1 <= len(keys))
    idx1_bits = max(8, (len(keys) + 1).bit_length())
    classes = [build_class_table(ln, list(e.values()), n_idx=n_idx,
                                 idx1_bits=idx1_bits)
               for ln, e in sorted(by_len.items())]
    return HashMatchTables(classes=classes, single=single, max_len=max_len,
                           n_keys=len(keys), has_space=space_prefix is not None,
                           space_single=space_single,
                           space_empty=space_empty, lil_off=lil_off)


# ---------------- host reference prober (oracle for kernel tests) --------

def _host_probe(tables: HashMatchTables, data: bytes, p: int):
    """Yield (length, main_idx+1, space_idx+1) for every class hit at p,
    mirroring the kernel's probe math exactly (same hashes, same fold)."""
    n = len(data)
    h = int(SEED)
    maxl = min(tables.max_len, n - p)
    by_len = {c.length: c for c in tables.classes}
    for l in range(1, maxl + 1):
        h = (h * 257 + data[p + l - 1]) & 0xFFFFFFFF
        h ^= h >> 11
        c = by_len.get(l)
        if c is None:
            continue
        bucket = _top_bits(np.uint32(h), C1, c.b_bits)
        g = g_of(h, c.salt, c.scale, c.S)
        s = g + int(c.disp[bucket])
        if s >= c.S:
            s -= c.S
        win = data[p:p + l]
        if c.occupied[s] and bytes(c.slot_keys[s]) == win:
            yield l, int(c.slot_main[s]), int(c.slot_space[s])
        for k, mi, si in zip(c.ovf_keys, c.ovf_idx, c.ovf_idx_space):
            if win == k:
                yield l, mi + 1 if mi >= 0 else 0, si + 1 if si >= 0 else 0


def host_longest_match(tables: HashMatchTables, data: bytes, p: int):
    """(idx, length) of the longest dictionary match at p; (-1, 0) if none.
    Mirrors the kernel's probe math exactly (same hashes, same layout)."""
    best_idx, best_len = -1, 0
    b = data[p] if p < len(data) else None
    if b is not None and tables.single[b] >= 0:
        best_idx, best_len = int(tables.single[b]), 1
    for l, mi, _si in _host_probe(tables, data, p):
        if mi > 0:
            best_idx, best_len = mi - 1, l
    return best_idx, best_len


def host_longest_space_match(tables: HashMatchTables, data: bytes, p: int):
    """(idx, full_length) of the longest space-prefixed match at p, i.e.
    the longest dictionary key equal to prefix + data[p:p+sl]; full_length
    includes the prefix bytes.  (-1, 0) if none."""
    best_idx, best_len = -1, 0
    if not tables.has_space:
        return best_idx, best_len
    if tables.space_empty >= 0:
        best_idx, best_len = tables.space_empty, tables.lil_off
    n = len(data)
    b = data[p] if p < n else None
    if b is not None and tables.space_single is not None \
            and tables.space_single[b] >= 0:
        best_idx = int(tables.space_single[b])
        best_len = 1 + tables.lil_off
    for l, _mi, si in _host_probe(tables, data, p):
        if si > 0:
            best_idx, best_len = si - 1, l + tables.lil_off
    return best_idx, best_len
