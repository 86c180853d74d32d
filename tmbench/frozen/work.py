"""The least time the card could take for a match kernel's work, frozen
from ``chip_smoke.py`` at commit 6d463e6b506c (``PEAK_BYTES_S``, ``PEAK_OPS_S``,
``bound``, ``nbytes``, ``match_work``, copied whole): the bytes of a
dispatch (its text, every match table, the words written) over HBM3's
3.35 TB/s, or its 32-bit integer operations over 64 results a clock and
SM x 132 SMs x 1.98 GHz, whichever is larger.  The copy stays as it is
when the source changes, so a kernel that is fused or replaced is judged
against the same work."""

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 64 * 132 * 1.98e9


def bound(nbytes: int, ops: int):
    """(ms, "bytes" or "operations"): the least time for this work."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def match_work(buf, n: int, tabs):
    """(bytes, operations) of one match call: the text, every match table
    and the words written; three operations (multiply-add, shift, xor) per
    window hashed, each position hashing up to max_len windows that end by
    n."""
    L = tabs.max_len
    hashed = (n - L + 1) * L + L * (L - 1) // 2 if n >= L else n * (n + 1) // 2
    tables = nbytes(tabs.fields, tabs.disp, tabs.single, tabs.space_single,
                    tabs.scalars, tabs.desc, tabs.len_cls, tabs.ovf_keys)
    out = 4 * buf.numel() * (2 if tabs.has_space else 1)
    return buf.numel() + tables + out, 3 * hashed
