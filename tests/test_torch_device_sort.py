"""The getalltokens device sort (``ops/device_sort.py``) on the CPU against
the JAX package's ``device_sorted_windows`` (XLA on the CPU) and the
native host sort, exact: the same order and first differences as the JAX
sort (the same stable passes over the same words), the same sorted window
bytes and run structure at every length 2-40 as the host sort (ties may
order differently there), and through ``get_all_tokens`` with
``TM_GAT_DEVICE=cpu`` the same counts and ``.tok`` bytes as the host
sort's and the JAX package's device path."""

import numpy as np
import pytest

from tokenmonster_tpu.ops.device_sort import (
    device_sorted_windows as jax_sorted_windows)
from tokenmonster_tpu_torch.native import native_sorted_windows
from tokenmonster_tpu_torch.ops.device_sort import device_sorted_windows
from tokenmonster_tpu_torch.train import getalltokens as tgat


def _text(case: str) -> bytes:
    rng = np.random.default_rng(5)
    if case == "cat-random":      # tests/test_device_sort.py's text
        return (b"the cat sat on the mat and the cat ate the rat. " * 300
                + bytes(rng.integers(0, 256, 2000).astype(np.uint8)))
    if case == "high-bytes":      # words with the sign bit set everywhere
        return bytes(rng.choice([0x80, 0xC3, 0xA9, 0xFF, 0x00, 0x7F],
                                6000).astype(np.uint8))
    if case == "one-byte-run":    # every window equal: ties only
        return b"a" * 3000
    return bytes(rng.integers(0, 4, 5000).astype(np.uint8))   # "four-letters"


CASES = ["cat-random", "high-bytes", "one-byte-run", "four-letters"]


def _windows(data, width):
    return np.lib.stride_tricks.sliding_window_view(
        np.concatenate([data, np.zeros(width + 8, np.uint8)]), width)


@pytest.mark.parametrize("width", [41, 13, 4])
@pytest.mark.parametrize("case", CASES)
def test_sort_equals_jax_device_sort(case, width):
    data = np.frombuffer(_text(case), np.uint8)
    n = len(data) - width - 1
    order, fd = device_sorted_windows(data, n, width, device="cpu")
    j_order, j_fd = jax_sorted_windows(data, n, width)
    assert order.dtype == np.uint32 and fd.dtype == np.uint8
    np.testing.assert_array_equal(order, np.asarray(j_order))
    np.testing.assert_array_equal(fd, np.asarray(j_fd))


@pytest.mark.parametrize("case", CASES)
def test_sorted_windows_and_runs_equal_host_sort(case):
    data = np.frombuffer(_text(case), np.uint8)
    width = 41
    n = len(data) - width - 1
    order, fd = device_sorted_windows(data, n, width, device="cpu")
    h_order, h_fd = native_sorted_windows(data, n, width)
    assert sorted(order) == sorted(h_order) == list(range(n))
    win = _windows(data, width)
    # identical sorted window bytes: ties reorder positions, not content
    np.testing.assert_array_equal(win[order], win[h_order])
    for length in range(2, 41):
        np.testing.assert_array_equal(np.minimum(fd, length) < length,
                                      np.minimum(h_fd, length) < length)


def test_one_window():
    data = np.frombuffer(b"x" * 50, np.uint8)
    order, fd = device_sorted_windows(data, 1, 41, device="cpu")
    assert order.tolist() == [0] and fd.shape == (0,)
    with pytest.raises(ValueError):
        device_sorted_windows(data, 0, 41, device="cpu")


GAT_TEXT = (b"Some REAL text with CaPiTaLs, code_id = 3; and the usual "
            b"suspects: the quick brown fox jumps over the lazy dog. " * 120)


@pytest.mark.parametrize("mode,kw", [
    ("balanced", dict(charset=1, normalization="nfd", using_capcode=2,
                      min_occur_total=3, prefilter_min_raw=2)),
    ("unfiltered", dict(charset=1, normalization="none", using_capcode=0,
                        min_occur_total=2, micro_chunks=3,
                        chunk_size=4000)),
])
def test_get_all_tokens_device_sort_equals_host(monkeypatch, tmp_path, mode,
                                                kw):
    """Counts and the ``.tok`` file of the device sort equal the host
    sort's and the JAX package's device path, byte for byte."""
    from tokenmonster_tpu.train import getalltokens as jgat
    out = {}
    for name, mod, env in (("device", tgat, "cpu"), ("host", tgat, None),
                           ("jax", jgat, "1")):
        if env is None:
            monkeypatch.delenv("TM_GAT_DEVICE", raising=False)
        else:
            monkeypatch.setenv("TM_GAT_DEVICE", env)
        counter, char_table, header = mod.get_all_tokens(GAT_TEXT, mode,
                                                         **kw)
        path = tmp_path / f"{name}.tok"
        mod.save_tokens_file(str(path), counter, char_table, header)
        counter.keys_sorted()               # materialises the counts
        out[name] = (path.read_bytes(),
                     {bytes(k): int(c) for k, c in counter.counts.items()})
    assert out["device"][0] == out["host"][0] == out["jax"][0]
    assert out["device"][1] == out["host"][1]
    assert len(out["device"][1]) > 50


def test_sort_device_names(monkeypatch):
    for env, want in (("", None), ("0", None), ("1", "cuda"),
                      ("cpu", "cpu"), ("cuda:1", "cuda:1")):
        monkeypatch.setenv("TM_GAT_DEVICE", env)
        assert tgat.sort_device() == want
    monkeypatch.delenv("TM_GAT_DEVICE")
    assert tgat.sort_device() is None
