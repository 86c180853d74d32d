"""The trainer cell's frozen copies against their sources at the commit
they were taken from (6d463e6b506c), held as
``test_tmbench_frozen.py`` holds the tokenizer cells' copies: each piece
its source's text byte for byte, by the hash of that text at the commit,
and derived again where the source still holds it."""

import os

import pytest

from tmbench.tests.test_tmbench_frozen import BENCH, ROOT, _sha, pieces

PIECES = {
    "reference/trainer.py": ("tokenmonster_tpu_torch/train/trainvocab.py", {
        "_worker_divider": "4485b07e3fc32effdcc1f9c32ac6b8ad4476b5e3b731e7f59d9bfd125042a601",
        "_select_deletions": "7799bbbea8f930127a58303ac8dea3ca8215437835a94fe4065c601816131746",
    }),
    "reference/utils/runes.py": ("tokenmonster_tpu_torch/utils/runes.py", {
        "RUNE_ERROR": "0d0fe0fa2840891de0f220b187a07059c1d9c82aeba07413ea38b1d4489a8526",
        "_MIN_HIGH_SURROGATE": "20804dfd94a7efa95c694ccb5b7c3bb64519e8e34c06351315321d9ddbd33f35",
        "_MAX_HIGH_SURROGATE": "6e61553ef0ee82ebc5e311ca8744ea7af08eaa170076499a4c69957b8f9a671f",
        "_MIN_LOW_SURROGATE": "e0318f6d7a02b7329cc7c2a3afc4dd5803f63b47908550b2ae09108d414241aa",
        "_MAX_LOW_SURROGATE": "b89ff4b5ee0fbe3d54010835bdc62e746bbe09dfd013d517671bcc18a1ffdd21",
        "decode_utf8": "9fe5b0a9e45645f1684c29fa6c68ab3bb229ece935d6557a5b81ff8aceff67a9",
        "decode_last_utf8": "3e032d7cadca0b6ffa23e244f8f9025415e6ce2ca6793c94b38e751096bfc837",
        "decode_utf16": "f1f3b56d38f22986faf70039611fad4a82075d5e83ae8f1b5838d09e21b3d5eb",
        "decode_last_utf16": "2f89b4cb8c5f4058599ae55ee4394c760cb59e4aa6b524c7489c6f56be8eea89",
        "decode_rune": "9cb4bf8519859581990019b0e8f6ee561c464adb6d5fb4e2906b166c11d85262",
        "decode_last_rune": "9b63940619e2d3dfc6fa4952e8734e9c535548b8d916e42ec41bab79b8d63ab3",
    }),
    "reference/core/classify.py": (
        "tokenmonster_tpu_torch/core/tokenmeta.py", {
            "_UNGREEDY_SUFFIXES": "d14e27af8bc22736104984ce784ec3ab3824c68420aca1f2d5f57035779232f7",
            "is_letter_tm": "43ffc81d085127db4d00939b84b28bf9d76f0a31c0ee2cc1d7a09b9944cba4e4",
            "is_alphanum_tm": "0542cd9023b2a02e8474f4459413c68cc8bcf8adb89e53d8a88517b00fe1fe18",
            "is_capcode_tm": "53885d0096e55d902ac03fc67195e39b62c891a96533fd458b02c9cb3cf6b8d7",
            "_is_number": "6bd47931486bd9b352b76e2db9c81a1a9a14a384d08a8fd377e3ce8c43295faf",
            "_is_space": "73e0beb6d16b0f63fd4fb7242d00291cdfaaea3a6317a031b2a87f5ca907281a",
            "has_suffix_pos": "47c16ba366228f87e785b1dcf70545529a0613729751a832975f13b5d0ed790a",
            "classify_token": "1164739eb24f9644358e8ea9c2eeff7f7fdb64e21eb93aff0a5949953923d1c4",
            "compute_alternatives": "6134a53d9a2373f41f3277d055b2dc57bb9f3e3aaa338f0bd0b1f9cd8d5d6f1d",
        }),
    "reference/extra_tokens.py": (
        "tokenmonster_tpu_torch/train/extra_tokens.py", {
            "EXTRA_TOKENS": "050338e4f2a5d114cf29bdcfd870ec8ab40c5cd57d147bbe00688fd151298758",
        }),
}


@pytest.mark.parametrize("copy", sorted(PIECES))
def test_copy_holds_its_pieces_as_they_were_at_the_commit(copy):
    source, want = PIECES[copy]
    got = pieces(os.path.join(BENCH, copy))
    with open(os.path.join(BENCH, copy)) as f:
        doc = f.read(600)
    assert source in doc and "6d463e6b506c" in doc, f"{copy} names no source"
    assert set(got) == set(want), f"{copy} holds pieces it should not"
    for name, digest in want.items():
        assert _sha(got[name][0]) == digest, f"{copy}::{name}"


@pytest.mark.parametrize("copy", sorted(PIECES))
def test_pieces_derive_from_their_sources(copy):
    source, want = PIECES[copy]
    got = pieces(os.path.join(BENCH, copy))
    src = pieces(os.path.join(ROOT, source))
    for name, digest in want.items():
        if name not in src or _sha(src[name][0]) != digest:
            continue            # the source has moved on since the commit
        assert got[name][0] == src[name][0], f"{copy}::{name}"
