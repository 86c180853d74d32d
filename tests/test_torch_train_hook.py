"""``train_vocab``'s ``on_round`` hook on the CPU (the kernels' plain
versions): called at the end of every round with what the round did; a
true return stops the loop at that boundary as ``max_rounds`` does; a
hook that never stops it, or none, leaves every round as it was."""

import logging
import os

import numpy as np
import pytest

from tokenmonster_tpu_torch.train import trainvocab as tv
from torch_cases import pool_file  # noqa: F401 (fixture)


def _train(pool_file, out, caplog, on_round=None, **cfg):
    """A seeded run; returns its round log lines and files {name: bytes}."""
    corpus, tok = pool_file
    caplog.clear()
    kw = dict(vocab_size=120, workers=2, fast=True, seed=7, keep_trying=5)
    kw.update(cfg)
    with caplog.at_level(logging.INFO, logger="tokenmonster_tpu_torch"
                         ".trainvocab"):
        tv.train_vocab(corpus, tok, str(out), tv.TrainConfig(**kw),
                       device="cpu", on_round=on_round)
    rounds = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("round ")]
    files = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name), "rb") as f:
            files[name] = f.read()
    return rounds, files


def test_no_hook_and_a_hook_that_never_stops_make_the_same_rounds(
        pool_file, tmp_path, caplog):
    seen = []
    plain = _train(pool_file, tmp_path / "plain", caplog)
    hooked = _train(pool_file, tmp_path / "hooked", caplog,
                    on_round=lambda r: seen.append(r) and False)
    assert hooked == plain and len(plain[0]) > 5
    assert [r.number for r in seen] == list(range(1, len(seen) + 1))
    assert len(seen) >= len(plain[0])


@pytest.mark.parametrize("last", [1, 2, 3])
def test_hook_stops_the_loop_at_a_round_boundary(pool_file, tmp_path,
                                                 caplog, last):
    """Stopped after round ``last``: the rounds and files of
    ``max_rounds=last``; the hook saw rounds 1 to ``last``, each with its
    candidates' results, and before midway every vote of a deletion
    candidate was a deletion."""
    seen = []

    def stop(r):
        seen.append(r)
        return r.number == last
    stopped = _train(pool_file, tmp_path / "stopped", caplog, on_round=stop)
    bounded = _train(pool_file, tmp_path / "bounded", caplog,
                     max_rounds=last)
    assert stopped == bounded and len(stopped[0]) == last
    assert [r.number for r in seen] == list(range(1, last + 1))
    for r, line in zip(seen, stopped[0]):
        assert line.startswith(f"round {r.number}: deleted {r.removed}; "
                               f"remaining {r.remaining}")
        assert r.phase == "" and len(r.candidates) == 2
        votes = set()
        for c in r.candidates:
            assert c.work_type == 0
            assert len(c.scores) == len(c.vocab.reverse)
            assert c.tokens_in_text > 0 and c.datasets
            votes |= set(tv._select_deletions(
                c.vocab, c.scores, r.vocab_size, c.remaining_plus,
                r.midway_target, r.fast, r.specials, c.work_type))
        assert set(r.deleted) == votes and r.removed == len(votes) > 0
        assert r.counters["strips_scored"] > 0
    assert [r.counters["strips_scored"] for r in seen] == [
        k * seen[0].counters["strips_scored"] for k in range(1, last + 1)]


def test_hook_sees_the_native_backends_rounds(pool_file, tmp_path, caplog):
    """The host scorer's rounds reach the hook too, with no counters."""
    seen = []
    _train(pool_file, tmp_path, caplog, backend="native",
           on_round=lambda r: seen.append(r) or r.number == 1)
    assert len(seen) == 1 and seen[0].counters == {}
    assert all(isinstance(c.scores, np.ndarray) for c in seen[0].candidates)
