"""Whole runs on the CPU at a size a test holds (the kernels' plain
versions, the program's "cpu" device): everything a run does but its
look for a card.  A sound run is correct; a run whose timed path is
broken underneath comes out not correct, for each fault the cells can
have (a token altered where it is produced, half of a text left out; no
cell has a state that a step could leave unchanged, and none an exchange
between chips); the control (the greedy reference in the program's
place) and the same faults planted in the reference read above every
limit.  On the card ``tmbench/control.py`` reads those at each cell's
own size."""

import copy

import numpy as np
import pytest

from tmbench import control
from tmbench.harness import cells, inputs
from tmbench.reference.pool import Reference
from tmbench.run import measure, result_line


@pytest.fixture(autouse=True)
def cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(inputs, "CACHE",
                        str(tmp_path_factory.getbasetemp() / "tmcache"))


@pytest.fixture
def reference():
    with Reference(0) as ref:
        yield ref


def tok_cell():
    cell = copy.deepcopy(cells.find("tok32k.requests"))
    cell.config["corpus"]["min_bytes"] = 200_000
    cell.traffic.update(texts=6, min_bytes=256, max_bytes=6000, check=6)
    return cell


def run(cell, reference, seconds=0.5):
    fields, checks, info = measure(cell, 2 ** 31 + 77, seconds, False, "cpu",
                                   reference, t_start=0.0)
    return result_line(fields, checks), info


def test_tokenizer_run_is_correct(reference):
    line, info = run(tok_cell(), reference)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"request_p95_ms", "setup_s"}
    assert info["window"]["route_counts"]["native"] == 0


def _altered(ids):
    ids = np.array(ids)
    ids[len(ids) // 2] ^= 1
    return ids


@pytest.mark.parametrize("fault", ["token_altered", "half_left_out"])
def test_tokenizer_fault_is_not_correct(reference, monkeypatch, fault):
    from tokenmonster_tpu_torch.ops.scan import GpuTokenizer
    tokenize = GpuTokenizer.tokenize

    def broken(self, data):
        ids, missing = tokenize(self, data)
        if fault == "token_altered":
            return _altered(ids), missing
        return ids[:len(ids) // 2], missing
    monkeypatch.setattr(GpuTokenizer, "tokenize", broken)
    line, _info = run(tok_cell(), reference)
    assert not line["correct"]
    assert line["checks"]["ids_off"]["value"] > 0


def test_tokenizer_control_and_faults_read_above_the_limit(reference):
    got = control.readings(tok_cell(), 5, 0.5, "cpu", reference)
    assert all(v == 0 for v, _lim in got["program"].values())
    for how in ("greedy", "half", "altered"):
        assert got[how]["ids_off"][0] > 0, how

