"""The trainer's junction repair at lanes shorter than the overlap a lane
scans past its chunk, on the CPU (the plain kernel versions), tolerance 0.

With lanes of 32 bytes (``trainvocab.CHUNK``) and dispatches of 64 lanes
(``scan.MAX_LANES``), a lane scans 128 bytes past a chunk of 32 and may
join the text's chain only at its last record, so the repair restarts the
chain from an earlier lane (``ops/stitch.py::restart_point``).  The seeded
``train_vocab`` of ``tests/torch_multidevice_cases.py``'s corpus repairs
there in its first round; every candidate it scores must equal the native
scorer (``tm_tokenize_score``), and the run native's round log and files.
"""

import logging
import os

import numpy as np
import pytest

from tokenmonster_tpu_torch.ops import scan
from tokenmonster_tpu_torch.train import trainvocab as port

import torch_multidevice_cases as cases
from torch_cases import native_score

CHUNK, MAX_LANES = 32, 64


def _run(out, device, backend):
    """The seeded run for one round; its round log and files."""
    rounds = []
    logger = logging.getLogger("tokenmonster_tpu_torch.trainvocab")

    class Rounds(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("round "):
                rounds.append(record.getMessage())

    handler, old = Rounds(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        cases.train(str(out), device, backend=backend, max_rounds=1)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    files = {n: open(os.path.join(out, n), "rb").read()
             for n in sorted(os.listdir(out))}
    return rounds, files


@pytest.mark.parametrize("device", ["cpu", ["cpu", "cpu"]],
                         ids=["one_device", "two_slots"])
def test_lanes_shorter_than_the_overlap_score_as_native(tmp_path,
                                                        monkeypatch, device):
    cases.pool(str(tmp_path))
    want = _run(tmp_path / "native", None, "native")
    scored = []

    class Checked(port.GpuCandidateScorer):
        def score(self, cand, datasets):
            got = super().score(cand, datasets)
            scored.append((got, native_score(cand, datasets), self.repairs))
            return got

    monkeypatch.setattr(port, "GpuCandidateScorer", Checked)
    monkeypatch.setattr(port, "CHUNK", CHUNK)
    monkeypatch.setattr(scan, "MAX_LANES", MAX_LANES)
    got = _run(tmp_path / "cuda", device, "cuda")
    assert scored and scored[-1][2] > 0      # junctions were repaired
    for (s, n_tok, miss), (s_n, n_tok_n, miss_n), _r in scored:
        np.testing.assert_array_equal(s, s_n)
        assert n_tok == n_tok_n and miss == miss_n
    assert got == want
