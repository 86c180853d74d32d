"""The benchmark's command on the card, one short run of the cheapest
cell, untraced and traced:

    python3 -m pytest -m gpu tmbench/tests/test_tmbench_card.py

Skips where no CUDA card is seen."""

import json
import os
import subprocess
import sys

import pytest

from tmbench.harness.cells import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_requests_cell_on_the_card(card, trace):
    got = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tmbench", "run.py"),
         "--workload", "tok32k.requests", "--seed", "3141592653",
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
        assert "device_idle_pct.req" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"request_p95_ms", "setup_s"}
