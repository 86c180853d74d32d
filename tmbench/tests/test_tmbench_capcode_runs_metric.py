"""``metrics/capcode_run_bytes_pct.bulk.py`` on synthetic spans, in the
style of ``test_tmbench_unicodedata_metric.py``: the bytes of every
``runs`` span over those of every ``capcode`` span in the window, summed
over calls; None where the window holds no ``runs`` span (a program
without the counter) or no ``capcode`` span, where records were dropped
in it, or without the recorder."""

import json
import os
import sys

import pytest

import tokenmonster_tpu_torch
from tmbench.harness import cells
from tokenmonster_tpu_torch import tracing
from tokenmonster_tpu_torch.tracing import Drops, Span

NAME = "capcode_run_bytes_pct.bulk"
W0, W1 = 1_000, 11_000


def _span(id_, name, a, b, parent=None, call=None, n=0):
    return Span(name, a, b, parent, call or id_, 101, n, id_)


# three calls in the window (runs of 36,000 of 40,000 bytes, 7,000 of
# 8,000, none of 2,000: a text of decisions); a call before the window is
# left out
RECORDS = [
    _span(90, "capcode", 0, 500, 89, 89, n=1_000_000),
    _span(91, "runs", 100, 400, 90, 89, n=1_000_000),
    _span(2, "capcode", 1_100, 2_000, 1, 1, n=40_000),
    _span(3, "runs", 1_200, 1_900, 2, 1, n=36_000),
    _span(1, "tokenize", 1_000, 3_000, n=40_000),
    _span(5, "capcode", 3_100, 3_500, 4, 4, n=8_000),
    _span(6, "runs", 3_200, 3_400, 5, 4, n=7_000),
    _span(4, "tokenize", 3_000, 5_000, n=8_000),
    _span(8, "capcode", 5_100, 5_200, 7, 7, n=2_000),
    _span(9, "runs", 5_110, 5_190, 8, 7, n=0),
    _span(7, "tokenize", 5_000, 6_000, n=2_000),
]
CTX = {"window_ns": (W0, W1), "units": 3}


def _read(monkeypatch, records, drops=Drops(0, None, None)):
    monkeypatch.setattr(tracing, "_records", list(records))
    monkeypatch.setattr(tracing, "_drops", drops)
    return cells.reader(NAME)(dict(CTX))


def test_bytes_summed_over_calls(monkeypatch):
    want = 100.0 * (36_000 + 7_000) / (40_000 + 8_000 + 2_000)
    assert _read(monkeypatch, RECORDS) == pytest.approx(want, rel=1e-12)


def test_a_text_of_runs_reads_near_100(monkeypatch):
    recs = [_span(2, "capcode", 1_100, 2_000, 1, 1, n=5_000),
            _span(3, "runs", 1_200, 1_900, 2, 1, n=4_992),
            _span(1, "tokenize", 1_000, 3_000, n=5_000)]
    assert _read(monkeypatch, recs) == pytest.approx(99.84, rel=1e-12)


@pytest.mark.parametrize("records", [
    [], RECORDS[:2], [r for r in RECORDS if r.name != "runs"],
    [r for r in RECORDS if r.name != "capcode"]],
    ids=["none", "before_the_window", "no_runs", "no_capcode"])
def test_none_without_runs_and_capcode_spans_in_the_window(monkeypatch,
                                                           records):
    """No ``runs`` span is what the parent of the counter records (and a
    program that took the Python encoder throughout): None, not 0."""
    assert _read(monkeypatch, records) is None


def test_none_where_records_were_dropped_in_the_window(monkeypatch):
    assert _read(monkeypatch, RECORDS, Drops(1, W0 + 10, W0 + 10)) is None


def test_none_without_the_recorder(monkeypatch):
    monkeypatch.setattr(tracing, "_records", list(RECORDS))
    monkeypatch.setitem(sys.modules, "tokenmonster_tpu_torch.tracing", None)
    monkeypatch.delattr(tokenmonster_tpu_torch, "tracing")
    assert cells.reader(NAME)(dict(CTX)) is None


def test_entry_reads_program_spans_in_the_bulk_cell():
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    m = {e["name"]: e for e in bench["per_layer"]}[NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_span",
                 "layer": "core normalize and capcode",
                 "moves": "tokenize_MBps", "workloads": ["tok32k.bulk"]}
    assert m in cells.find("tok32k.bulk").per_layer
    assert m not in cells.find("tok32k.requests").per_layer
