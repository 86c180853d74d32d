"""``metrics/unicodedata_bytes_pct.bulk.py`` on synthetic spans, in the
style of ``test_tmbench_program_spans.py``: the bytes of every
``unicodedata`` span over those of every ``nfd`` span in the window, summed
over calls; 0 where no ``unicodedata`` span was opened; None where the
window holds no span, records were dropped in it, or the program has no
recorder or no runs route."""

import json
import os
import sys

import pytest

import tokenmonster_tpu_torch
from tmbench.harness import cells
from tokenmonster_tpu_torch import tracing
from tokenmonster_tpu_torch.tracing import Drops, Span

NAME = "unicodedata_bytes_pct.bulk"
W0, W1 = 1_000, 11_000


def _span(id_, name, a, b, parent=None, call=None, n=0):
    return Span(name, a, b, parent, call or id_, 101, n, id_)


# three calls in the window: two hand unicodedata their runs (120 of
# 40,000 bytes, 64 of 8,000), one is ASCII and opens none; a call before
# the window is left out
RECORDS = [
    _span(90, "nfd", 0, 500, 89, 89, n=1_000_000),
    _span(91, "unicodedata", 100, 400, 90, 89, n=1_000_000),
    _span(2, "nfd", 1_100, 2_000, 1, 1, n=40_000),
    _span(3, "unicodedata", 1_200, 1_300, 2, 1, n=120),
    _span(1, "tokenize", 1_000, 3_000, n=40_000),
    _span(5, "nfd", 3_100, 3_500, 4, 4, n=8_000),
    _span(6, "unicodedata", 3_200, 3_300, 5, 4, n=64),
    _span(4, "tokenize", 3_000, 5_000, n=8_000),
    _span(8, "nfd", 5_100, 5_200, 7, 7, n=2_000),
    _span(7, "tokenize", 5_000, 6_000, n=2_000),
]
CTX = {"window_ns": (W0, W1), "units": 3}


def _read(monkeypatch, records, drops=Drops(0, None, None)):
    monkeypatch.setattr(tracing, "_records", list(records))
    monkeypatch.setattr(tracing, "_drops", drops)
    return cells.reader(NAME)(dict(CTX))


def test_bytes_summed_over_calls(monkeypatch):
    want = 100.0 * (120 + 64) / (40_000 + 8_000 + 2_000)
    assert _read(monkeypatch, RECORDS) == pytest.approx(want, rel=1e-12)


def test_every_byte_through_unicodedata_reads_100(monkeypatch):
    recs = [_span(2, "nfd", 1_100, 2_000, 1, 1, n=5_000),
            _span(3, "unicodedata", 1_200, 1_900, 2, 1, n=5_000),
            _span(1, "tokenize", 1_000, 3_000, n=5_000)]
    assert _read(monkeypatch, recs) == 100.0


def test_zero_without_unicodedata_spans(monkeypatch):
    recs = [r for r in RECORDS if r.name != "unicodedata"]
    assert _read(monkeypatch, recs) == 0.0


@pytest.mark.parametrize("records", [[], RECORDS[:2],
                                     [r for r in RECORDS if r.name != "nfd"]],
                         ids=["none", "before_the_window", "no_nfd"])
def test_none_without_nfd_spans_in_the_window(monkeypatch, records):
    assert _read(monkeypatch, records) is None


def test_none_where_records_were_dropped_in_the_window(monkeypatch):
    assert _read(monkeypatch, RECORDS, Drops(1, W0 + 10, W0 + 10)) is None


def test_none_without_the_recorder(monkeypatch):
    monkeypatch.setattr(tracing, "_records", list(RECORDS))
    monkeypatch.setitem(sys.modules, "tokenmonster_tpu_torch.tracing", None)
    monkeypatch.delattr(tokenmonster_tpu_torch, "tracing")
    assert cells.reader(NAME)(dict(CTX)) is None


def test_none_for_a_program_without_the_runs_route(monkeypatch):
    """The parent of the commit that added the span opens ``nfd`` spans
    and no ``unicodedata`` span, though every byte reaches it: None, not
    0."""
    from tokenmonster_tpu_torch.core import normalize
    monkeypatch.delattr(normalize, "RUNS_MIN_BYTES")
    assert _read(monkeypatch, RECORDS) is None


def test_entry_reads_program_spans_in_the_bulk_cell():
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    m = {e["name"]: e for e in bench["per_layer"]}[NAME]
    assert m == {"name": NAME, "unit": "%", "better": "lower",
                 "source": "program_span",
                 "layer": "core normalize and capcode",
                 "moves": "tokenize_MBps", "workloads": ["tok32k.bulk"]}
    assert m in cells.find("tok32k.bulk").per_layer
    assert m not in cells.find("tok32k.requests").per_layer
