"""The readers of the program's spans (``harness/program.py`` and the
eleven ``metrics/*`` that use it) on synthetic records and device
operations, value for value; None where the window holds no program
spans, where records were dropped in it, and where the program has no
recorder (the parent of the commit that added it)."""

import json
import os
import sys

import pytest

import tokenmonster_tpu_torch
from tmbench.harness import cells
from tokenmonster_tpu_torch import tracing
from tokenmonster_tpu_torch.tracing import Drops, Span

W0, W1 = 1_000, 11_000          # the window: 10,000 ns
T1, T2 = 101, 102               # two threads


def _span(id_, name, a, b, parent=None, call=None, thread=T1, n=0):
    return Span(name, a, b, parent, call or id_, thread, n, id_)


# two requests: the first normalizes, reruns and ends inside the window;
# the second's device span runs past it and holds no rerun.  One record
# starts before the window and one after it.
RECORDS = [
    _span(90, "device", 0, 900, thread=T2),
    _span(3, "nfd", 1_100, 1_300, 1, 1),
    _span(4, "capcode", 1_300, 1_500, 1, 1),
    _span(6, "stage", 1_600, 1_800, 5, 1),
    _span(7, "launch", 1_800, 2_000, 5, 1),
    _span(8, "wait", 2_000, 2_600, 5, 1),
    _span(9, "rerun", 2_600, 4_000, 5, 1),
    _span(10, "wait", 3_000, 3_200, 9, 1),
    _span(11, "expand", 4_000, 4_500, 5, 1),
    _span(5, "device", 1_600, 4_900, 1, 1),
    _span(1, "tokenize", 1_000, 5_000),
    _span(13, "stage", 6_100, 6_300, 12, 20, T2),
    _span(14, "launch", 6_300, 6_400, 12, 20, T2),
    _span(15, "wait", 6_400, 8_000, 12, 20, T2),
    _span(16, "expand", 8_000, 8_400, 12, 20, T2),
    _span(12, "device", 6_100, 12_000, 20, 20, T2),
    _span(20, "tokenize", 6_000, 12_500, thread=T2),
    _span(91, "expand", 11_000, 11_500, thread=T2),
]
# the card busy in [2000, 3000) and [7000, 8000): idle 1000 + 4000 + 3000
# ns, of which [5000, 6000) is outside every tokenize span
OPS = [("k", 2_000, 3_000), ("k", 7_000, 8_000)]
UNITS = 2

WANT = {
    # device: 3300 + (11000 - 6100) clipped to the window
    "device_ms.req": (3_300 + 4_900) / 1e6 / UNITS,
    "stage_ms.req": (200 + 200) / 1e6 / UNITS,
    "launch_ms.req": (200 + 100) / 1e6 / UNITS,
    "wait_ms.req": (600 + 200 + 1_600) / 1e6 / UNITS,
    "expand_ms.req": (500 + 400) / 1e6 / UNITS,
    "rerun_pct.req": 50.0,
    "idle_outside_pct.req": 100.0 * 1_000 / 8_000,
    "nfd_pct.bulk": 100.0 * 200 / 10_000,
    "capcode_pct.bulk": 100.0 * 200 / 10_000,
    "device_pct.bulk": 100.0 * (3_300 + 4_900) / 10_000,
    "expand_pct.bulk": 100.0 * 900 / 10_000,
}
ACCEPTED_CELLS = {"tok32k.bulk", "tok32k.requests"}


def _ctx():
    return {"window_ns": (W0, W1), "units": UNITS, "ops": list(OPS)}


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(tracing, "_records", list(RECORDS))
    monkeypatch.setattr(tracing, "_drops", Drops(0, None, None))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_values(recorded, name):
    assert cells.reader(name)(_ctx()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_drops_after_the_window_leave_it_whole(recorded, monkeypatch, name):
    monkeypatch.setattr(tracing, "_drops", Drops(4, W1, W1 + 500))
    assert cells.reader(name)(_ctx()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("drops", [Drops(1, W0 + 10, W0 + 10),
                                   Drops(9, W0 - 500, W1 + 500),
                                   Drops(2, W0 - 500, W0)])
@pytest.mark.parametrize("name", sorted(WANT))
def test_none_where_records_were_dropped_in_the_window(
        recorded, monkeypatch, name, drops):
    monkeypatch.setattr(tracing, "_drops", drops)
    assert cells.reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_where_the_window_holds_no_program_span(monkeypatch, name):
    monkeypatch.setattr(tracing, "_records", [RECORDS[0], RECORDS[-1]])
    monkeypatch.setattr(tracing, "_drops", Drops(0, None, None))
    assert cells.reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_without_the_recorder(recorded, monkeypatch, name):
    """A program without ``tracing`` (the commit before it) reads None and
    raises nothing."""
    monkeypatch.setitem(sys.modules, "tokenmonster_tpu_torch.tracing", None)
    monkeypatch.delattr(tokenmonster_tpu_torch, "tracing")
    with pytest.raises(ImportError):
        from tokenmonster_tpu_torch import tracing as _gone  # noqa: F401
    assert cells.reader(name)(_ctx()) is None


def test_rerun_share_zero_and_idle_without_trace(recorded, monkeypatch):
    monkeypatch.setattr(tracing, "_records",
                        [r for r in RECORDS if r.name != "rerun"])
    assert cells.reader("rerun_pct.req")(_ctx()) == 0.0
    ctx = _ctx()
    del ctx["ops"]
    assert cells.reader("idle_outside_pct.req")(ctx) is None


def test_new_entries_read_program_spans_in_accepted_cells():
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    cell_names = {w["name"] for w in bench["workloads"]}
    assert ACCEPTED_CELLS <= cell_names
    for name in WANT:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["workloads"] and set(m["workloads"]) <= ACCEPTED_CELLS
        assert os.path.exists(os.path.join(cells.BENCH, "metrics",
                                           name + ".py"))
        for cell in m["workloads"]:
            assert m in cells.find(cell).per_layer
