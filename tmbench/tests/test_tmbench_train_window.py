"""The trainer cell's window (``harness/rounds.py``) driven by a fake loop
with a fake clock, and the cell's readers on synthetic records: the
window opens at the warm-up round's end, closes only on a round boundary,
holds at least three rounds and counts every byte of every round it
holds, whole."""

import os

import numpy as np
import pytest

from tmbench.harness import cells
from tmbench.harness.rounds import MidwayReached, RoundWindow
from tokenmonster_tpu_torch import tracing
from tokenmonster_tpu_torch.tracing import Drops, Span
from tokenmonster_tpu_torch.train.trainvocab import Round, Scored


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def ns(self):
        return int(self.t * 1e9)


def _round(number, strip_len, phase=""):
    vocab = type("V", (), {"reverse": [b"a", b"b"]})()
    cands = [Scored(vocab, 0, [b"x" * strip_len] * 3, np.zeros(2, np.int64),
                    5, set(), 1000, [b"a", b"b"]) for _ in range(2)]
    return Round(number, {}, 0, 1000, phase, cands, 32000, 72000, True,
                 frozenset(), {})


def fake_loop(window, clock, durations, strip_len=10, phase_at=None):
    """Call ``window`` at the end of each round, round k taking
    ``durations[k - 1]`` seconds and scoring 2 x 3 strips of
    ``strip_len`` * k bytes; returns the round it stopped after, or None
    where it never did."""
    for k, d in enumerate(durations, 1):
        clock.t += d
        if window(_round(k, strip_len * k,
                         "midway" if k == phase_at else "")):
            return k
    return None


def test_closes_at_the_first_boundary_past_its_seconds():
    clock = Clock()
    w = RoundWindow(10.0, 3, clock=clock, clock_ns=clock.ns)
    stopped = fake_loop(w, clock, [7.0, 4.0, 4.0, 4.0, 4.0, 4.0])
    # opens at 107; rounds end 111, 115, 119 (12 s >= 10, 3 rounds)
    assert stopped == 4 and w.closed
    assert w.t1 - w.t0 == pytest.approx(12.0)
    assert [r.number for r in w.rounds] == [2, 3, 4]
    assert w.bytes == sum(2 * 3 * 10 * k for k in (2, 3, 4))
    assert w.round_bytes == [2 * 3 * 10 * k for k in (2, 3, 4)]
    assert w.warm.number == 1


def test_holds_three_rounds_however_long_they_are():
    clock = Clock()
    w = RoundWindow(1.0, 3, clock=clock, clock_ns=clock.ns)
    assert fake_loop(w, clock, [1.0] + [50.0] * 6) == 4
    assert len(w.rounds) == 3 and w.t1 - w.t0 == pytest.approx(150.0)


@pytest.mark.parametrize("durations", [[3.0, 2.9, 3.3, 5.1, 2.2, 4.4, 3.3],
                                       [0.5, 9.0, 0.1, 0.1, 0.1, 7.0, 1.0]])
def test_the_window_is_whole_rounds_on_boundaries(durations):
    """Whatever the rounds take, the window's ends are round ends, its
    seconds the sum of its rounds' seconds and its bytes theirs."""
    clock = Clock()
    w = RoundWindow(8.0, 3, clock=clock, clock_ns=clock.ns)
    stopped = fake_loop(w, clock, durations)
    ends = np.cumsum([100.0] + durations)
    assert w.t0 == ends[1] and w.t1 == ends[stopped]
    held = durations[1:stopped]
    assert w.t1 - w.t0 == pytest.approx(sum(held))
    assert sum(held[:-1]) < 8.0 or len(held) == 3
    assert len(held) >= 3 and sum(held) >= 8.0
    assert w.ends == list(ends[2:stopped + 1])
    assert w.t0_ns == int(ends[1] * 1e9)


def test_a_loop_that_ends_first_leaves_it_open():
    clock = Clock()
    w = RoundWindow(100.0, 3, clock=clock, clock_ns=clock.ns)
    assert fake_loop(w, clock, [1.0, 1.0, 1.0]) is None
    assert not w.closed


def test_a_round_past_midway_raises():
    clock = Clock()
    w = RoundWindow(100.0, 3, clock=clock, clock_ns=clock.ns)
    with pytest.raises(MidwayReached):
        fake_loop(w, clock, [1.0] * 5, phase_at=3)


def test_open_and_close_run_at_the_boundaries_outside_the_window():
    clock, calls = Clock(), []
    w = RoundWindow(2.0, 3, clock=clock, clock_ns=clock.ns,
                    on_open=lambda: calls.append(("open", clock.t)),
                    on_close=lambda: calls.append(("close", clock.t)))
    fake_loop(w, clock, [1.0] * 6)
    assert calls == [("open", 101.0), ("close", 104.0)]


def test_middle_rounds_keep_only_what_the_check_reads():
    clock = Clock()
    w = RoundWindow(4.0, 3, clock=clock, clock_ns=clock.ns)
    fake_loop(w, clock, [1.0] * 8)
    first, *middle, last = w.rounds
    assert middle and first.candidates[0].datasets
    assert last.candidates[0].datasets
    for r in middle:
        assert all(c.datasets is None and c.vocab.reverse == [b"a", b"b"]
                   for c in r.candidates)


# the trainer's program spans: a window of 10,000 ns on two worker
# threads and the master
W0, W1 = 1_000, 11_000
M, A, B = 1, 2, 3


def _span(id_, name, a, b, parent=None, call=None, thread=M, n=0):
    return Span(name, a, b, parent, call or id_, thread, n, id_)


RECORDS = [
    _span(1, "round", 1_000, 9_000, n=2),
    _span(2, "prune", 1_000, 2_000, 1, 1, n=50),
    _span(3, "select", 6_000, 6_500, 1, 1, n=7),
    _span(4, "prune", 8_000, 9_000, 1, 1, n=43),
    _span(10, "candidate", 2_000, 6_000, thread=A, n=600),
    _span(11, "build", 2_000, 2_500, 10, 10, A, n=40),
    _span(12, "mask", 2_500, 3_000, 10, 10, A, n=90),
    _span(13, "score", 3_000, 5_000, 10, 10, A, n=3),
    _span(14, "readback", 4_500, 5_000, 13, 10, A, n=64),
    _span(15, "rescore", 5_000, 6_000, 10, 10, A, n=3),
    _span(20, "candidate", 2_000, 12_000, thread=B, n=600),
    _span(21, "build", 2_000, 3_000, 20, 20, B, n=40),
    _span(22, "mask", 3_000, 4_000, 20, 20, B, n=90),
    _span(23, "score", 4_000, 7_000, 20, 20, B, n=3),
    _span(24, "rescore", 7_000, 12_000, 20, 20, B, n=2),
]
WANT = {
    "prune_pct.train": 100.0 * 2_000 / 10_000,
    "select_pct.train": 100.0 * 500 / 10_000,
    "build_pct.train": 100.0 * 1_500 / 10_000,
    "mask_pct.train": 100.0 * 1_500 / 10_000,
    "score_pct.train": 100.0 * 5_000 / 10_000,
    "rescore_pct.train": 100.0 * (1_000 + 4_000) / 10_000,
    "readback_pct.train": 100.0 * 500 / 10_000,
}


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(tracing, "_records", list(RECORDS))
    monkeypatch.setattr(tracing, "_drops", Drops(0, None, None))


def _ctx(**kw):
    ctx = {"window_ns": (W0, W1), "units": 2, "ops": [("k", 2_000, 3_000)],
           "dispatches": [], "tables": None,
           "counters": ({"strips_scored": 10, "strips_rescored": 9},
                        {"strips_scored": 410, "strips_rescored": 405})}
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers(recorded, name):
    assert cells.reader(name)(_ctx()) == pytest.approx(WANT[name],
                                                       rel=1e-12)


def test_counter_and_device_readers(recorded):
    assert cells.reader("rescored_strips.train")(_ctx()) == \
        pytest.approx(100.0 * 396 / 400)
    assert cells.reader("device_idle_pct.train")(_ctx()) == \
        pytest.approx(90.0)
    # a program without the counters, or a window that scored nothing
    assert cells.reader("rescored_strips.train")(_ctx(counters=({}, {}))) \
        is None
    assert cells.reader("match_roofline.train")(_ctx()) is None


def test_trainer_metrics_list_only_the_trainer_cell():
    for name in list(WANT) + ["rescored_strips.train", "match_roofline.train",
                              "device_idle_pct.train"]:
        assert os.path.exists(os.path.join(cells.BENCH, "metrics",
                                           name + ".py"))
        assert name in {m["name"]
                        for m in cells.find("train32k.rounds").per_layer}
        for other in ("tok32k.bulk", "tok32k.requests"):
            assert name not in {m["name"]
                                for m in cells.find(other).per_layer}
