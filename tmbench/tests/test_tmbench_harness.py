"""The harness on the CPU: every cell's files found by name, the traffic
schedule, the window's arithmetic, the check for JAX, the last line."""

import json
import os
import re
import statistics

import pytest

from tmbench.harness import cells, traffic, window
from tmbench.harness.modules import refused
from tmbench.run import result_line

BENCH = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(name):
    cell = cells.find(name)
    runner = cells.runner(cell.traffic["kind"])
    assert callable(runner.run) and callable(runner.check)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))


def test_benchmark_names_and_bounds():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {w["config"] for w in BENCH["workloads"]} == {
        c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 << 10


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.find("no.such.cell")


MIX = {"texts": 64, "min_bytes": 256, "max_bytes": 65536}


def test_schedule_repeats_for_a_seed_and_differs_across_seeds():
    big = (1 << 31) + 12345
    a, b = traffic.schedule(MIX, 10 ** 7, big), traffic.schedule(MIX, 10 ** 7, big)
    c = traffic.schedule(MIX, 10 ** 7, 7)
    assert a == b
    assert a != c
    # every seed sends texts of the same lengths, from offsets of its own
    assert sorted(n for _o, n in a) == sorted(n for _o, n in c)
    assert {o for o, _n in a} != {o for o, _n in c}
    assert all(0 <= o < 10 ** 7 for o, _n in a + c)
    lens = traffic.lengths(MIX)
    assert lens[0] >= MIX["min_bytes"] and lens[-1] <= MIX["max_bytes"]


def test_texts_are_cut_at_line_ends_and_wrap_round():
    corpus = b"".join(b"line %d\n" % k for k in range(1000))
    for off, n in [(0, 100), (3, 50), (len(corpus) - 5, 300)]:
        t = traffic.cut(corpus, off, n)
        assert len(t) >= n and t.endswith(b"\n")
        assert t.startswith(b"line ")
        assert t in corpus + corpus
    with pytest.raises(ValueError):
        traffic.cut(corpus, 0, len(corpus))


def test_window_rate_and_tail():
    assert window.rate(30e6, 2.0) == 15e6
    values = list(range(1, 101))
    assert window.tail(values, 95) == statistics.quantiles(
        values, n=100, method="inclusive")[94]
    assert window.tail(values + [10 ** 6], 95) > window.tail(values, 95)
    with pytest.raises(ValueError):
        window.tail([1.0], 95)


def test_jax_check_compares_top_level_names_whole():
    assert refused(["tokenmonster_tpu_torch", "tokenmonster_tpu_torch.ops",
                    "jaxtyping", "numpy"]) == []
    assert refused(["tokenmonster_tpu.ops", "jax", "jaxlib.xla_client",
                    "flax.linen", "numpy"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "tokenmonster_tpu.ops"]


def test_last_line_keys():
    fields = {"attempted": 3, "failed": 0,
              "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
              "device": {"platform": "gpu"},
              "breakdown": {"device_ops": [], "idle_gaps": []}}
    line = result_line(fields, {"ids_off": (0, 0), "missing_off": (0, 0)})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["correct"] is True
    assert line["checks"]["ids_off"] == {"value": 0, "limit": 0}
    bad = result_line(fields, {"ids_off": (4, 0)})
    assert bad["correct"] is False
