"""A cell's files, found by name: ``BENCHMARK.json`` at the checkout's
root names each cell's configuration, traffic and metrics;
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` under this benchmark hold them, and the traffic's
``kind`` names the module that runs it, ``harness/<kind>_cell.py``.
Adding a cell, a metric or a kind of traffic adds files and entries and
edits none."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list     # the cell's end-to-end metric entries
    per_layer: list      # the cell's per-layer metric entries


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def find(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    KeyError for a cell it does not list."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    # a per-layer metric without a list of cells is read in every cell
    # that reports the end-to-end metric it moves
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name=name,
                config=_load_json(os.path.join(BENCH, "configs",
                                               w["config"] + ".json")),
                traffic=_load_json(os.path.join(BENCH, "traffic",
                                                w["traffic"] + ".json")),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "tmbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def runner(kind: str):
    """The module that runs traffic of ``kind``: ``harness/<kind>_cell.py``,
    with ``run(cell, seed, seconds, traced, device, t_start, reference)``
    returning a run (``attempted``, ``failed``, ``metrics``, ``ctx``,
    ``info``), ``check(run, seed, count, reference, stand_in=None)``
    returning {name: (value, limit)}, and ``STAND_INS``."""
    return importlib.import_module(f".{kind}_cell", __package__)
