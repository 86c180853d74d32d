#!/usr/bin/env python3
"""The benchmark of tokenmonster_tpu_torch, one cell a run.

    python3 tmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``tmbench/configs/<config>.json``) and a traffic mix
(``tmbench/traffic/<traffic>.json``), whose ``kind`` names the module
that runs it, ``harness/<kind>_cell.py`` (today "tokenize").  Set-up
makes the inputs from the seed and warms every shape the window uses;
the window runs ``--seconds``; then the sample of what it produced is
held against the plain reference (``tmbench/reference``), each number
compared printed beside its limit.
With ``--trace 0`` the last line's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics (``metrics/<name>.py``,
read from the benchmark's spans, the program's counters and a
``torch.profiler`` trace of the window).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.  The earlier lines give the counters,
the set-up's parts and each tail's sample count.  Without a CUDA card, or
with JAX or the JAX package loaded once the window has closed, it exits
non-zero and prints no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _paths() -> None:
    """The checkout on ``sys.path``; the program's kernel caches in fixed
    directories inside it."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cache = os.path.join(ROOT, ".tmbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": repr(e)}
    return {"nvidia_smi": got[0] if got else ""}


def measure(cell, seed: int, seconds: float, traced: bool, device: str,
            reference, t_start: float = T_START, count: int | None = None):
    """One run of ``cell`` (``harness.cells.Cell``) on ``device``: (the
    result's fields, the checks {name: (value, limit)}, info lines)."""
    from tmbench.harness import cells
    from tmbench.harness.trace import breakdown, busy, gaps

    runner = cells.runner(cell.traffic["kind"])
    if device != "cpu":
        import torch
        torch.cuda.reset_peak_memory_stats()
    out = runner.run(cell, seed, seconds, traced, device, t_start,
                     reference)
    fields = {"attempted": out.attempted, "failed": out.failed}
    dev = {"platform": "cpu" if device == "cpu" else "gpu"}
    if device != "cpu":
        import torch
        dev.update(kind=torch.cuda.get_device_name(0), count=1,
                   memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = cells.reader(m["name"])(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        w0, w1 = out.ctx["window_ns"]
        ops = out.ctx.get("ops") or []
        spans = busy(ops)
        dev.update(busy_s=sum(b - a for a, b in spans) / 1e9,
                   window_s=(w1 - w0) / 1e9)
        fields["breakdown"] = breakdown(ops, gaps(spans, w0, w1),
                                        out.ctx["spans"])
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    fields["metrics"] = metrics
    fields["device"] = dev
    out.ctx.clear()
    out.tokenizer = None
    if device != "cpu":
        import torch
        torch.cuda.empty_cache()
    checks = runner.check(out, seed, count or cell.traffic["check"],
                          reference)
    return fields, checks, out.info


def result_line(fields: dict, checks: dict) -> dict:
    """The last line: correct when every number compared is within its
    limit, the run's fields, and the numbers compared with their limits
    last."""
    line = {"correct": all(v <= lim for v, lim in checks.values())}
    for key in ("attempted", "failed", "metrics", "device", "breakdown"):
        if key in fields:
            line[key] = fields[key]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from tmbench.harness import cells
    from tmbench.harness.modules import refused
    from tmbench.reference.pool import Reference

    cell = cells.find(args.workload)
    chips = next(w["chips"] for w in cells.benchmark()["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card for {args.workload} ({chips} needed, "
              f"{torch.cuda.device_count()} seen)", file=sys.stderr)
        return 2
    head = {"card": card(), "workload": args.workload, "seed": args.seed}
    with Reference() as reference:
        fields, checks, info = measure(cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda", reference)
    print(json.dumps(head), flush=True)
    for key, value in info.items():
        print(json.dumps({key: value}, default=str), flush=True)
    bad = refused(sys.modules)
    if bad:
        print(f"loaded the JAX stack or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    line = result_line(fields, checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
