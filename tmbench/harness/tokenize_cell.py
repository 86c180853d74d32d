"""Cells whose traffic is of kind "tokenize": one caller sends texts to
``load(vocab, device, route="device").tokenize(text)`` in a closed loop.

Set-up loads the vocabulary (its placement), makes the corpus and the
run's texts from the seed, and tokenizes each distinct text once, which
warms exactly the dispatch geometries the window will use (a capture
each).  The window then sends the texts in their seeded order until
``seconds`` have passed, every call timed from the call to the ids
returned.  Once it has closed, a sample of the calls drawn from the seed
(with the longest text sent) is held against the plain reference."""

from __future__ import annotations

import hashlib
import random
import time

import numpy as np

from ..frozen.fnv import fnv1a64
from . import inputs, traffic as gen
from .spans import Spans
from .trace import Trace
from .window import rate, tail


class Run:
    """What one run of a tokenizer cell measured and kept for its check."""

    def __init__(self):
        self.info = {}          # earlier lines: counters and set-up parts
        self.calls = []         # (text index, seconds, ids, missing, ok)
        self.attempted = 0      # calls made in the window
        self.failed = 0         # of them, calls that raised or left the
                                # device route
        self.metrics = {}
        self.ctx = {}


def run(cell, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, reference) -> Run:
    import tokenmonster_tpu_torch as tm
    from tokenmonster_tpu_torch.ops import _build

    cfg, mix, out = cell.config, cell.traffic, Run()
    corpus, dropped, made_s, cached = inputs.corpus(cfg, reference)
    out.info["corpus"] = {"bytes": len(corpus), "lines_dropped": dropped,
                          "sha256": hashlib.sha256(corpus).hexdigest(),
                          "made_s": made_s, "from_cache": cached}
    sched = gen.schedule(mix, len(corpus), seed)
    texts = [gen.cut(corpus, off, n) for off, n in sched]

    t0 = time.perf_counter()
    v = tm.load(inputs.vocab_file(cfg), device=device, route="device")
    tk = v._tpu_tokenizer()
    out.info["load_s"] = time.perf_counter() - t0
    missing = []
    spans = Spans()
    spans.wrap(tk, "tokenize", "gputok",
               on_return=lambda res, _a: missing.append(res[1]))
    t0 = time.perf_counter()
    for text in texts:
        v.tokenize(text)
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
    out.info["warm_s"] = time.perf_counter() - t0
    out.info["captures_warm"] = tk.captures
    missing.clear()

    work = []
    if traced:
        spans.wrap(v._core, "normalize", "normalize")
        spans.wrap(tk, "stage", "stage", on_return=lambda st, _a: work.append(
            [(buf.numel(), n) for buf, n, _last in st.bufs]))
        trace = Trace()
        trace.start()
    else:
        spans.by_name.clear()
    before = {"route": dict(v.route_counts), "fallbacks": tk.host_fallbacks,
              "repairs": tk.repairs, "captures": tk.captures,
              "launches": dict(_build.launches)}

    setup_s = time.perf_counter() - t_start
    w0_ns, w0 = time.time_ns(), time.perf_counter()
    k, n = 0, len(texts)
    while True:
        i = k % n
        fb = tk.host_fallbacks
        a = time.perf_counter()
        try:
            ids = v.tokenize(texts[i])
            ok = v.last_route == "device" and tk.host_fallbacks == fb
        except Exception as e:          # counted as failed, run goes on
            ids, ok = None, False
            out.info.setdefault("errors", []).append(repr(e))
        b = time.perf_counter()
        out.calls.append((i, b - a, ids, missing[-1] if ok else None, ok))
        k += 1
        if b - w0 >= seconds:
            break
    w1_ns, w1 = time.time_ns(), b
    if traced:
        trace.stop()
    spans.restore()

    out.info["window"] = {
        "calls": len(out.calls), "seconds": w1 - w0,
        "route_counts": {r: c - before["route"][r]
                         for r, c in v.route_counts.items()},
        "host_fallbacks": tk.host_fallbacks - before["fallbacks"],
        "repairs": tk.repairs - before["repairs"],
        "captures": tk.captures - before["captures"],
        "launches": {name: c - before["launches"][name]
                     for name, c in _build.launches.items()}}
    out.attempted = len(out.calls)
    out.failed = sum(1 for *_r, ok in out.calls if not ok)
    raw = sum(len(texts[i]) for i, *_r in out.calls)
    lat = [s * 1e3 for _i, s, *_r in out.calls]
    out.info["latency_ms"] = {"samples": len(lat),
                              "median": float(np.median(lat))}
    out.metrics = {"setup_s": setup_s,
                   "tokenize_MBps": rate(raw, w1 - w0) / 1e6,
                   "request_p95_ms": tail(lat, 95) if len(lat) > 1 else None}
    out.ctx = {"window_ns": (w0_ns, w1_ns), "spans": spans,
               "units": len(out.calls),
               "dispatches": [d for call in work for d in call],
               "tables": tk.tables}
    if traced:
        out.ctx["ops"] = trace.ops(w0_ns, w1_ns)
    out.texts = texts
    out.vocab_path = inputs.vocab_file(cfg)
    out.tokenizer = v
    return out


def sample(out: Run, seed: int, count: int) -> list:
    """The calls held against the reference: ``count`` drawn from the
    seed, the first call of the longest text among them."""
    done = list(range(len(out.calls)))
    longest = max(done, key=lambda c: len(out.texts[out.calls[c][0]]))
    rest = [c for c in done if c != longest]
    rng = random.Random(seed ^ 0x5EED)
    return sorted([longest] + rng.sample(rest, min(count - 1, len(rest))))


STAND_INS = ("greedy", "half", "altered")


def _broken(ids: np.ndarray, how: str) -> np.ndarray:
    """The reference's ids with a fault planted: ``half`` the ids left
    out, or one id ``altered``."""
    if how == "half":
        return ids[:len(ids) // 2]
    ids = ids.copy()
    ids[len(ids) // 2] ^= 1
    return ids


def check(out: Run, seed: int, count: int, reference,
          stand_in: str | None = None) -> dict:
    """The numbers compared, over the sampled calls: ids that differ from
    the reference's (each position, and each id one side has past the
    other's end), the gap of the missing counts, and calls off the device
    path (in the whole window).  ``stand_in`` reads what stands in the
    program's place instead: the control ("greedy", the greedy reference)
    or the reference with a fault planted ("half", "altered")."""
    from ..reference.core.vocab import Vocab
    from ..reference.scan import ids_of

    picked = sample(out, seed, count)
    raws = [out.texts[out.calls[c][0]] for c in picked]
    if getattr(out, "reference", None) is None:     # once a run
        v = Vocab.load(out.vocab_path)
        norm = reference.normalize(raws, v.normalizer.flag, v.using_capcode)
        out.reference = (norm, reference.events(out.vocab_path, norm))
    norm, want = out.reference
    if stand_in is None:
        got = [(out.calls[c][2], out.calls[c][3]) for c in picked]
    elif stand_in == "greedy":
        got = [(ids_of(e), int(e.miss.sum()))
               for e in reference.events(out.vocab_path, norm, greedy=True)]
    else:
        got = [(_broken(ids_of(e), stand_in), int(e.miss.sum()))
               for e in want]
    ids_off = missing_off = 0
    for (ids, miss), ev in zip(got, want):
        ref = ids_of(ev)
        if ids is None:
            ids_off += len(ref)
            continue
        ids = np.asarray(ids, np.int64)
        m = min(len(ids), len(ref))
        ids_off += int((ids[:m] != ref[:m]).sum()) + abs(len(ids) - len(ref))
        missing_off += abs((miss or 0) - int(ev.miss.sum()))
    off_device = sum(1 for *_r, ok in out.calls if not ok)
    out.info["checked"] = {
        "calls": len(picked), "raw_bytes": sum(map(len, raws)),
        "fnv1a64": [f"{fnv1a64(ids):016x}" if ids is not None else None
                    for ids, _m in got]}
    return {"ids_off": (ids_off, 0), "missing_off": (missing_off, 0),
            "calls_off_device": (0 if stand_in else off_device, 0)}
