"""The port's spans (``tokenmonster_tpu_torch.tracing``) on the CPU, through
``load(vocab, device="cpu", route="device")``: off records nothing and
reads no clock, ``enable()`` and a running profiler record each call's
tree on its own thread, on the profiler's clock; the buffer's bound
counts what it drops; a rerun is recorded, a host fallback is not; the
native capcode encoder's ``runs`` counts the bytes it copies; a
span opened outside a call records nothing; the trainer's spans record
under its ``round`` and ``candidate`` roots, and cost no clock off."""

import importlib.util
import os
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import tokenmonster_tpu_torch
from tokenmonster_tpu_torch import tracing
from tokenmonster_tpu_torch.core.vocab import Vocab
from torch_cases import pool_file  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, "examples", "realtext-1024-fast.vocab")
TEXT = ("The quick brown fox jumps over the lazy dog. Ünïcödé café, "
        "naïve ÉCOLE. ") * 40
CHILDREN = {"nfd": "tokenize", "capcode": "tokenize", "device": "tokenize",
            "unicodedata": "nfd", "runs": "capcode", "stage": "device",
            "launch": "device",
            "rerun": "device", "expand": "device"}


@pytest.fixture(autouse=True)
def empty():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def vocab():
    return tokenmonster_tpu_torch.load(VOCAB, device="cpu", route="device")


def _tree(recs):
    """{name: record} of one call, each parent checked against CHILDREN."""
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert len(roots) == 1 and roots[0].name == "tokenize"
    call = roots[0].id
    named = {}
    for r in recs:
        assert r.call == call and r.thread == roots[0].thread
        assert r.start <= r.end
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.name == CHILDREN[r.name]
            assert up.start <= r.start and r.end <= up.end
        if r.name != "rerun":
            assert r.name not in named, r.name
        named[r.name] = r
    return named


def test_off_records_nothing(vocab):
    vocab.tokenize(TEXT)
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    vocab.tokenize(TEXT)              # after a stopped profiler
    assert tracing.records() == [] and tracing.drops().count == 0


def test_off_reads_no_clock(vocab, monkeypatch):
    """Off, a span site reads no clock: one that raises is never called."""
    def no_clock():
        raise AssertionError("a span read the clock while off")
    monkeypatch.setattr(tracing, "time", SimpleNamespace(time_ns=no_clock))
    want = vocab.tokenize(TEXT)
    monkeypatch.undo()
    np.testing.assert_array_equal(want, vocab.tokenize(TEXT))


def test_enable_records_one_call_tree(vocab):
    raw = TEXT.encode()
    with tracing.enable():
        with tracing.enable():          # enable() nests
            pass
        ids = vocab.tokenize(TEXT)
    vocab.tokenize(TEXT)
    named = _tree(tracing.records())
    assert set(CHILDREN) - {"rerun"} <= set(named) <= set(CHILDREN) | {
        "tokenize"}
    normalized = vocab._core.normalize(raw)
    assert named["tokenize"].n == named["nfd"].n == len(raw)
    assert named["unicodedata"].n == len(raw)     # dense: the whole text
    assert named["device"].n == len(normalized)
    assert named["capcode"].n == len(vocab._core.normalizer.normalize(raw))
    assert named["stage"].n == named["launch"].n == 1
    assert named["expand"].n == len(ids)


def test_unicodedata_span_counts_the_runs_it_is_handed(vocab):
    """A long text with few runs of non-ASCII bytes hands unicodedata only
    the runs, joined by one byte each; an ASCII text opens no span."""
    runs = ["é", "ï", "Ωμέγα", "ﬁ½"]
    text = "".join(r + " plain ASCII between the runs. " * 20 for r in runs)
    assert len(text.encode()) >= 2048
    with tracing.enable():
        vocab.tokenize(text)
        vocab.tokenize("ASCII only. " * 200)
    recs = tracing.records()
    named = _tree([r for r in recs if r.call == recs[-1].call])
    assert "unicodedata" not in named
    named = _tree([r for r in recs if r.call != recs[-1].call])
    joined = "\n".join(runs).encode()
    assert named["unicodedata"].n == len(joined)


def test_runs_span_counts_the_bytes_copied_as_runs(vocab):
    """A long lowercase text is copied in runs, all but its first byte
    and a tail under 16 bytes; a text the Python encoder encodes (no
    native library) opens no ``runs`` span."""
    from tokenmonster_tpu_torch import native
    text = "plain lowercase words and spaces only, " * 200
    with tracing.enable():
        vocab.tokenize(text)
    named = _tree(tracing.records())
    n = named["capcode"].n
    assert n - 16 <= named["runs"].n < n
    tracing.clear()
    want = vocab.tokenize(TEXT)
    with mock.patch.object(native, "get_lib", lambda: None):
        with tracing.enable():
            got = vocab.tokenize(TEXT)
    np.testing.assert_array_equal(got, want)
    named = _tree(tracing.records())
    assert "capcode" in named and "runs" not in named


def test_list_items_keep_their_own_trees(vocab):
    texts = [TEXT, TEXT[:900], TEXT[:1700] + "x"]
    with tracing.enable():
        got = vocab.tokenize(texts)
    recs = tracing.records()
    calls = {r.call for r in recs}
    assert len(calls) == 3
    roots = {}
    for call in calls:
        named = _tree([r for r in recs if r.call == call])
        roots[named["tokenize"].n] = named
    for text, ids in zip(texts, got):
        assert roots[len(text.encode())]["expand"].n == len(ids)


def test_records_select_by_start(vocab):
    with tracing.enable():
        vocab.tokenize(TEXT)
    recs = tracing.records()
    dev = next(r for r in recs if r.name == "device")
    inside = tracing.records(dev.start, dev.end)
    assert {r.name for r in inside} >= {"device", "stage", "launch",
                                        "expand"}
    assert all(dev.start <= r.start < dev.end for r in inside)
    assert tracing.records(dev.end + 1, dev.end + 2) == []


def test_profiler_turns_recording_on_on_its_clock(vocab):
    """A CPU-activity profiler session records the program's spans, and
    the profiler's ``aten::`` events fall inside the spans of the code
    that ran them: many in ``launch`` (the chain op by op), none in the
    normalizer's passes, which run no torch op."""
    vocab.tokenize(TEXT)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vocab.tokenize(TEXT)
    vocab.tokenize(TEXT)
    named = _tree(tracing.records())
    aten = [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("aten::")]

    def within(name):
        r = named[name]
        return sum(1 for a, b in aten if r.start <= a and b <= r.end)
    assert within("launch") > 100
    assert within("nfd") == within("capcode") == within("expand") == 0
    assert within("tokenize") == len(aten)


def test_root_opened_off_records_nothing_under_it():
    with tracing.root("tokenize") as off:
        off.n = 5
        with tracing.enable():
            with tracing.span("device"):
                pass
            with tracing.root("tokenize"):
                pass
    assert tracing.records() == []
    with tracing.enable():
        with tracing.root("tokenize", 3) as s:
            s.n += 1
            with tracing.root("device", 2):
                pass
    inner, outer = tracing.records()
    assert outer.parent is None and outer.call == outer.id and outer.n == 4
    assert inner.parent == outer.id and inner.call == outer.id


def test_span_outside_a_call_records_nothing(vocab):
    """A caller that stages and reads through the tokenizer's own methods,
    outside any root: recording on, those spans are not kept."""
    raw = vocab._core.normalize(TEXT.encode())
    with tracing.enable():
        with tracing.span("stage"):
            pass
        staged = vocab._tpu.stage(raw)
        vocab._tpu.tokenize_staged(staged, raw)
    assert tracing.records() == []


def test_missing_profiler_switch_fails_at_import(monkeypatch):
    """A torch without ``_is_profiler_enabled`` fails the module's import,
    once and plainly, rather than every call's root span."""
    from torch.autograd import profiler
    monkeypatch.delattr(profiler, "_is_profiler_enabled")
    spec = importlib.util.spec_from_file_location("tracing_copy",
                                                  tracing.__file__)
    with pytest.raises(ImportError, match="_is_profiler_enabled"):
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


def test_buffer_bound_counts_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with tracing.enable():
        for k in range(5):
            with tracing.root("stage", k):
                pass
    recs = tracing.records()
    assert [r.n for r in recs] == [0, 1, 2]
    lost = tracing.drops()
    assert lost.count == 2 and recs[-1].start <= lost.first <= lost.last
    tracing.clear()
    assert tracing.records() == [] and tracing.drops() == (0, None, None)


def _vocab_file(tmp_path):
    """Tokens "aa", "a" and "x": a run of "a" after an "x" fails every
    junction (lanes out of phase); no unk token, so a "b" is a missing
    byte."""
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                normalize_string="none", using_capcode=0, level=5,
                reset_token_ids=True)
    path = str(tmp_path / "run.vocab")
    v.save(path)
    return tokenmonster_tpu_torch.load(path, device="cpu", route="device")


def test_rerun_recorded_and_fallback_unspanned(tmp_path):
    v = _vocab_file(tmp_path)
    with tracing.enable():
        v.tokenize(b"x" + b"a" * 3000)
    tk = v._tpu
    assert tk.repairs >= 1 and tk.host_fallbacks == 0
    named = _tree(tracing.records())
    assert named["rerun"].n == tk.repairs
    tracing.clear()
    with tracing.enable():
        v.tokenize(b"xab" * 200)
    assert tk.fallbacks == {"missing_byte": 1} and tk.last_mode == "host"
    names = {r.name for r in tracing.records()}
    assert names == {"tokenize", "nfd", "capcode", "device", "stage",
                     "launch"}


TRAINER = {"prune": "round", "select": "round", "build": "candidate",
           "mask": "candidate", "score": "candidate", "rescore": "candidate",
           "readback": "score", "stage": "score", "launch": "score"}


def _rounds(pool_file, out, rounds=2):
    """Seeded ``train_vocab`` rounds on the CPU; returns the rounds the
    ``on_round`` hook saw."""
    from tokenmonster_tpu_torch.train import trainvocab as tv
    corpus, tok = pool_file
    seen = []
    tv.train_vocab(corpus, tok, str(out),
                   tv.TrainConfig(vocab_size=120, workers=2, fast=True,
                                  seed=7, max_rounds=rounds),
                   device="cpu", on_round=seen.append)
    return seen


def test_trainer_spans_record_under_round_and_candidate_roots(pool_file,
                                                              tmp_path):
    """Each round is a ``round`` root on the master thread with its list
    work and votes under it; each candidate a ``candidate`` root on a
    worker thread with its build, masking, score (staging, replays, read
    back) and rescoring; no span records outside those roots, and each
    ``n`` counts its work."""
    with tracing.enable():
        seen = _rounds(pool_file, tmp_path)
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert sorted(r.name for r in roots) == sorted(
        ["round"] * 2 + ["candidate"] * 4)
    masters = {r.thread for r in roots if r.name == "round"}
    assert len(masters) == 1
    assert not masters & {r.thread for r in roots if r.name == "candidate"}
    for r in recs:
        root = by_id[r.call]
        assert root.parent is None and root.thread == r.thread
        if r.parent is not None:
            assert by_id[r.parent].name == TRAINER[r.name], r.name
            assert by_id[r.parent].start <= r.start <= r.end
    names = [r.name for r in recs]
    assert {"prune", "select", "build", "mask", "score", "readback",
            "stage", "launch", "rescore"} <= set(names) <= set(TRAINER) | {
                "round", "candidate"}
    assert names.count("prune") == 4 and names.count("select") == 4
    rounds = [r for r in roots if r.name == "round"]
    assert [r.n for r in rounds] == [2, 2]
    cands = [r for r in roots if r.name == "candidate"]
    scored = [c for r in seen for c in r.candidates]
    assert sorted(c.n for c in cands) == sorted(
        sum(map(len, c.datasets)) for c in scored)
    strips = sum(len(c.datasets) for c in scored)
    assert sum(r.n for r in recs if r.name == "score") == strips
    assert sum(r.n for r in recs if r.name == "rescore") == \
        seen[-1].counters["strips_rescored"]
    assert sum(r.n for r in recs if r.name == "select") == sum(
        len(r.deleted) for r in seen)
    assert all(r.n > 0 for r in recs if r.name in ("mask", "readback",
                                                   "build", "stage"))


def test_trainer_spans_off_record_nothing_and_read_no_clock(
        pool_file, tmp_path, monkeypatch):
    """Off, the trainer's span sites read no clock (one that raises is
    never called) and the rounds are those of a run with them on."""
    def no_clock():
        raise AssertionError("a span read the clock while off")
    monkeypatch.setattr(tracing, "time", SimpleNamespace(time_ns=no_clock))
    off = _rounds(pool_file, tmp_path / "off")
    monkeypatch.undo()
    assert tracing.records() == []
    with tracing.enable():
        on = _rounds(pool_file, tmp_path / "on")
    assert [(r.removed, sorted(r.deleted)) for r in off] == [
        (r.removed, sorted(r.deleted)) for r in on]
