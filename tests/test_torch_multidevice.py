"""The trainer's scorer over several devices and several processes, on the
CPU (the plain kernel versions), tolerance 0: ``GpuCandidateScorer`` over
two and more "cpu" slots against one device, the native scorer
(``tm_tokenize_score``) and the JAX package's Pallas scorer (interpret
mode); the strip layout; two gloo processes (``parallel/multihost.py``)
against one process; ``train_vocab`` over two slots, and over two
processes, against ``backend="native"``: the same round log and files.
Each subprocess has its own timeout, so a hung rendezvous fails its test.
"""

import logging
import os
import sys

import numpy as np
import pytest

from tokenmonster_tpu.train import trainvocab as ref
from tokenmonster_tpu_torch.parallel import multihost
from tokenmonster_tpu_torch.parallel.score import plan_pieces
from tokenmonster_tpu_torch.train import trainvocab as port

import torch_multidevice_cases as cases
from torch_cases import (VOCABS, candidate, drop_sets, native_score, text_for,
                         with_unk)
from torch_cases import jax_native  # noqa: F401 (autouse fixture)

RANK_TIMEOUT_S = 300


@pytest.mark.parametrize("n_disp,n_slots,want", [
    ([5] * 20, 2, [list(range(16)), list(range(16, 20))]),
    ([5] * 40, 2, [list(range(16)) + list(range(32, 40)),
                   list(range(16, 32))]),
    ([3, 1], 2, [[0], [1]]),
])
def test_whole_strips_in_the_jax_layout(n_disp, n_slots, want):
    """At least as many strips as slots: whole strips, strip i of each
    group of ``n_slots * batch`` on slot ``i // batch`` (batch 16 where
    strips outnumber slots, else 1), as the JAX trainer lays them out."""
    got = plan_pieces(n_disp, n_slots)
    assert [[i for i, _f, _s in p] for p in got] == want
    assert all((f, s) == (0, n_disp[i]) for p in got for i, f, s in p)


@pytest.mark.parametrize("n_disp,n_slots,want", [
    ([10], 2, [[(0, 0, 5)], [(0, 5, 10)]]),
    ([3], 4, [[], [(0, 0, 1)], [(0, 1, 2)], [(0, 2, 3)]]),
    ([2, 7], 3, [[(1, 0, 2)], [(0, 0, 1), (1, 2, 4)],
                 [(0, 1, 2), (1, 4, 7)]]),
])
def test_fewer_strips_than_slots_split_by_dispatch(n_disp, n_slots, want):
    assert plan_pieces(n_disp, n_slots) == want


@pytest.mark.parametrize("name", ["capcode", "plain", "unk", "utf16"])
def test_two_slots_equal_one_device_native_and_jax(name):
    """Candidates over two strips (one a slot) and over one strip of four
    dispatches (lanes of 256 bytes, dispatches of 8 lanes; split over the
    slots): two "cpu" slots give one device's scores, token counts and
    missing sets, native's and the JAX Pallas scorer's."""
    v = VOCABS[name]()
    unk = name == "unk"
    tokens = list(v.tokens)
    jcls = with_unk(ref.CandidateScorer) if unk else ref.CandidateScorer
    jsc = jcls(v.charset, v.using_capcode, v.normalizer.flag, backend="tpu")
    jsc.set_specials([])
    assert jsc.prepare_pallas(tokens)
    cls = with_unk(port.GpuCandidateScorer) if unk else port.GpuCandidateScorer
    slots = {}
    for devs in (["cpu"], ["cpu", "cpu"]):
        sc = cls(v.charset, v.using_capcode, v.normalizer.flag, device=devs)
        sc.set_specials([])
        with cases.split_geometry():
            sc.prepare(tokens, hashmatch_tables=jsc._pal["tabs"])
        slots[len(devs)] = sc
    assert slots[1]._slots is None and len(slots[2]._slots) == 2
    two = [text_for(name, v, size, seed=size) for size in (900, 1300)]
    long = [text_for(name, v, 6000, seed=21)]
    with cases.split_geometry():
        assert len(slots[2]._sup.tokenizer._plan(len(long[0]))[1]) == 4
    saw_missing = False
    for drops, strips in zip(drop_sets(v, 5), (two, long)):
        cand = candidate(slots[1], tokens, drops, unk)
        with cases.split_geometry():
            got = slots[2].score(cand, strips)
            one = slots[1].score(cand, strips)
        want = native_score(cand, strips)
        js, jt, jm = jsc.score(cand, strips)
        for other in (one[0], want[0], np.asarray(js)):
            np.testing.assert_array_equal(got[0], other)
        assert got[1:] == one[1:] == want[1:] == (jt, jm)
        saw_missing |= bool(got[2])
    assert saw_missing or name == "utf16"
    assert slots[2].repairs == slots[1].repairs == 0


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu"] * 3, ["cpu"] * 7])
@pytest.mark.parametrize("case", ["split", "repair"])
def test_split_strips_equal_one_device(case, devices):
    """One strip of six dispatches over 2, 3 and 7 slots (7: one slot
    idle); "repair": no share of the run holds, so the strip is scored
    again whole, with repairs, on the slot of its first share."""
    one_sc, cand, strips = cases.scoring_cases("cpu")[case]
    sc = cases.scorer(cases.run_vocab() if case == "repair"
                      else VOCABS["capcode"](), devices)
    assert len(sc._slots) == len(devices)
    with cases.split_geometry():
        assert len(sc._sup.tokenizer._plan(len(strips[0]))[1]) == 6
        got, one = sc.score(cand, strips), one_sc.score(cand, strips)
    want = native_score(cand, strips)
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == one[1:] == want[1:]
    assert sc.repairs == one_sc.repairs
    assert (sc.repairs > 0) == (case == "repair")


def test_slots_arm_from_one_placement(monkeypatch):
    """Every slot holds its own tables, derived from the one CHD placement
    built for the superset."""
    built = []
    real = port.build_hashmatch

    def counting(*args, **kw):
        built.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(port, "build_hashmatch", counting)
    sc = cases.scorer(VOCABS["capcode"](), ["cpu"] * 3)
    tks = [slot.tokenizer for slot in sc._slots]
    assert len(built) == 1 and len(tks) == 3 and tks[0] is sc._sup.tokenizer
    assert len({id(tk.tables) for tk in tks}) == 3
    assert all(tk.tables.fields.data_ptr() != tks[0].tables.fields.data_ptr()
               for tk in tks[1:])


def _rounds(caplog, run):
    caplog.clear()
    with caplog.at_level(logging.INFO,
                         logger="tokenmonster_tpu_torch.trainvocab"):
        best = run()
    return best, [r.getMessage() for r in caplog.records
                  if r.getMessage().startswith("round ")]


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


@pytest.fixture(scope="module")
def native_run(tmp_path_factory):
    """The seeded run with ``backend="native"``, to its end and for 6
    rounds: (workdir, {max_rounds: (best, rounds, files)})."""
    work = tmp_path_factory.mktemp("multidevice")
    cases.pool(str(work))
    logger = logging.getLogger("tokenmonster_tpu_torch.trainvocab")
    old = logger.level
    logger.setLevel(logging.INFO)
    runs = {}
    for max_rounds in (None, 6):
        rounds = []

        class Rounds(logging.Handler):
            def emit(self, record):
                if record.getMessage().startswith("round "):
                    rounds.append(record.getMessage())

        handler = Rounds()
        logger.addHandler(handler)
        out = work / f"native_{max_rounds}"
        try:
            best = cases.train(str(out), None, backend="native",
                               max_rounds=max_rounds)
        finally:
            logger.removeHandler(handler)
        assert rounds and "deleted 0;" not in rounds[0]
        runs[max_rounds] = (best, rounds, _files(out))
    logger.setLevel(old)
    assert runs[None][0] is not None and len(runs[None][1]) > 6
    return work, runs


@pytest.mark.parametrize("split", [False, True])
def test_train_vocab_over_two_slots_equals_native(native_run, caplog, split):
    """``train_vocab(device=["cpu", "cpu"])`` deletes what native deletes
    every round and writes the same files, to the run's end; with lanes
    of 256 bytes and dispatches of 8 lanes (for 6 rounds) each candidate's
    one strip splits over both slots."""
    work, runs = native_run
    out = work / f"two_slots_{split}"
    if split:
        with cases.split_geometry():
            best, rounds = _rounds(caplog, lambda: cases.train(
                str(out), ["cpu", "cpu"], max_rounds=6))
    else:
        best, rounds = _rounds(caplog, lambda: cases.train(
            str(out), ["cpu", "cpu"]))
    best_n, rounds_n, files_n = runs[6 if split else None]
    assert rounds == rounds_n
    assert _files(out) == files_n
    assert (best and os.path.basename(best)) == (
        best_n and os.path.basename(best_n))


@pytest.fixture(scope="module")
def two_ranks(native_run):
    """Two gloo processes (tests/torch_multihost_worker.py) over one
    rendezvous: their scores and round logs, and the results directory.
    Each has its own timeout."""
    work = native_run[0]
    return work, cases.launch_ranks(work, "cpu", RANK_TIMEOUT_S)


@pytest.mark.parametrize("case", ["whole", "split", "repair"])
def test_two_processes_score_as_one(two_ranks, case):
    """Each candidate split over the two ranks and all-reduced: both ranks
    hold one process's scores, token count and missing set, and native's."""
    _work, ranks = two_ranks
    sc, cand, strips = cases.scoring_cases("cpu")[case]
    with cases.split_geometry():
        s, n_tok, miss = sc.score(cand, strips)
    want = native_score(cand, strips)
    np.testing.assert_array_equal(s, want[0])
    for got, _log in ranks:
        np.testing.assert_array_equal(got[case], s)
        meta = got[case + "_meta"]
        assert meta[0] == n_tok and list(meta[2:]) == sorted(miss)
    # each rank repairs what it holds: the strip's first share is rank 0's
    assert ranks[0][0][case + "_meta"][1] == sc.repairs
    assert ranks[1][0][case + "_meta"][1] == 0


def test_two_processes_train_as_native(two_ranks, native_run):
    """``train_vocab`` in both ranks, to its end: the same round log as
    native on each, rank 0's files equal native's, rank 1 returns rank
    0's path."""
    work, ranks = two_ranks
    best_n, rounds_n, files_n = native_run[1][None]
    for _got, log in ranks:
        assert log["rounds"] == rounds_n
        assert os.path.basename(log["best"]) == os.path.basename(best_n)
    assert ranks[1][1]["best"] == ranks[0][1]["best"]
    assert _files(work / "results") == files_n


def test_shard_text_equals_jax_layout():
    """``shard_text_for_process`` lays a corpus over the slots of every
    rank as the JAX package lays it over its (hosts, data) mesh."""
    import jax
    from jax.sharding import Mesh

    from tokenmonster_tpu.parallel import multihost as jmultihost
    text = np.frombuffer(text_for("capcode", VOCABS["capcode"](), 9000,
                                  seed=4), np.uint8)
    devices = np.asarray(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, (jmultihost.HOST_AXIS, jmultihost.DATA_AXIS))
    want = np.asarray(jmultihost.shard_text_for_process(text, mesh, 512))
    got = np.concatenate(
        [s for rank in range(2) for s in multihost.shard_text_for_process(
            text, 512, n_local=4, rank=rank, world=2)])
    np.testing.assert_array_equal(got, want)
    assert multihost.shard_text_for_process(text, 512)[0][:len(text)] \
        .tobytes() == text.tobytes()


def test_local_devices():
    assert multihost.local_devices("cpu") == [multihost.torch.device("cpu")]
    assert [d.type for d in multihost.local_devices("cpu,cpu")] == ["cpu"] * 2
    with pytest.raises(ValueError):
        multihost.local_devices([])
    assert multihost.process_info() == (0, 1)
    vec = np.arange(5)
    np.testing.assert_array_equal(multihost.all_reduce_sum(vec), vec)
    assert multihost.reduce_step(np.ones(3, np.int64), 4,
                                 np.zeros(256, np.int64), False)[1:2] == (4,)


def test_launch_counts_from_many_threads(monkeypatch):
    """Scoring slots launch from threads of their own: with the kernel
    launch itself stubbed, 16 threads (more than this host's cores)
    counting 2,000 launches each under a short switch interval lose none."""
    import threading

    from tokenmonster_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_launch", lambda *a: None)
    _build.reset_launches()
    args = _build.CompactArgs()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.launch("compact", args, None) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _build.launches["compact"] == 16 * 2000
    _build.reset_launches()
