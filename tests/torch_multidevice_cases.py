"""Inputs of the port's multi-device scoring tests, shared by the tests in
one process (tests/test_torch_multidevice.py, the gpu-marked ones in
tests/test_torch_gpu.py) and the ranks of the two-process test
(tests/torch_multihost_worker.py): candidates and strips that take each
path of ``parallel/score.py::score_slots``, and a seeded ``train_vocab``.
Imports no jax."""

import contextlib
import json
import os
import socket
import subprocess
import sys

import numpy as np

from tokenmonster_tpu_torch.core.vocab import Vocab
from tokenmonster_tpu_torch.ops import scan
from tokenmonster_tpu_torch.train import trainvocab as port
from tokenmonster_tpu_torch.train.getalltokens import (get_all_tokens,
                                                       save_tokens_file)

from torch_cases import VOCABS, candidate, drop_sets, text_for

SEED_TEXT = (b"The quick brown fox jumps over the lazy dog. The dog sleeps "
             b"while the fox runs through the forest; every morning the sun "
             b"rises over the mountains and the birds sing their songs. ")
CORPUS = SEED_TEXT * 40
TRAIN = dict(vocab_size=120, workers=2, fast=True, seed=7, keep_trying=5)


@contextlib.contextmanager
def split_geometry():
    """Lanes of 256 bytes and dispatches of 8 lanes, so that texts of a
    few kB chain several dispatches and a strip splits over slots (the
    lanes stay longer than the 128 bytes a lane scans past its chunk, as
    the trainer's 2048-byte lanes are)."""
    chunk, lanes = port.CHUNK, scan.MAX_LANES
    port.CHUNK, scan.MAX_LANES = 256, 8
    try:
        yield
    finally:
        port.CHUNK, scan.MAX_LANES = chunk, lanes


def run_vocab():
    """Tokens "aa", "a", "x": in a run of "a" after an "x" no junction
    shares a state, so every share of the run fails and is repaired."""
    v = Vocab()
    v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                normalize_string="none", using_capcode=0, level=5,
                reset_token_ids=True)
    return v


def scorer(v, device):
    """A ``GpuCandidateScorer`` armed on ``v`` under ``split_geometry``
    (score under it too)."""
    sc = port.GpuCandidateScorer(v.charset, v.using_capcode,
                                 v.normalizer.flag, device=device)
    sc.set_specials([])
    with split_geometry():
        sc.prepare(list(v.tokens))
    return sc


def scoring_cases(device) -> dict:
    """name -> (scorer on ``device``, candidate, strips), to be scored
    under ``split_geometry``: "whole": 20 strips, one empty (whole strips
    in the JAX layout, 16 on the first of two slots); "split": one strip
    of six dispatches, split over the slots; "repair": a split strip
    whose shares do not hold, scored again whole."""
    out = {}
    v = VOCABS["capcode"]()
    sc = scorer(v, device)
    cand = candidate(sc, list(v.tokens), drop_sets(v, 3)[1], False)
    strips = [text_for("capcode", v, 700 + 37 * k, seed=k) for k in range(19)]
    out["whole"] = (sc, cand, strips + [b""])
    sc = scorer(v, device)
    out["split"] = (sc, candidate(sc, list(v.tokens), drop_sets(v, 3)[2],
                                  False),
                    [text_for("capcode", v, 9000, seed=9)])
    v = run_vocab()
    sc = scorer(v, device)
    out["repair"] = (sc, sc.build(list(v.tokens)),
                     [b"x" + b"a" * 9000 + b"xaaxa" * 20])
    return out


def pool(dirpath) -> str:
    """The seeded getalltokens pool of ``CORPUS`` written to ``dirpath``."""
    counter, char_table, header = get_all_tokens(
        CORPUS, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=10, min_occur_singles=1, chunk_size=1 << 20,
        micro_chunks=1, add_extra_tokens=False)
    path = os.path.join(dirpath, "pool.tok")
    save_tokens_file(path, counter, char_table, header)
    return path


def train(results, device, backend="cuda", max_rounds=None):
    """The seeded ``train_vocab`` of ``CORPUS`` on the pool next to
    ``results``, to its end or for ``max_rounds``; returns its best
    path."""
    tok = os.path.join(os.path.dirname(results), "pool.tok")
    cfg = port.TrainConfig(backend=backend, max_rounds=max_rounds, **TRAIN)
    return port.train_vocab(CORPUS, tok, results, cfg, device=device)


HERE = os.path.dirname(os.path.abspath(__file__))


def launch_ranks(work, device: str, timeout_s: float, world: int = 2):
    """Run ``world`` ranks of tests/torch_multihost_worker.py over one gloo
    rendezvous on localhost, each scoring on ``device``, in ``work`` (which
    holds ``pool``'s file).  Each has its own timeout.  Returns per rank
    (its scores by case, its round log and best path)."""
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port_no = str(sock.getsockname()[1])
    sock.close()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         str(rank), str(world), port_no, str(work), device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{so[-2000:]}\n{se[-3000:]}"
    ranks = []
    for rank in range(world):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            log = json.load(f)
        scores = np.load(os.path.join(work, f"rank{rank}.npz"))
        ranks.append(({k: scores[k] for k in scores.files}, log))
    return ranks
