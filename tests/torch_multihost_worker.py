"""One rank of the port's two-process scoring tests
(tests/test_torch_multidevice.py, tests/test_torch_own_tables.py): joins a
gloo process group over tcp://localhost:<port>, scores the test's
candidates over its own slot on ``<device>`` ("cpu", or "cuda:0" for both
ranks on one card) with ``GpuCandidateScorer`` (each candidate split over
both ranks and all-reduced), then, with ``<mode>`` "train", runs a seeded
``train_vocab`` to its end into ``<workdir>/results`` (only rank 0 may
write there; its final phase reads back the files the loop wrote).
``<mode>`` "own" scores the candidates of
``torch_multidevice_cases.own_table_cases`` instead and trains nothing.
Writes its scores and round log to ``<workdir>/rank<r>.npz`` and
``rank<r>.json``.

Usage: python torch_multihost_worker.py <rank> <world> <port> <workdir>
       <device> <mode>
"""

import json
import logging
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import torch_multidevice_cases as cases  # noqa: E402
from tokenmonster_tpu_torch.parallel import multihost  # noqa: E402


def main():
    rank, world, port, workdir, device, mode = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6])
    got = multihost.init_distributed(f"tcp://localhost:{port}", world, rank,
                                     backend="gloo", timeout_s=120)
    assert got == (rank, world) == multihost.process_info()
    out = {}
    score_cases = (cases.own_table_cases if mode == "own"
                   else cases.scoring_cases)
    for name, (sc, cand, strips) in score_cases(device).items():
        assert sc.world == world and sc._slots is not None
        with cases.split_geometry():
            s, n_tok, miss = sc.score(cand, strips)
        out[name] = s
        out[name + "_meta"] = np.array([n_tok, sc.repairs]
                                       + sorted(miss), np.int64)
        out[name + "_own"] = np.array(sc.own_table_scores)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    if mode == "own":
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump({"rounds": [], "best": None}, f)
        print(f"rank {rank} done", flush=True)
        return

    rounds = []

    class Rounds(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("round "):
                rounds.append(record.getMessage())

    logger = logging.getLogger("tokenmonster_tpu_torch.trainvocab")
    logger.addHandler(Rounds())
    logger.setLevel(logging.INFO)
    best = cases.train(os.path.join(workdir, "results"), device)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rounds": rounds, "best": best}, f)
    print(f"rank {rank} done", flush=True)


main()
