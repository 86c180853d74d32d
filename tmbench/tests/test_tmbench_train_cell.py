"""The trainer cell whole on the CPU at a size a test holds (the kernels'
plain versions, the program's "cpu" device; a 40 kB corpus, its pool,
400-id candidates): a sound run is correct, its first rounds' scores and
deletions exactly the plain reference's; the control (the greedy loop's
scores in the program's place) and faults planted in the results read
above every limit; a fault planted in the program (one altered score,
one dropped deletion, a candidate built without one of its tokens or
with one flag wrong) makes a run not correct; a program without the
round hook fails before any set-up."""

import copy

import numpy as np
import pytest

from tmbench import control
from tmbench.harness import cells, inputs, train_cell
from tmbench.reference.pool import Reference
from tmbench.run import measure, result_line

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(inputs, "CACHE",
                        str(tmp_path_factory.getbasetemp() / "tmcache"))


@pytest.fixture
def reference():
    with Reference(0) as ref:
        yield ref


def train_cell_small(min_rounds):
    cell = copy.deepcopy(cells.find("train32k.rounds"))
    cell.config["corpus"]["min_bytes"] = 40_000
    cell.config["train"]["vocab_size"] = 400
    cell.traffic.update(min_rounds=min_rounds, pool_sample=64)
    return cell


def test_run_is_correct_and_the_control_and_faults_are_not(reference):
    got = control.readings(train_cell_small(2), SEED, 0.0, "cpu", reference)
    assert got["program"] == {k: (0, 0) for k in got["program"]}
    assert got["greedy"]["scores_off"][0] > 0
    assert got["greedy"]["tokens_off"][0] > 0
    assert got["altered"]["scores_off"][0] == 1
    assert got["dropped"]["deletions_off"][0] > 0


def _altered(score):
    def altered(self, cand, datasets):
        scores, tokens, missing = score(self, cand, datasets)
        scores = np.array(scores)
        scores[len(scores) // 2] += 1
        return scores, tokens, missing
    return altered


def _dropped(select):
    def dropped(*args):
        votes = select(*args)
        return votes[:-1]
    return dropped


def _built_wrong(build, fault):
    """The candidate build with a fault planted in every vocabulary after
    the first (the superset's): the list's last token left out, or one
    key's flag bit flipped."""
    calls = []

    def built(self, token_list):
        calls.append(len(token_list))
        if len(calls) == 1:
            return build(self, token_list)
        if fault == "token_dropped":
            return build(self, token_list[:-1])
        v = build(self, token_list)
        v.flag = v.flag.copy()
        v.flag[len(v.flag) // 2] ^= 1
        return v
    return built


FAULTS = {"score_altered": "scores_off", "deletion_dropped": "deletions_off",
          "token_dropped": "vocab_off", "flag_flipped": "vocab_off"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_the_program_is_not_correct(reference, monkeypatch, fault):
    from tokenmonster_tpu_torch.train import trainvocab as tv
    if fault == "score_altered":
        monkeypatch.setattr(tv.GpuCandidateScorer, "score",
                            _altered(tv.GpuCandidateScorer.score))
    elif fault == "deletion_dropped":
        monkeypatch.setattr(tv, "_select_deletions",
                            _dropped(tv._select_deletions))
    else:
        monkeypatch.setattr(tv.CandidateScorer, "build",
                            _built_wrong(tv.CandidateScorer.build, fault))
    fields, checks, info = measure(train_cell_small(1), SEED, 0.0, False,
                                   "cpu", reference, t_start=0.0)
    line = result_line(fields, checks)
    assert not line["correct"]
    assert line["checks"][FAULTS[fault]]["value"] > 0
    assert info["window"]["rounds"] == [2, 2]


def test_a_program_without_the_hook_fails_before_set_up(reference,
                                                        monkeypatch):
    from tokenmonster_tpu_torch.train import trainvocab as tv

    def train_vocab(dataset, dictionary_path, results_dir, config,
                    device="cuda"):
        raise AssertionError("the loop ran")

    def corpus(*args):
        raise AssertionError("set-up ran")
    monkeypatch.setattr(tv, "train_vocab", train_vocab)
    monkeypatch.setattr(inputs, "corpus", corpus)
    assert not train_cell.hooked()
    with pytest.raises(RuntimeError, match="on_round"):
        measure(train_cell_small(1), SEED, 0.0, False, "cpu", reference,
                t_start=0.0)
