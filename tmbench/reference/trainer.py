"""The trainer's deletion rule, frozen from
``tokenmonster_tpu_torch/train/trainvocab.py`` at commit 6d463e6b506c
(``_worker_divider``, ``_select_deletions``, copied whole): a candidate's
deletion votes from its scores, as the loop draws them
(trainvocab.go:1180-1320).  ``tmbench/tests/test_tmbench_frozen_train.py``
holds each piece to its source at that commit; the copy stays as it is
when the source changes."""

from __future__ import annotations


def _worker_divider(remaining, vocab_size, midway_target, fast):
    """trainvocab.go:1192-1249."""
    if fast:
        table = [(vocab_size + vocab_size // 4, 200),
                 (vocab_size + vocab_size // 2, 150),
                 (vocab_size * 2, 100),
                 (midway_target // 6, 100), (midway_target // 4, 100),
                 (midway_target // 2, 100), (midway_target, 50),
                 (midway_target * 3 // 2, 40), (midway_target * 2, 30),
                 (midway_target * 4, 20), (midway_target * 10, 10)]
        default = 10
    else:
        table = [(vocab_size + vocab_size // 4, 2000),
                 (vocab_size + vocab_size // 2, 1500),
                 (vocab_size * 2, 1000),
                 (midway_target // 6, 400), (midway_target // 4, 300),
                 (midway_target // 2, 200), (midway_target, 150),
                 (midway_target * 3 // 2, 100), (midway_target * 2, 80),
                 (midway_target * 4, 40), (midway_target * 10, 20)]
        default = 10
    if remaining == 0:
        return 10
    for bound, div in table:
        if remaining < bound:
            return div
    return default


def _select_deletions(cand: Vocab, scores, vocab_size, remaining_plus,
                      midway_target, fast, special_set, work_type):
    """Worker deletion-vote selection (trainvocab.go:1180-1320).

    scores: int64[max_id]; returns list of token bytes (worst first), or for
    work_type 1 the best tokens (best first)."""
    id_to_token = cand.reverse
    ids = [i for i, t in enumerate(id_to_token) if t is not None]
    order = sorted(ids, key=lambda i: (scores[i], i))
    if work_type == 1:
        result = []
        for i in reversed(order):
            t = id_to_token[i]
            if len(t) <= 1 or t in special_set:
                continue
            result.append(t)
        return result

    divider = _worker_divider(remaining_plus, vocab_size, midway_target, fast)
    length = max(2, min(vocab_size // divider, vocab_size - 1))
    result = []
    k = 0
    for i in order:
        if len(result) >= length:
            break
        k += 1
        t = id_to_token[i]
        if len(t) == 1 or t in special_set:
            continue
        result.append(t)
    # append all remaining zero-score tokens (trainvocab.go:1277-1295)
    for i in order[k:]:
        if scores[i] > 0:
            break
        t = id_to_token[i]
        if len(t) == 1 or t in special_set:
            continue
        result.append(t)
    return result
