"""Per-candidate runtime state of the trainer's device scorer.

Port of ``tokenmonster_tpu/train/score_helpers.py::candidate_runtime_state``
(which imports jax inside) in its REMAP mode: the superset's hash
placement and match tables are built once (``Superset``), and each
candidate vocabulary, a subset of the superset, becomes runtime tables:
the superset's match tables with dead tokens masked, and the candidate's
metadata planes and emitted ids at its own indices, with the alive-rank
of every superset index.  Both dictionaries sort with the same
comparator, so a candidate's dictionary index is the rank of its
superset position among the live ones; that is checked for every
candidate, and a candidate the superset does not fit gets None (the
trainer then scores it on tables of its own).  The masking runs in host
numpy through ``hashmatch.compose_fields(c, alive)``, as in the JAX
package.  A candidate's planes and ids are padded to a power of two of
rows (``tables.bucket_width``), as the JAX package pads them in its REMAP
mode, so candidates of one bucket share one captured score chain; the
JAX package's second mode, which places them at superset positions, is
not kept.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.tokenmeta import DOES_NOT_EXIST
from ..ops.hashmatch import HashMatchTables
from ..ops.scan import GpuTokenizer
from ..ops.tables import (W3_SHIFT, CandidateTables, bucket_width,
                          build_meta_planes, flat_tables, ids3, smem_scalars,
                          w3_shift)


@dataclass(frozen=True)
class Superset:
    """A prepared superset: its vocabulary, the dictionary index of each
    token, its hash placement, and the tokenizer that holds its match
    tables on the (first) scoring device and runs the dispatch chain."""
    vocab: object
    index: dict
    hashmatch: HashMatchTables
    tokenizer: GpuTokenizer


def candidate_runtime_state(sup: Superset, cand) -> CandidateTables | None:
    """The candidate's kernel tables, on the superset's device:
    alive-masked match tables, the candidate's meta planes, begin-byte
    table and ids3 at its own indices (planes and ids padded with zeros
    to ``bucket_width`` slots), ``rank``, the alive-rank of each
    superset index (``cumsum(alive) - 1``, 0 where it is dead), and its
    delete id (``.delete_token``); or None where the superset does not
    fit the candidate (``candidate_host_state``)."""
    state = candidate_host_state(sup, cand)
    if state is None:
        return None
    return CandidateTables(sup.tokenizer.tables, *state)


def candidate_host_state(sup: Superset, cand) -> tuple | None:
    """``candidate_runtime_state``'s host work, once a candidate: the
    arguments after the superset's tables of ``CandidateTables``, which
    uploads them to the device of the tables it is given (one call for
    each scoring slot).  None where the superset does not fit the
    candidate, as the JAX ``candidate_runtime_state`` returns None: another
    delete config, charset or unk id, a token the superset lacks, or a
    dictionary order the superset's does not give; here also a candidate
    whose token words need more than W3_SHIFT bits (2^20 entries or more,
    or a literal id past them), since a REMAP candidate's words are
    W3_SHIFT words.  The trainer scores such a candidate on tables of its
    own (``GpuCandidateScorer.score``)."""
    v_sup = sup.vocab
    if ((cand.delete_token != DOES_NOT_EXIST)
            != (v_sup.delete_token != DOES_NOT_EXIST)
            or cand.charset != v_sup.charset):
        return None
    if ((cand.unk_token != DOES_NOT_EXIST)
            != (v_sup.unk_token != DOES_NOT_EXIST)
            or (cand.unk_token != DOES_NOT_EXIST
                and (cand.unk_token & 0xFFFFFF)
                != (v_sup.unk_token & 0xFFFFFF))):
        return None
    if w3_shift(cand) != W3_SHIFT:
        return None
    n_c = len(cand.tokens)
    pos = np.fromiter((sup.index.get(bytes(t), -1) for t in cand.tokens),
                      np.int64, n_c)
    if (n_c and pos.min() < 0) or not np.all(np.diff(pos) > 0):
        return None
    alive = np.zeros(len(v_sup.tokens), bool)
    alive[pos] = True

    rank = (np.cumsum(alive) - 1).astype(np.int32)
    rank[~alive] = 0
    planes, bb = build_meta_planes(cand)
    width = bucket_width(n_c)
    planes_cap = np.zeros((2, width), np.int32)
    planes_cap[:, :n_c] = planes.reshape(2, -1)[:, :n_c]
    ids_cap = np.zeros((width, 3), np.uint32)
    ids_cap[:n_c] = ids3(cand)
    return (cand, flat_tables(sup.hashmatch, alive),
            smem_scalars(sup.hashmatch, alive), planes_cap, bb, ids_cap,
            rank)
