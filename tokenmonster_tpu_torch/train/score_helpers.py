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
candidate.  The masking runs in host numpy through
``hashmatch.compose_fields(c, alive)``, as in the JAX package.  The JAX
package pads a REMAP candidate's planes and ids to a power of two of rows
for its compiled shapes, and keeps a second mode that places them at
superset positions; here they keep their own size, in the one mode.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.tokenmeta import DOES_NOT_EXIST
from ..ops.hashmatch import HashMatchTables
from ..ops.scan import GpuTokenizer
from ..ops.tables import (CandidateTables, build_meta_planes, flat_tables,
                          ids3, smem_scalars)


@dataclass(frozen=True)
class Superset:
    """A prepared superset: its vocabulary, the dictionary index of each
    token, its hash placement, and the tokenizer that holds its match
    tables on the (first) scoring device and runs the dispatch chain."""
    vocab: object
    index: dict
    hashmatch: HashMatchTables
    tokenizer: GpuTokenizer


def candidate_runtime_state(sup: Superset, cand) -> CandidateTables:
    """The candidate's kernel tables, on the superset's device:
    alive-masked match tables, the candidate's meta planes, begin-byte
    table and ids3 at its own indices, ``rank``, the alive-rank of each
    superset index (``cumsum(alive) - 1``, 0 where it is dead), and its
    delete id (``.delete_token``).  Raises ValueError for a candidate that does not fit the superset:
    another delete config, charset or unk id, a token the superset lacks,
    or a dictionary order the superset's does not give."""
    return CandidateTables(sup.tokenizer.tables,
                           *candidate_host_state(sup, cand))


def candidate_host_state(sup: Superset, cand) -> tuple:
    """``candidate_runtime_state``'s host work, once a candidate: the
    arguments after the superset's tables of ``CandidateTables``, which
    uploads them to the device of the tables it is given (one call for
    each scoring slot)."""
    v_sup = sup.vocab
    if ((cand.delete_token != DOES_NOT_EXIST)
            != (v_sup.delete_token != DOES_NOT_EXIST)
            or cand.charset != v_sup.charset):
        raise ValueError("candidate's delete token or charset differs from "
                         "the prepared superset's")
    if ((cand.unk_token != DOES_NOT_EXIST)
            != (v_sup.unk_token != DOES_NOT_EXIST)
            or (cand.unk_token != DOES_NOT_EXIST
                and (cand.unk_token & 0xFFFFFF)
                != (v_sup.unk_token & 0xFFFFFF))):
        raise ValueError("candidate's unk id differs from the prepared "
                         "superset's")
    n_c = len(cand.tokens)
    pos = np.fromiter((sup.index.get(bytes(t), -1) for t in cand.tokens),
                      np.int64, n_c)
    if n_c and pos.min() < 0:
        tok = bytes(cand.tokens[int(np.argmin(pos))])
        raise ValueError(f"candidate token {tok!r} is not in the prepared "
                         "superset")
    if not np.all(np.diff(pos) > 0):
        raise ValueError("candidate dictionary order differs from the "
                         "superset's")
    alive = np.zeros(len(v_sup.tokens), bool)
    alive[pos] = True

    rank = (np.cumsum(alive) - 1).astype(np.int32)
    rank[~alive] = 0
    planes, bb = build_meta_planes(cand)
    return (cand, flat_tables(sup.hashmatch, alive),
            smem_scalars(sup.hashmatch, alive), planes.reshape(2, -1), bb,
            ids3(cand), rank)
