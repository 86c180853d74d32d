"""Multi-process distribution for the trainer's scoring step.

Port of ``tokenmonster_tpu/parallel/multihost.py`` on ``torch.distributed``
(the JAX package connects processes with ``jax.distributed`` and psums
over a (hosts, data) mesh).  Each process scores its share of every
candidate on its own scoring slots (``local_devices``), and the step's
sums are all-reduced: per-id scores, the token count and the missing-byte
mask (``reduce_step``), with the flag that every rank's strips held, as
``make_pallas_score_step`` returns it.  Integer sums are associative, so
N processes score bit-exactly as one does on the same strips.

The process group uses NCCL where each rank has a card of its own and
gloo otherwise (on the CPU, or several ranks on one card, which NCCL does
not allow).  The sums are small and are reduced as host copies under
gloo, as device tensors under NCCL.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops.scan import check_device


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) without an initialized process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def default_backend(world_size: int) -> str:
    """NCCL where this host's ranks each have a card of their own, else
    gloo."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if (dist.is_nccl_available() and torch.cuda.is_available()
            and torch.cuda.device_count() >= local):
        return "nccl"
    return "gloo"


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = 600) -> tuple[int, int]:
    """Join the process group (idempotent: an initialized group is kept).

    Arguments left None come from the standard environment: ``RANK``,
    ``WORLD_SIZE`` and, for ``init_method`` "env://", ``MASTER_ADDR`` and
    ``MASTER_PORT`` (what ``torchrun`` sets); an explicit launch passes
    e.g. ``init_method="tcp://localhost:29500"``.  ``backend``: see
    ``default_backend``; under NCCL the rank's card becomes its current
    device.  Returns (rank, world size)."""
    if dist.is_initialized():
        return process_info()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    backend = backend or default_backend(world_size)
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world_size


def local_devices(device) -> list[torch.device]:
    """This process's scoring slots: a list of devices as given (one slot
    each, so ``["cuda:0", "cuda:0"]`` is two slots on one card), a
    comma-separated string of them, "cpu", or "cuda:k" (one card).  "cuda"
    with no index is every visible card, or in a run of several processes
    the rank's own card (``LOCAL_RANK``, else the rank, modulo the cards
    seen)."""
    if isinstance(device, str) and "," in device:
        device = [d.strip() for d in device.split(",")]
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("no scoring device given")
        return [check_device(d) for d in device]
    d = check_device(device)
    if d.type != "cuda" or d.index is not None:
        return [d]
    rank, world = process_info()
    count = torch.cuda.device_count()
    if world > 1:
        return [torch.device("cuda", _local_rank(rank) % count)]
    return [torch.device("cuda", i) for i in range(count)]


def shard_text_for_process(text: np.ndarray, chunk: int, n_local: int = 1,
                           rank: int | None = None,
                           world: int | None = None) -> list[np.ndarray]:
    """This process's slices of a corpus laid out over every slot of the
    run, as ``tokenmonster_tpu/parallel/multihost.py`` lays it out over
    its mesh: the text padded with zeros to ``n_dev`` strips of ``per``
    bytes (the even share rounded up to a multiple of ``chunk``), slot d
    (rank-major, ``n_local`` slots a rank) owning bytes [d*per,
    (d+1)*per).  Returns the strips of this rank's slots, in order."""
    if rank is None or world is None:
        rank, world = process_info()
    n_dev = n_local * world
    per = -(-len(text) // n_dev)
    per = -(-per // chunk) * chunk
    buf = np.zeros(per * n_dev, np.uint8)
    buf[:len(text)] = text
    return [buf[d * per:(d + 1) * per]
            for d in range(rank * n_local, (rank + 1) * n_local)]


def all_reduce_sum(vec: np.ndarray) -> np.ndarray:
    """The int64 sum of ``vec`` over every rank (``vec`` itself in a run of
    one process)."""
    vec = np.ascontiguousarray(vec, np.int64)
    if process_info()[1] == 1:
        return vec
    t = torch.from_numpy(vec.copy())
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


def reduce_step(scores: np.ndarray, n_tokens: int, miss_mask: np.ndarray,
                ok: bool = True):
    """The scoring step's reduction over every rank: (scores, n_tokens,
    miss_mask, ok_all), the first three summed in one all-reduce that also
    carries the flag that every rank's share held
    (``tokenmonster_tpu/parallel/score.py``, ``ok_all``)."""
    n = len(scores)
    vec = all_reduce_sum(np.concatenate(
        [scores, [n_tokens], miss_mask, [0 if ok else 1]]).astype(np.int64))
    return (vec[:n], int(vec[n]), vec[n + 1:n + 1 + len(miss_mask)],
            bool(vec[-1] == 0))
