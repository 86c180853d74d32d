"""User API: ``tokenmonster_tpu.api`` with the device route on PyTorch.

``Vocab`` is the JAX package's user-facing vocabulary (its host layers
import no jax); its device hook builds a ``GpuTokenizer`` on the
vocabulary's ``device``.  ``route`` picks the path of each input.  "auto"
(the default) keeps the JAX package's routing: inputs of at least
``TPU_THRESHOLD`` normalized bytes are device candidates, the first call of
each dispatch geometry is a warm-up, and among candidates the path with the
better measured rate wins, re-probed every 64 calls.  "device" sends every
input to the device path.  ``last_route`` and ``route_counts`` record the
path each call took.
"""

from __future__ import annotations

import time

import numpy as np

from tokenmonster_tpu import api as _api

from .native import native_vocab
from .ops.scan import GpuTokenizer, check_device

ROUTES = ("auto", "device")


class Vocab(_api.Vocab):
    """A vocabulary whose device route runs on ``device``: the CUDA
    kernels on ``"cuda"``, their plain PyTorch versions on ``"cpu"``."""

    def __init__(self, path, device="cuda", route="auto"):
        self.device = check_device(device)
        self.route = route
        self.last_route = None
        self.route_counts = {"device": 0, "native": 0}
        super().__init__(path)

    @property
    def route(self) -> str:
        return self._route

    @route.setter
    def route(self, value: str) -> None:
        if value not in ROUTES:
            raise ValueError(f"route {value!r} is not one of {ROUTES}")
        self._route = value

    def _tpu_tokenizer(self):
        """Lazily-built device tokenizer (rebuilt after any modification)."""
        if self._tpu is None:
            self._tpu = GpuTokenizer(self._core, device=self.device)
        return self._tpu

    def _tokenize_one(self, item) -> np.ndarray:
        """``tokenmonster_tpu.api.Vocab._tokenize_one`` with the route
        pinned by ``route`` and recorded."""
        if isinstance(item, str):
            item = item.encode("utf-8")
        normalized = self._core.normalize(item)
        auto = self.route == "auto"
        candidate = auto and len(normalized) >= self.TPU_THRESHOLD
        if self.route == "device" or (candidate
                                      and self._pick_route() == "tpu"):
            route, ids = "device", self._device_ids(normalized, timed=auto)
        else:
            route, ids = "native", self._native_ids(normalized,
                                                    timed=candidate)
        with self._route_lock:
            self.last_route = route
            self.route_counts[route] += 1
        return ids.astype(self._ids_dtype())

    def _device_ids(self, normalized: bytes, timed: bool) -> np.ndarray:
        """Ids from the device path; ``timed`` records its measured rate,
        except on the first call of a dispatch geometry (the warm-up)."""
        tk = self._tpu_tokenizer()
        with _api._TPU_LOCK:
            if timed:
                lanes, plan = tk._plan(len(normalized))
                geom = (lanes, len(plan))
                if geom not in self._tpu_warm_geoms:
                    self._tpu_warm_geoms.add(geom)
                    timed = False
            t0 = time.monotonic()
            ids, _missing = tk.tokenize(normalized)
        if timed:
            with self._route_lock:
                self._route_rates["tpu"] = (
                    len(normalized) / max(time.monotonic() - t0, 1e-9))
        return ids

    def _native_vocab(self):
        """The native tokenizer of this vocabulary, reached through the
        race-safe loader; raises when the library cannot be built."""
        if not self._native:
            self._native = native_vocab(self._core)
        return self._native

    def _native_ids(self, normalized: bytes, timed: bool) -> np.ndarray:
        """Ids from the native host tokenizer; ``timed`` records its rate."""
        nv = self._native_vocab()
        t0 = time.monotonic()
        ids, _missing = nv.tokenize(normalized)
        if timed:
            with self._route_lock:
                self._route_rates["native"] = (
                    len(normalized) / max(time.monotonic() - t0, 1e-9))
        return ids


def load(path, device="cuda", route="auto") -> Vocab:
    """Load a vocabulary (.vocab or .yaml) for tokenization on ``device``;
    ``route`` is "auto" or "device" (see ``Vocab``)."""
    return Vocab(path, device=device, route=route)
