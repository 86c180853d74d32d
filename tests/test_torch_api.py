"""The port's user API: tokenmonster_tpu_torch.load(path, device="cpu")
tokenizes (through the device route, plain kernel versions) and decodes
as tokenmonster_tpu.load does; the package imports no jax; "cuda" without
a card raises."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tokenmonster_tpu
import tokenmonster_tpu_torch

from torch_cases import ENGLISH, EXAMPLES, ROOT
from torch_cases import jax_native  # noqa: F401 (autouse fixture)

VOCAB = os.path.join(EXAMPLES, "realtext-1024-fast.vocab")


def test_load_tokenizes_and_decodes_like_reference():
    ref = tokenmonster_tpu.load(VOCAB)
    v = tokenmonster_tpu_torch.load(VOCAB, device="cpu")
    v.TPU_THRESHOLD = 1           # route every input to the device path
    rng = np.random.default_rng(6)
    words = ENGLISH.decode().split(" ")
    texts = [" ".join(words[i] for i in rng.integers(0, len(words), k))
             for k in (400, 30, 900)]
    for t in texts:
        got = v.tokenize(t)
        want = ref.tokenize(t)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert v.decode(got) == ref.decode(want)
    tk = v._tpu
    assert isinstance(tk, tokenmonster_tpu_torch.GpuTokenizer)
    assert tk.device.type == "cpu" and tk.last_mode in ("fast", "full")
    assert tk.host_fallbacks == 0
    assert v.last_route == "device" and v.route_counts["device"] >= 1
    batch = v.tokenize(texts)
    for got, t in zip(batch, texts):
        np.testing.assert_array_equal(got, ref.tokenize(t))


def test_route_pinned_and_recorded():
    """"device" sends every input to the device path, "auto" keeps small
    inputs on the host; each call records its route."""
    ref = tokenmonster_tpu.load(VOCAB)
    text = "The quick brown fox jumps over the lazy dog."
    v = tokenmonster_tpu_torch.load(VOCAB, device="cpu", route="device")
    np.testing.assert_array_equal(v.tokenize(text), ref.tokenize(text))
    assert v.last_route == "device"
    assert v.route_counts == {"device": 1, "native": 0}
    v.tokenize([text, text + " Again."])
    assert v.route_counts == {"device": 3, "native": 0}
    assert v._tpu.last_mode == "fast"
    v.route = "auto"
    np.testing.assert_array_equal(v.tokenize(text), ref.tokenize(text))
    assert v.last_route == "native"
    assert v.route_counts == {"device": 3, "native": 1}
    auto = tokenmonster_tpu_torch.load(VOCAB, device="cpu")
    assert auto.route == "auto"
    auto.tokenize(text)                 # below TPU_THRESHOLD: host
    assert auto.last_route == "native" and auto._tpu is None
    with pytest.raises(ValueError, match="route"):
        v.route = "native"
    with pytest.raises(ValueError, match="route"):
        tokenmonster_tpu_torch.load(VOCAB, device="cpu", route="gpu")


def test_import_leaves_jax_out():
    code = ("import sys, tokenmonster_tpu_torch, tokenmonster_tpu_torch.api,"
            " tokenmonster_tpu_torch.ops.scan, tokenmonster_tpu_torch.ops"
            "._build, tokenmonster_tpu_torch.train.trainvocab, "
            "tokenmonster_tpu_torch.parallel.score, "
            "tokenmonster_tpu_torch.corpus; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib')]; "
            "assert not bad, bad; print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tokenmonster_tpu_torch.load(VOCAB, device="cuda")
    from tokenmonster_tpu.core.vocab import Vocab
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tokenmonster_tpu_torch.GpuTokenizer(Vocab.load(VOCAB), device="cuda")


def _at_max_entries(monkeypatch, v):
    """Lower the device tables' limit to ``v``'s size, as a vocabulary of
    2^20 entries would meet it, and make every input a device candidate."""
    from tokenmonster_tpu_torch.ops import tables
    monkeypatch.setattr(tables, "MAX_ENTRIES", len(v._core.tokens))
    monkeypatch.setattr(v, "TPU_THRESHOLD", 16)


def test_auto_route_sends_a_vocabulary_at_max_entries_to_native(
        monkeypatch):
    """Under "auto" a vocabulary the device tables refuse for its size goes
    to native, counted there, and the device tokenizer is never built;
    "device" still raises, naming the roadmap item."""
    ref = tokenmonster_tpu.load(VOCAB)
    v = tokenmonster_tpu_torch.load(VOCAB, device="cpu")
    _at_max_entries(monkeypatch, v)
    text = ENGLISH.decode() * 25
    for k in (1, 2):
        np.testing.assert_array_equal(v.tokenize(text), ref.tokenize(text))
        assert v.last_route == "native"
        assert v.route_counts == {"device": 0, "native": k}
    assert v._tpu is None
    v.route = "device"
    with pytest.raises(NotImplementedError, match="item 14"):
        v.tokenize(text)
    assert v.route_counts == {"device": 0, "native": 2}


def test_auto_route_at_max_entries_in_a_batch(monkeypatch):
    """The batch path routes each item the same way: every item, small or
    large, on native."""
    ref = tokenmonster_tpu.load(VOCAB)
    v = tokenmonster_tpu_torch.load(VOCAB, device="cpu")
    _at_max_entries(monkeypatch, v)
    texts = [ENGLISH.decode() * k for k in (1, 9, 30)]
    for got, t in zip(v.tokenize(texts), texts):
        np.testing.assert_array_equal(got, ref.tokenize(t))
    assert v.route_counts == {"device": 0, "native": 3}


def test_server_serves_a_vocabulary_at_max_entries(monkeypatch):
    """The server loads through ``load``: a bulk request for a vocabulary
    at the limit is answered on native, bytes equal to the JAX server's."""
    import struct

    from tokenmonster_tpu import server as jserver
    from tokenmonster_tpu_torch import api as tapi
    from tokenmonster_tpu_torch import server as tserver
    from tokenmonster_tpu_torch.ops import tables

    fname = VOCAB.encode()
    size = len(tokenmonster_tpu_torch.load(VOCAB, device="cpu")._core.tokens)
    monkeypatch.setattr(tables, "MAX_ENTRIES", size)
    monkeypatch.setattr(tapi.Vocab, "TPU_THRESHOLD", 0)
    text = ENGLISH * 20
    req = struct.pack("<I", 1) + struct.pack("<Q", len(text)) + text
    got = {}
    for name, srv in (("jax", jserver.TokenMonsterServer()),
                      ("port", tserver.TokenMonsterServer("cpu"))):
        load = srv.handle(10, 0, bytes([len(fname)]) + fname)
        vid = struct.unpack_from("<I", load, 1)[0]
        got[name] = srv.handle(1, vid, req)
        if name == "port":
            assert srv.vocabs[vid].route_counts == {"device": 0, "native": 1}
    assert got["port"] == got["jax"]
