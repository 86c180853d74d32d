"""The port's native library loader (tokenmonster_tpu_torch/native/):
processes that load a library not built yet, released at the same moment,
all get it.  Each child points the package's build root at one fresh
temporary directory, so each finds nothing built.  Builds are serialized
by an fcntl lock and written through a per-process temporary file; the
JAX package's loader, which compiles every process to one shared
temporary file, left some of six such processes without a library."""

import os
import shutil
import subprocess
import sys
import time

import pytest

from torch_cases import ROOT

CHILD = """
import os, sys, time
from tokenmonster_tpu_torch import native
native.BUILD_ROOT = sys.argv[1]
open(os.path.join(sys.argv[1], "ready_" + sys.argv[2]), "w").close()
while not os.path.exists(os.path.join(sys.argv[1], "go")):
    time.sleep(0.01)
lib = native.load_native()
print("ok", bool(lib.tm_tokenize_score), native.library_path())
"""


@pytest.mark.parametrize("n_procs", [2, 6])
def test_processes_build_and_load_at_once(tmp_path, n_procs):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path),
                               str(i)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(n_procs)]
    try:
        deadline = time.monotonic() + 120
        while not all((tmp_path / f"ready_{i}").exists()
                      for i in range(n_procs)):
            assert time.monotonic() < deadline, "children did not start"
            assert all(p.poll() is None for p in procs), "a child exited"
            time.sleep(0.05)
        (tmp_path / "go").touch()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    paths = set()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        ok, flag, path = out.split()
        assert (ok, flag) == ("ok", "True")
        paths.add(path)
    (so,) = paths
    assert os.path.exists(so) and so.startswith(str(tmp_path))
    left = [f for _d, _s, files in os.walk(tmp_path) for f in files
            if f.endswith(".tmp")]
    assert not left


def test_unbuildable_library_raises(tmp_path, monkeypatch):
    """Without a compiler the core modules take their pure-Python paths
    (``get_lib`` is None, retried once), and ``load_native`` and
    ``NativeVocab`` raise: the device path has no pure-Python fallback."""
    from tokenmonster_tpu_torch import native
    from tokenmonster_tpu_torch.core.vocab import Vocab

    calls = []

    def no_gxx(*args, **kw):
        calls.append(args)
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.subprocess, "run", no_gxx)
    assert native.get_lib() is None and len(calls) == 2
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.load_native()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.NativeVocab(Vocab.load(os.path.join(
            ROOT, "examples", "realtext-1024-fast.vocab")))


OVERRUN_CHILD = """
import sys
import numpy as np
from tokenmonster_tpu_torch.core.tokenizer import tokenize
from tokenmonster_tpu_torch.core.vocab import Vocab
from tokenmonster_tpu_torch.native import NativeVocab, id_bound

v = Vocab()
v._generate(tokens=[b" ", b"D", b"o", b"t", b"u", b"time", b" ut", b"tim"],
            charset=1, normalize_string="none", using_capcode=2, level=5,
            reset_token_ids=True)
if sys.argv[1] == "unk":
    assert v.enable_unk_token()
text = b"out\\xc2" * 20000
want, want_miss = tokenize(v, text)
assert len(want) <= id_bound(len(text))
nv = NativeVocab(v)
entry = sys.argv[2]
if entry == "score":
    scores = np.zeros(len(v.reverse) + 1, np.int64)
    n_tok, miss = nv.tokenize_score(text, scores)
    n_del = int((want == v.delete_token).sum())
    # tokensInText counts a missing byte as one token, unk or not
    n_want = len(want) + (0 if sys.argv[1] == "unk" else want_miss)
    assert (n_tok, miss) == (n_want, want_miss), (n_tok, miss)
    assert scores.sum() == len(text) - want_miss + n_del
else:
    got, miss = nv.tokenize(text, threads=1 if entry == "one" else 4)
    assert miss == want_miss and np.array_equal(got, want)
print("ok", len(want), len(text))
"""


@pytest.mark.parametrize("unk", ["unk", "nounk"])
@pytest.mark.parametrize("entry", ["one", "parallel", "score"])
def test_more_ids_than_bytes_fit(entry, unk):
    """A delete-token vocabulary emits more ids than bytes: with unk, "o",
    then " ut" as a forward-delete branch, " ut" giving way to the virtual
    space alone (a step of 0 bytes), "u", "t" and unk on each "out\\xc2"
    give 6 ids for 4 bytes.  The id buffers of every entry point (one
    thread, the parallel scan with its per-thread buffers and stitch, the
    trainer's scoring pass) hold 3 ids a byte, and the ids equal the
    port's pure-Python tokenizer.  In a subprocess: an overrun aborts the
    process."""
    res = subprocess.run([sys.executable, "-c", OVERRUN_CHILD, unk, entry],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, (res.returncode, res.stderr[-2000:])
    ok, n_ids, n_bytes = res.stdout.split()
    assert ok == "ok" and int(n_ids) > int(n_bytes)


@pytest.mark.parametrize("threads", [2, 8])
@pytest.mark.parametrize("capcode", [0, 2])
def test_parallel_scan_when_chains_never_meet(capcode, threads):
    """Tokens "aa", "a" and "x": after an "x", a run of "a" is tokenized in
    pairs from an odd position, and a thread that starts inside the run
    at an even one stays out of phase with it to its end, so the scan of
    the thread before runs on past the next thread's start and splices
    further on.  The stitch must not splice behind the state the output
    has reached (it emitted that span twice: 61,319 ids for 35,081 at 8
    threads); the ids equal the sequential scan's, the port's pure-Python
    tokenizer's and the JAX package's pure-Python tokenizer's on a
    vocabulary of the same tokens built there."""
    import numpy as np

    from tokenmonster_tpu.core import tokenizer as jax_tokenizer
    from tokenmonster_tpu.core.vocab import Vocab as JaxVocab
    from tokenmonster_tpu_torch.core.tokenizer import tokenize
    from tokenmonster_tpu_torch.core.vocab import Vocab
    from tokenmonster_tpu_torch.native import NativeVocab

    def built(cls):
        v = cls()
        v._generate(tokens=[b"aa", b"a", b"x"], charset=1,
                    normalize_string="none", using_capcode=capcode, level=5,
                    reset_token_ids=True)
        return v
    v, jv = built(Vocab), built(JaxVocab)
    nv = NativeVocab(v)
    for text in (b"x" + b"a" * 70000 + b"xaaxa" * 20,
                 (b"x" + b"a" * 20001 + b"xa") * 4):
        jax_ids, jax_miss = jax_tokenizer.tokenize(jv, text)
        want, want_miss = tokenize(v, text)
        one, one_miss = nv.tokenize(text, threads=1)
        got, miss = nv.tokenize(text, threads=threads)
        np.testing.assert_array_equal(want, np.asarray(jax_ids, np.uint32))
        np.testing.assert_array_equal(one, want)
        np.testing.assert_array_equal(got, want)
        assert miss == one_miss == want_miss == jax_miss


@pytest.mark.parametrize("level", [2, 1])
@pytest.mark.parametrize("text", [b"1a" * 300, b"A." * 300,
                                  b"0xFF 0xAB9c " * 40 + b"2b" * 100,
                                  "ÉA.ü1".encode() * 60, b"1a" * 8],
                         ids=["digit_letter", "caps_after_stop", "hex",
                              "accents", "fills_2n_plus_16"])
def test_capcode_encoders_past_twice_the_input(level, text):
    """Encodings longer than twice their input (capcode encodes "1a" as
    "D 1D a", three bytes a byte) come whole from the port's native
    encoders, equal to the JAX package's Python encoders (its native ones
    size their output at 2n + 16 bytes, so they are patched out); the
    port's native library wrote past such a buffer and returned it cut
    short."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    from unittest import mock

    from tokenmonster_tpu import native as jnative
    from tokenmonster_tpu.core import capcode as jcc
    from tokenmonster_tpu_torch import native

    name, encode = {2: ("native_capcode_encode", jcc.encode),
                    1: ("native_nocapcode_encode", jcc.no_capcode_encode)}[
                        level]
    got = getattr(native, name)(text)
    assert got is not None
    with mock.patch.object(jnative, name, lambda data: None):
        want = encode(text)
    assert got == want
    if (level, text[:2]) == (2, b"1a"):
        assert len(got) == 3 * len(text)
