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
