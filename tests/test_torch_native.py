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
