"""The port's race-safe native loader (tokenmonster_tpu_torch/native.py):
processes that load a native library not built yet, released at the same
moment, all get it.  The native package is copied to a temporary directory
without its _build/, so each finds nothing built.  Unguarded, they compile
to one shared temporary file; with six processes some then end up without
a library (tokenmonster_tpu.native.get_lib alone failed every such run
tried)."""

import os
import shutil
import subprocess
import sys
import time

import pytest

from tokenmonster_tpu import native

from torch_cases import ROOT

CHILD = """
import os, sys, time
sys.path.insert(0, sys.argv[1])
import tm_native_copy
from tokenmonster_tpu_torch.native import load_native
open(os.path.join(sys.argv[1], "ready_" + sys.argv[2]), "w").close()
while not os.path.exists(os.path.join(sys.argv[1], "go")):
    time.sleep(0.01)
lib = load_native(tm_native_copy)
print("ok", bool(lib.tm_tokenize_score))
"""


@pytest.mark.parametrize("n_procs", [2, 6])
def test_processes_build_and_load_at_once(tmp_path, n_procs):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    pkg = tmp_path / "tm_native_copy"
    pkg.mkdir()
    src = os.path.dirname(native.__file__)
    for name in ("__init__.py", "tm_native.cpp"):
        shutil.copy(os.path.join(src, name), pkg / name)
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
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "ok True"
    assert (pkg / "_build" / "tm_native.so").exists()
    assert not (pkg / "_build" / "tm_native.so.tmp").exists()
