"""Race-safe access to the native host library of ``tokenmonster_tpu``.

``tokenmonster_tpu.native.get_lib`` compiles ``tm_native.cpp`` on first use
into ``_build/tm_native.so`` by way of one shared ``tm_native.so.tmp`` path.
Processes that build at once (test workers on a fresh checkout) can break
each other's build, and a process whose build failed caches "unavailable"
for its lifetime.  The port reaches the library only through
``load_native``: builds of port processes are serialized by an ``fcntl``
lock beside ``_build/``, and a failed first load is retried once after any
other builder's temporary file is gone, when the library is on disk.  If it
still cannot be loaded, it raises: the port has no pure-Python fallback.
"""

from __future__ import annotations

import fcntl
import os
import time
import types

from tokenmonster_tpu import native as _native

TMP_WAIT_S = 300   # longest wait for another process's build to finish


def _wait_for_builder(build_dir: str) -> None:
    """Wait until no other process holds a temporary library file."""
    tmp = os.path.join(build_dir, "tm_native.so.tmp")
    deadline = time.monotonic() + TMP_WAIT_S
    while os.path.exists(tmp) and time.monotonic() < deadline:
        time.sleep(0.2)


def load_native(module: types.ModuleType = _native):
    """The native library of ``module`` (``tokenmonster_tpu.native``, or a
    copy of that package), built if needed.  Raises RuntimeError when it
    cannot be built or loaded."""
    pkg_dir = os.path.dirname(os.path.abspath(module.__file__))
    build_dir = os.path.join(pkg_dir, "_build")
    os.makedirs(build_dir, exist_ok=True)
    with open(build_dir + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        lib = module.get_lib()
        if lib is None:
            # a build raced with another process's: load what it left
            _wait_for_builder(build_dir)
            with module._lock:
                module._lib = None
            lib = module.get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {build_dir} holds "
                           "no loadable tm_native.so and g++ could not build "
                           "it")
    return lib


def native_vocab(vocab) -> _native.NativeVocab:
    """A native tokenizer handle for the core vocabulary ``vocab``."""
    load_native()
    return _native.NativeVocab(vocab)

