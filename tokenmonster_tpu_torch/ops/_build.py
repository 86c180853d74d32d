"""Build, load and launch the hand-written CUDA kernels (``csrc/``).

nvcc compiles ``csrc/tm_kernels.cu`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into
``build/tokenmonster_tpu_torch/<hash>/`` under the repository root.  The
hash covers every source in ``csrc/`` and the compiler flags, so an edited
source builds anew and an unchanged one is reused.  The library is loaded
with ctypes; each kernel takes one argument struct, mirrored here by a
``ctypes.Structure`` (the C side is ``csrc/tm_kernels.cuh``).

Nothing here runs at import time: importing the package needs neither
nvcc nor a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build",
                          "tokenmonster_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


# ``n``, a dispatch's valid byte count, is a pointer to a device int32
# in each struct that reads it (``scalar_arg``).
class MatchArgs(ctypes.Structure):
    _fields_ = [("text", _P), ("fields", _P), ("disp", _P), ("single", _P),
                ("space_single", _P), ("scalars", _P), ("desc", _P),
                ("len_cls", _P), ("ovf_keys", _P), ("m", _P), ("mb", _P),
                ("n", _P), ("N", _I64), ("max_len", _I32),
                ("idx1_bits", _I32), ("has_space", _I32), ("lil_off", _I32),
                ("filt", _P), ("filt_log2", _I32), ("n_cls", _I32),
                ("disp_words", _I32), ("pad_", _I32)]


class DecideArgs(ctypes.Structure):
    _fields_ = [("m", _P), ("mb", _P), ("text", _P), ("entries", _P),
                ("bb", _P), ("ctl", _P), ("tok", _P), ("n", _P),
                ("N", _I64), ("n_entries", _I64), ("has_delete", _I32),
                ("has_unk", _I32), ("unk_token", _I32), ("lil_off", _I32),
                ("w3_shift", _I32), ("pad_", _I32)]


class FollowArgs(ctypes.Structure):
    _fields_ = [("ctl", _P), ("tok", _P), ("recs", _P), ("toks", _P),
                ("done_all", _P), ("n", _P), ("N", _I64), ("rows", _I32),
                ("chunk", _I32), ("overlap", _I32), ("W", _I32), ("L", _I32),
                ("t_rec", _I32), ("w3_shift", _I32), ("pad_", _I32)]


class CompactArgs(ctypes.Structure):
    _fields_ = [("recs", _P), ("toks", _P), ("s", _P), ("e", _P), ("q", _P),
                ("out", _P), ("out_len", _I64), ("T", _I32), ("L", _I32),
                ("w3_shift", _I32), ("pad_", _I32)]


KERNELS = ("match", "decide", "follow", "compact")

# Launches of each kernel in this process.  A wrapper adds one where it
# launches its kernel (launch() below) and nowhere else, so a caller can
# show that a run went through the kernels: zero the counts, run, read.
# A launch recorded into a CUDA graph runs nothing yet: it goes to the
# capture's tally (``tally``), which each replay of the graph adds here
# (``add_launches``).
launches = dict.fromkeys(KERNELS, 0)
_capture = threading.local()


def reset_launches():
    for k in KERNELS:
        launches[k] = 0


@contextlib.contextmanager
def tally():
    """Within the block, this thread's launches go to the dict it yields
    instead of ``launches``: the per-kernel launches of a graph capture."""
    counts = dict.fromkeys(KERNELS, 0)
    _capture.counts = counts
    try:
        yield counts
    finally:
        _capture.counts = None


def add_launches(counts: dict) -> None:
    """Count ``counts`` launches of each kernel: a graph's replay."""
    with _count_lock:
        for k, v in counts.items():
            launches[k] += v


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        h.update(name.encode() + b"\0")
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    return os.path.join(CUDA_HOME or "", "bin", "nvcc")


def library_path() -> str:
    return os.path.join(BUILD_ROOT, source_hash(), "libtm_kernels.so")


def build_library() -> str:
    """Compile the kernels unless this source hash is built already."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, "tm_kernels.cu")]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmd[0]}): the CUDA kernels "
                           "are built with the CUDA toolkit") from e
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def load_library():
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name, struct in (("match", MatchArgs), ("decide", DecideArgs),
                                 ("follow", FollowArgs),
                                 ("compact", CompactArgs)):
                fn = getattr(lib, f"tm_{name}_launch")
                fn.argtypes = [ctypes.POINTER(struct), _P]
                fn.restype = ctypes.c_int
            lib.tm_spin_launch.argtypes = [ctypes.c_longlong, _P]
            lib.tm_spin_launch.restype = ctypes.c_int
            for name in ("tm_decide_tile", "tm_decide_occupancy"):
                getattr(lib, name).argtypes = [ctypes.POINTER(ctypes.c_int)]
                getattr(lib, name).restype = ctypes.c_int
            lib.tm_match_smem.argtypes = [ctypes.POINTER(MatchArgs),
                                          ctypes.POINTER(ctypes.c_int)]
            lib.tm_match_smem.restype = ctypes.c_int
            lib.tm_match_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.tm_match_tile.restype = ctypes.c_int
            lib.tm_follow_tile.argtypes = [ctypes.POINTER(FollowArgs)]
            lib.tm_follow_tile.restype = ctypes.c_int
            lib.tm_error_string.argtypes = [ctypes.c_int]
            lib.tm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _launch(name: str, arg, device: torch.device) -> None:
    lib = load_library()
    fn = getattr(lib, f"tm_{name}_launch")
    if device.index is None or device.index == torch.cuda.current_device():
        # already the current device: no switch, which costs the host
        # more than the rest of a launch
        code = fn(arg, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            code = fn(arg, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        msg = lib.tm_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def launch(name: str, args: ctypes.Structure, device: torch.device) -> None:
    """Launch kernel ``name`` on ``device``'s current stream; raises if the
    launch was refused.  Counts the launch, or, inside ``tally`` (a graph
    capture), records it in the capture's tally."""
    _launch(name, ctypes.byref(args), device)
    counts = getattr(_capture, "counts", None)
    if counts is not None:
        counts[name] += 1
        return
    with _count_lock:              # scoring slots launch from threads
        launches[name] += 1


def spin(device: torch.device, cycles: int = 0) -> None:
    """Launch, the way ``launch`` launches a kernel, one thread that spins
    for ``cycles`` of the card's clock on ``device``'s current stream.  With
    0 cycles it is the yardstick of what a launch costs; with many, the
    host can queue work behind it and time that work on the card alone.
    No kernel of the path: not counted."""
    _launch("spin", cycles, device)


def scalar_arg(n, name: str, limit: int, device: torch.device):
    """``n`` as the int32 device scalar a kernel reads through a pointer:
    a tensor (a dispatch's scalar, ops/scan.py) is checked and passed as
    it is, with no read-back; an int is checked against [0, ``limit``]
    and written on ``device`` by a fill kernel, so no copy waits for the
    stream.  The caller keeps the tensor alive until its launch."""
    if isinstance(n, torch.Tensor):
        check(n, name, torch.int32, device, ())
        return n
    if not 0 <= n <= limit:
        raise ValueError(f"{name}={n} outside [0, {limit}]")
    return torch.full((), n, dtype=torch.int32, device=device)


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          device: torch.device, shape: tuple | None = None) -> None:
    """Validate a kernel argument before its pointer is passed."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
