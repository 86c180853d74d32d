#!/usr/bin/env python3
"""Time the match and follow kernels against their previous design.

    python3 tools/measure/previous_kernels.py extract [COMMIT]
    python3 tools/measure/previous_kernels.py time

``extract``, in a git checkout, writes the kernel sources of
``tokenmonster_tpu_torch/csrc/`` at COMMIT (default 8033868, the last
commit with the one-thread-per-position match kernel and the
one-thread-per-lane follow kernel) to ``build/previous_kernels/``, which
git ignores: the previous design is read from history, not kept in the
tree.  Run it before copying the tree to the machine with the card, which
has no git history.

``time``, on a CUDA card with that directory present, builds the previous
design with nvcc beside the current kernels, holds both against the plain
versions (tolerance 0), and times both on the same inputs in turns
(current, previous, previous, current; each design the mean of its two
medians of CUDA-event runs, ``chip_smoke.cuda_ms``) at two shapes:

- main: ``chip_smoke.py``'s main-path dispatch, 512 lanes x 2,048 bytes of
  standard-library text under realtext-32000, two fd rows;
- trainer: the same script's trainer pool, its superset masked to the
  first seeded 32,000-id candidate, on the first dispatch of its text.

It prints the card's name and power limit, and as its last line one JSON
object of the times.  The previous design's argument structs are copied
below as they were at that commit, so the current ones may change freely.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
OUT = os.path.join(ROOT, "build", "previous_kernels")
SOURCES = ("tm_kernels.cu", "tm_kernels.cuh")
DEFAULT_COMMIT = "8033868"

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


class MatchArgs(ctypes.Structure):
    """``tmk::MatchArgs`` of the previous design."""
    _fields_ = [("text", _P), ("fields", _P), ("disp", _P), ("single", _P),
                ("space_single", _P), ("scalars", _P), ("desc", _P),
                ("len_cls", _P), ("ovf_keys", _P), ("m", _P), ("mb", _P),
                ("N", _I64), ("n", _I32), ("max_len", _I32),
                ("idx1_bits", _I32), ("has_space", _I32), ("lil_off", _I32),
                ("pad_", _I32)]


class FollowArgs(ctypes.Structure):
    """``tmk::FollowArgs`` of the previous design."""
    _fields_ = [("ctl", _P), ("tok", _P), ("recs", _P), ("toks", _P),
                ("done_all", _P), ("N", _I64), ("rows", _I32), ("n", _I32),
                ("chunk", _I32), ("overlap", _I32), ("W", _I32), ("L", _I32),
                ("t_rec", _I32), ("pad_", _I32)]


def extract(commit: str) -> int:
    os.makedirs(OUT, exist_ok=True)
    for name in SOURCES:
        src = subprocess.run(
            ["git", "show", f"{commit}:tokenmonster_tpu_torch/csrc/{name}"],
            cwd=ROOT, capture_output=True, check=True).stdout
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(src)
    with open(os.path.join(OUT, "COMMIT"), "w") as f:
        f.write(subprocess.run(["git", "rev-parse", commit], cwd=ROOT,
                               capture_output=True, text=True,
                               check=True).stdout)
    print(f"wrote {', '.join(SOURCES)} of {commit} to {OUT}")
    return 0


class Previous:
    """The previous design's match and follow, launched on the current
    tables and inputs (the hash placement and every word format are the
    same in both designs)."""

    def __init__(self, so: str):
        lib = ctypes.CDLL(so)
        for name, struct in (("match", MatchArgs), ("follow", FollowArgs)):
            fn = getattr(lib, f"tm_{name}_launch")
            fn.argtypes = [ctypes.POINTER(struct), _P]
            fn.restype = ctypes.c_int
        self.lib = lib

    def _launch(self, name: str, args) -> None:
        import torch
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(self.lib, f"tm_{name}_launch")(ctypes.byref(args),
                                                      stream)
        if code != 0:
            raise RuntimeError(f"previous {name} kernel: launch failed "
                               f"({code})")

    def match(self, buf, n: int, tabs):
        import torch
        m = torch.empty(buf.numel(), dtype=torch.int32, device=buf.device)
        mb = torch.empty_like(m) if tabs.has_space else m
        self._launch("match", MatchArgs(
            text=buf.data_ptr(), fields=tabs.fields.data_ptr(),
            disp=tabs.disp.data_ptr(), single=tabs.single.data_ptr(),
            space_single=tabs.space_single.data_ptr(),
            scalars=tabs.scalars.data_ptr(), desc=tabs.desc.data_ptr(),
            len_cls=tabs.len_cls.data_ptr(),
            ovf_keys=tabs.ovf_keys.data_ptr(), m=m.data_ptr(),
            mb=mb.data_ptr(), N=buf.numel(), n=n, max_len=tabs.max_len,
            idx1_bits=tabs.idx1_bits, has_space=int(tabs.has_space),
            lil_off=tabs.lil_off))
        return (m, mb) if tabs.has_space else m

    def follow(self, ctl, tok, n, chunk, lanes, overlap, t_rec):
        import torch

        from tokenmonster_tpu_torch.ops.follow import window
        recs = torch.empty((t_rec, lanes), dtype=torch.int32,
                           device=ctl.device)
        toks = torch.empty_like(recs)
        done = torch.ones(1, dtype=torch.int32, device=ctl.device)
        self._launch("follow", FollowArgs(
            ctl=ctl.data_ptr(), tok=tok.data_ptr(), recs=recs.data_ptr(),
            toks=toks.data_ptr(), done_all=done.data_ptr(),
            N=ctl.shape[-1], rows=1 if ctl.dim() == 1 else ctl.shape[0],
            n=n, chunk=chunk, overlap=overlap, W=window(chunk, overlap),
            L=lanes, t_rec=t_rec))
        return recs, toks, done[0]


def triples(prev: Previous, buf, n: int, tabs, chunk: int, lanes: int,
            t_rec: int):
    """Per kernel, (current, previous, plain) calls on the same inputs."""
    from tokenmonster_tpu_torch.ops.decide import decide
    from tokenmonster_tpu_torch.ops.follow import follow, follow_plain
    from tokenmonster_tpu_torch.ops.match import match, match_plain
    from tokenmonster_tpu_torch.ops.scan import OVERLAP_SCAN
    mm = match(buf, n, tabs)
    m, mb = mm if tabs.has_space else (mm, None)
    ctl, tok = decide(m, mb, buf, n, tabs)
    args = (ctl, tok, n, chunk, lanes, OVERLAP_SCAN, t_rec)
    return {
        "match": (lambda: match(buf, n, tabs),
                  lambda: prev.match(buf, n, tabs),
                  lambda: match_plain(buf, n, tabs)),
        "follow": (lambda: follow(*args), lambda: prev.follow(*args),
                   lambda: follow_plain(*args)),
    }


def measure(smoke, calls: dict, shape: str, card: str) -> dict:
    import torch
    out = {}
    for name, (cur, prev, plain) in calls.items():
        want = plain()
        err = max(smoke.max_abs_err(cur(), want),
                  smoke.max_abs_err(prev(), want))
        torch.cuda.synchronize()
        smoke.require(err == 0, f"{name} ({shape}): max_abs_err {err}")
        a = smoke.cuda_ms(cur)
        b = smoke.cuda_ms(prev)
        c = smoke.cuda_ms(prev)
        d = smoke.cuda_ms(cur)
        out[name] = {"ms": (a + d) / 2, "previous_ms": (b + c) / 2,
                     "runs": [a, b, c, d], "max_abs_err": err}
        print(f"{name} ({shape}): current {out[name]['ms']:.4f} ms, "
              f"previous {out[name]['previous_ms']:.4f} ms (in turns: "
              f"{a:.4f}, {b:.4f}, {c:.4f}, {d:.4f}), max_abs_err 0 [{card}]",
              flush=True)
    return out


def time_designs() -> int:
    import torch
    if not torch.cuda.is_available():
        print("previous_kernels: torch sees no CUDA card", file=sys.stderr)
        return 1
    src = os.path.join(OUT, "tm_kernels.cu")
    if not os.path.exists(src):
        print(f"previous_kernels: no sources in {OUT}; run 'extract' in a "
              "git checkout first", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from tokenmonster_tpu_torch.core.vocab import Vocab
    from tokenmonster_tpu_torch.corpus import main_dispatch, stdlib_text
    from tokenmonster_tpu_torch.ops import _build
    from tokenmonster_tpu_torch.train.score_helpers import \
        candidate_runtime_state

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    with open(os.path.join(OUT, "COMMIT")) as f:
        commit = f.read().strip()[:12]
    so = os.path.join(OUT, f"lib_{os.getpid()}.so")
    nvcc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                             src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        _build.load_library()
        log, _ = nvcc.communicate(timeout=600)
    finally:
        if nvcc.poll() is None:
            nvcc.kill()
            nvcc.wait()
    if nvcc.returncode != 0:
        raise RuntimeError(f"previous design: nvcc failed:\n{log}")
    prev = Previous(so)
    os.remove(so)
    dev = torch.device("cuda", 0)

    core = Vocab.load(os.path.join(ROOT, smoke.VOCAB))
    raw, _dropped = stdlib_text(core, smoke.MAIN_BYTES)
    tk, buf, n = main_dispatch(core, raw, dev, smoke.CHUNK, smoke.LANES)
    result = {"card": card, "previous": commit, "shapes": {}}
    result["shapes"]["main"] = measure(smoke, triples(
        prev, buf, n, tk.tables, smoke.CHUNK, smoke.LANES, tk._t_rec(False)),
        "main", card)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="previous_kernels_",
                            dir=os.path.join(ROOT, "build"))
    try:
        t = smoke.trainer_inputs(dev, card, work)
        tabs = candidate_runtime_state(t.sc._sup, t.candidate())
        result["shapes"]["trainer"] = measure(smoke, triples(
            prev, t.buf, t.n, tabs, t.tk.chunk, smoke.LANES, t.t_rec),
            "trainer", card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result))
    return 0


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[1] == "extract":
        return extract(argv[2] if len(argv) > 2 else DEFAULT_COMMIT)
    if len(argv) == 2 and argv[1] == "time":
        return time_designs()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv))
