#!/usr/bin/env python3
"""Time variants of the decide kernel against the tree's design.

    python3 tools/measure/decide_variants.py [VARIANT ...]

On a CUDA card: writes a patched copy of ``tokenmonster_tpu_torch/csrc/``
for each variant to ``build/decide_variants/<name>/`` (git-ignored),
builds them all at once with nvcc (``-Xptxas -v``: registers, spills,
shared memory), holds each against the plain version on
``chip_smoke.py``'s main-path dispatch (512 lanes x 2,048 bytes,
realtext-32000, two fd rows; tolerance 0), and times each on the card
alone (``chip_smoke.cuda_ms(queued=True)``, behind a spin), once in the order
given and once in reverse.  It prints the card's name and power limit
first, and for the tree's design the count of SASS instructions of the
kernel where the toolkit has ``cuobjdump``.

A variant is a set of text substitutions in the sources, so each says
exactly what it changes; a substitution that no longer applies raises.

  tree          the sources as they are
  blocksN       at least N blocks an SM (``__launch_bounds__``): fewer
                registers a thread
  TxP           T threads a block, P positions a thread (tile T x P)
  stage_only    no decisions: the stage, and stores of staged words
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
OUT = os.path.join(ROOT, "build", "decide_variants")


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"substitution no longer applies: {old!r}")
    return text.replace(old, new)


def tree(cu, cuh):
    return cu, cuh


def blocks(n: int):
    def patch(cu, cuh):
        return _sub(cu, "__launch_bounds__(DECIDE_THREADS) decide_kernel",
                    f"__launch_bounds__(DECIDE_THREADS, {n}) decide_kernel"
                    ), cuh
    return patch


def geometry(threads: int, per: int):
    def patch(cu, cuh):
        cuh = _sub(cuh, "constexpr int32_t DECIDE_THREADS = 256;",
                   f"constexpr int32_t DECIDE_THREADS = {threads};")
        return cu, _sub(cuh, "constexpr int32_t DECIDE_PER = 2;",
                        f"constexpr int32_t DECIDE_PER = {per};")
    return patch


def stage_only(cu, cuh):
    return _sub(
        cu,
        "      if (fd < rows) tmk::decide_tile_at(a, win + i, p0 + i, fd, "
        "own[k][fd]);",
        "      if (fd < rows) { a.ctl[fd * a.N + p0 + i] = "
        "win[i + (own[k][fd].mf & 63u)].a + own[k][fd].w[2]; "
        "a.tok[fd * a.N + p0 + i] = own[k][fd].w[0] + own[k][fd].w[1]; }"
        ), cuh


VARIANTS = {"tree": tree, "blocks4": blocks(4), "blocks6": blocks(6),
            "256x1": geometry(256, 1), "256x4": geometry(256, 4),
            "128x4": geometry(128, 4), "512x2": geometry(512, 2),
            "stage_only": stage_only}


def _decide_info(log: str) -> str:
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "decide_kernel" in line:
            return " ".join(x.strip() for x in lines[i + 1:i + 4]
                            if "Used" in x or "spill" in x)
    return ""


def _sass_count(so: str, nvcc: str) -> int | None:
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    txt = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    for part in txt.split("Function : ")[1:]:
        if "decide_kernel" in part.split("\n")[0]:
            return len(re.findall(r"^\s+/\*[0-9a-f]{4}\*/", part, re.M))
    return None


def main(names: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("decide_variants: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from tokenmonster_tpu_torch.core.vocab import Vocab
    from tokenmonster_tpu_torch.corpus import main_dispatch, stdlib_text
    from tokenmonster_tpu_torch.ops import _build
    from tokenmonster_tpu_torch.ops.decide import decide_plain
    from tokenmonster_tpu_torch.ops.match import match

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    core = Vocab.load(os.path.join(ROOT, smoke.VOCAB))
    raw, _dropped = stdlib_text(core, smoke.MAIN_BYTES)
    tk, buf, n = main_dispatch(core, raw, dev, smoke.CHUNK, smoke.LANES)
    tabs = tk.tables

    sources = {}
    for name in ("tm_kernels.cu", "tm_kernels.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            sources[name] = f.read()
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        cu, cuh = VARIANTS[name](sources["tm_kernels.cu"],
                                 sources["tm_kernels.cuh"])
        for fname, text in (("tm_kernels.cu", cu), ("tm_kernels.cuh", cuh)):
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "tm_kernels.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: nvcc failed:\n{log}")
            print(f"{name}: {_decide_info(log)}", flush=True)
            lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
            lib.tm_decide_launch.argtypes = [
                ctypes.POINTER(_build.DecideArgs), ctypes.c_void_p]
            lib.tm_decide_launch.restype = ctypes.c_int
            libs[name] = lib
        if "tree" in libs:
            count = _sass_count(os.path.join(OUT, "tree", "lib.so"),
                                _build._nvcc())
            print(f"tree: {count} SASS instructions in decide_kernel")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    m, mb = match(buf, n, tabs)
    want = decide_plain(m, mb, buf, n, tabs)
    N = m.numel()
    ctl = torch.empty((2, N), dtype=torch.int32, device=dev)
    tok = torch.empty((2, N), dtype=torch.int32, device=dev)

    n_t = _build.scalar_arg(n, "n", N, dev)
    args = _build.DecideArgs(
        m=m.data_ptr(), mb=mb.data_ptr(), text=buf.data_ptr(),
        entries=tabs.entries.data_ptr(), bb=tabs.bb.data_ptr(),
        ctl=ctl.data_ptr(), tok=tok.data_ptr(), n=n_t.data_ptr(),
        literals=tabs.literals.data_ptr(), N=N,
        n_entries=tabs.entries.shape[1], has_delete=1,
        lil_off=tabs.lil_off, w3_shift=tabs.w3_shift)
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(name):
        def run():
            code = libs[name].tm_decide_launch(ctypes.byref(args), stream)
            smoke.require(code == 0, f"{name}: launch failed ({code})")
        return run

    times = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            run = launcher(name)
            ctl.fill_(-1)
            tok.fill_(-1)
            run()
            torch.cuda.synchronize()
            if name != "stage_only":
                smoke.require(smoke.max_abs_err((ctl, tok), want) == 0,
                              f"{name} disagrees with the plain version")
            times[name].append(smoke.cuda_ms(run, queued=True))
    for name, (a, b) in times.items():
        print(f"{name}: {a:.4f} {b:.4f} ms on the card alone")
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    chosen = sys.argv[1:] or list(VARIANTS)
    if not set(chosen) <= set(VARIANTS):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(chosen))
