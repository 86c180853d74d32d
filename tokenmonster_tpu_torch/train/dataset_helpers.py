"""Dataset preparation helpers.

Equivalents of training/dataset_helpers/*.py and benchmark/onlyvalidlatin.go:
  - extract_text: pull text fields out of jsonl / parquet shards
  - only_valid_latin: strip a corpus down to valid-UTF-8, Latin-script text
  - sample_code_files: codeparrot-style sampler (one file per repo,
    200 mid-file lines) for any local corpus of code files

Copy of ``tokenmonster_tpu/train/dataset_helpers.py``: host code, no torch
work.
"""

from __future__ import annotations

import json
import os
import unicodedata


def extract_text(paths, output, field: str = "text",
                 separator: bytes = b"\n"):
    """Extract a text column from .jsonl / .parquet files into one corpus
    (training/dataset_helpers/extract_text_from_jsonl_parquet.py)."""
    n = 0
    with open(output, "wb") as out:
        for path in paths:
            if str(path).endswith(".parquet"):
                import pandas as pd
                df = pd.read_parquet(path, columns=[field])
                for v in df[field]:
                    out.write(str(v).encode("utf-8", "ignore"))
                    out.write(separator)
                    n += 1
            else:
                with open(path, "rb") as f:
                    for line in f:
                        if not line.strip():
                            continue
                        try:
                            obj = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        v = obj.get(field)
                        if v:
                            out.write(str(v).encode("utf-8", "ignore"))
                            out.write(separator)
                            n += 1
    return n


def only_valid_latin(data: bytes, min_run: int = 200) -> bytes:
    """Keep only runs of valid UTF-8 whose letters are Latin script
    (benchmark/onlyvalidlatin.go:29-80 semantics: drop segments containing
    invalid sequences or non-Latin letters, keeping runs >= min_run)."""
    text = data.decode("utf-8", errors="replace")
    out = []
    run = []

    def flush():
        if sum(len(s) for s in run) >= min_run:
            out.extend(run)
        run.clear()

    ok = True
    seg = []
    for ch in text:
        bad = ch == "�" or (
            ch.isalpha() and "LATIN" not in unicodedata.name(ch, "LATIN"))
        if bad:
            if seg:
                if ok:
                    run.append("".join(seg))
                seg = []
            flush()
            ok = True
            continue
        seg.append(ch)
        if len(seg) >= 4096:
            run.append("".join(seg))
            seg = []
    if seg:
        run.append("".join(seg))
    flush()
    return "".join(out).encode("utf-8")


def sample_code_files(root, output, per_dir: int = 1, mid_lines: int = 200,
                      extensions=(".py", ".go", ".js", ".c", ".cpp", ".rs",
                                  ".java", ".ts", ".rb", ".sh")):
    """Sample one file per directory, keeping ~200 mid-file lines
    (training/dataset_helpers/download_code_samples.py:1-13 behaviour,
    applied to a local tree instead of HF streaming)."""
    n = 0
    with open(output, "wb") as out:
        for dirpath, _dirs, files in os.walk(root):
            taken = 0
            for name in sorted(files):
                if taken >= per_dir:
                    break
                if not name.endswith(tuple(extensions)):
                    continue
                try:
                    with open(os.path.join(dirpath, name), "rb") as f:
                        lines = f.read().split(b"\n")
                except OSError:
                    continue
                if len(lines) > mid_lines:
                    start = (len(lines) - mid_lines) // 2
                    lines = lines[start:start + mid_lines]
                out.write(b"\n".join(lines))
                out.write(b"\n")
                taken += 1
                n += 1
    return n
