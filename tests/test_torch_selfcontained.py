"""The port stands alone: no module of ``tokenmonster_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``tokenmonster_tpu``, shown two ways: every import statement of every file
(relative imports resolved), and a subprocess whose import system refuses
both names while it imports the whole port, tokenizes through ``load``,
builds a getalltokens pool (sorted by the device sort on the CPU), runs
one seeded ``train_vocab`` round on the device path (``backend="cuda"``,
two "cpu" scoring slots), exports the run
with ``python -m tokenmonster_tpu_torch exportvocab`` and tokenizes
through ``load_multiprocess_safe``, whose server process refuses both
names too (the refusal is a ``sitecustomize`` on the path every process
of the run starts with)."""

import ast
import os
import subprocess
import sys

import pytest

from torch_cases import ROOT

PKG = "tokenmonster_tpu_torch"
REFUSED = ("jax", "tokenmonster_tpu")


def _sources():
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, PKG)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.relpath(os.path.join(dirpath, f), ROOT)
                for f in sorted(filenames) if f.endswith(".py")]
    return out + ["chip_smoke.py"]


def _module_of(rel: str) -> tuple[str, bool]:
    """(dotted module name, is a package) of a repo-relative .py path."""
    parts = rel[:-3].split(os.sep)
    is_pkg = parts[-1] == "__init__"
    if is_pkg:
        parts = parts[:-1]
    return ".".join(parts), is_pkg


def imported_modules(rel: str) -> set:
    """Every module an import statement of ``rel`` names, relative imports
    resolved against its package; ``from a import b`` names both ``a`` and
    ``a.b``."""
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read(), rel)
    mod, is_pkg = _module_of(rel)
    pkg = mod if is_pkg else mod.rpartition(".")[0]
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")
                base = base[:len(base) - (node.level - 1)]
                target = ".".join(base + ([node.module] if node.module
                                          else []))
            else:
                target = node.module
            names.add(target)
            names |= {f"{target}.{a.name}" for a in node.names}
    return names


def _refused(name: str) -> bool:
    return any(name == r or name.startswith(r + ".") for r in REFUSED)


@pytest.mark.parametrize("rel", _sources())
def test_no_import_of_jax_or_the_jax_package(rel):
    names = imported_modules(rel)
    assert not [n for n in names if _refused(n)], rel


def test_resolver_sees_relative_imports():
    """The check above resolves ``from ..x import y`` inside the port to
    the port's own modules, so a relative path into the JAX package could
    not slip through it."""
    names = imported_modules(os.path.join(PKG, "train", "trainvocab.py"))
    assert f"{PKG}.core.vocab" in names and f"{PKG}.ops.scan" in names
    assert not any(_refused(n) for n in names)
    assert f"{PKG}.core.tokenmeta.DOES_NOT_EXIST" in imported_modules(
        os.path.join(PKG, "api.py"))


def test_source_walk_covers_the_shell_surfaces():
    """The walk above finds every file of the port by itself, the command
    line, the server, the client, the trainer tools, the corpus helpers,
    the importers, the device sort and the multi-process layer included."""
    want = {os.path.join(PKG, *p.split("/")) for p in (
        "__main__.py", "cli.py", "server.py", "client.py",
        "train/exportvocab.py", "train/tools.py", "train/score_helpers.py",
        "train/dataset_helpers.py", "train/imports.py", "ops/device_sort.py",
        "parallel/multihost.py")}
    assert want <= set(_sources())


SITE = r'''
import sys

REFUSED = ("jax", "tokenmonster_tpu")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
'''

CHILD = r'''
import importlib, logging, os, pkgutil, runpy, sys, tempfile

REFUSED = ("jax", "tokenmonster_tpu")
assert any(type(f).__name__ == "Refuse" for f in sys.meta_path)
import tokenmonster_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
        if not m.name.endswith(".__main__")]     # importing it runs the CLI
for m in mods:
    importlib.import_module(m)

v = pkg.load(os.path.join("examples", "realtext-1024-fast.vocab"),
             device="cpu", route="device")
ids = v.tokenize("The quick brown fox jumps over the lazy dog. " * 40)
assert v.last_route == "device" and len(ids) > 0
assert v.decode(ids).startswith("The quick brown fox")

from tokenmonster_tpu_torch.train.getalltokens import (get_all_tokens,
                                                       save_tokens_file)
from tokenmonster_tpu_torch.train.trainvocab import TrainConfig, train_vocab
corpus = (b"The quick brown fox jumps over the lazy dog. The dog sleeps "
          b"while the fox runs through the forest. ") * 60
os.environ["TM_GAT_DEVICE"] = "cpu"       # the device sort, on the CPU
counter, char_table, header = get_all_tokens(
    corpus, "balanced", charset=1, normalization="nfd", using_capcode=2,
    min_occur_total=10, min_occur_singles=1, add_extra_tokens=False)
assert len(counter) > 100
work = tempfile.mkdtemp()
tok = os.path.join(work, "pool.tok")
save_tokens_file(tok, counter, char_table, header)
rounds = []
logging.basicConfig(level=logging.WARNING)
log = logging.getLogger("tokenmonster_tpu_torch.trainvocab")
log.setLevel(logging.INFO)
log.addHandler(type("H", (logging.Handler,), {
    "emit": lambda self, r: rounds.append(r.getMessage())})())
train_vocab(corpus, tok, os.path.join(work, "out"),
            TrainConfig(vocab_size=100, workers=2, fast=True, seed=3,
                        max_rounds=1, backend="cuda"),
            device=["cpu", "cpu"])
assert any(r.startswith("round 1:") for r in rounds), rounds
sys.argv = ["-m", "exportvocab", "-input", tok, "-output",
            os.path.join(work, "out.vocab")]
runpy.run_module("tokenmonster_tpu_torch", run_name="__main__",
                 alter_sys=True)
remote = pkg.load_multiprocess_safe(os.path.join(work, "out.vocab"),
                                    device="cpu")
local = pkg.load(os.path.join(work, "out.vocab"), device="cpu")
text = "The quick brown fox jumps over the lazy dog."
assert list(remote.tokenize(text)) == list(local.tokenize(text))
remote._server.close()
assert remote._server._proc.returncode == 0
bad = [m for m in sys.modules
       if any(m == r or m.startswith(r + ".") for r in REFUSED)]
assert not bad, bad
print("ok", len(mods))
'''


def test_port_runs_with_jax_and_the_jax_package_refused(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(SITE)
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(tmp_path), ROOT])})
    assert res.returncode == 0, res.stderr[-4000:]
    ok, n_mods = res.stdout.split()[-2:]
    assert ok == "ok" and int(n_mods) >= 20
