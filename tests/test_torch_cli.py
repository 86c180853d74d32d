"""The port's trainer pipeline from the shell and its serving surfaces
against the JAX package's, byte for byte (tolerance 0):

- ``train/tools.py`` (``merge_tokens``, ``compare_tokens``) and
  ``exportvocab`` through the ``exportvocab`` command (``-resize``,
  ``-add-special-token``, ``-unk``, ``-output-tokens``, ``-output-yaml``,
  ``-exists``), in process: the files written and the lines printed;
- the whole pipeline, ``python -m tokenmonster_tpu_torch getalltokens``,
  ``trainvocab -backend cuda -device cpu``, ``exportvocab``,
  ``mergetokens`` and ``comparetokens`` in a process that refuses jax and
  the JAX package, against ``python -m tokenmonster_tpu.cli`` with
  ``-backend native``: every file and every printed line.  Neither CLI
  has a seed flag, so both processes give ``random.Random`` the same
  default seed;
- ``server.TokenMonsterServer.handle`` (on the CPU device) on every job
  of ``tests/test_server.py``, its tokenize requests through the device
  route, and a ``load_multiprocess_safe`` round trip.
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from tokenmonster_tpu import api as japi
from tokenmonster_tpu import cli as jcli
from tokenmonster_tpu import server as jserver
from tokenmonster_tpu.core.vocab import Vocab as JVocab
from tokenmonster_tpu.train import getalltokens as jgat
from tokenmonster_tpu.train import tools as jtools
from tokenmonster_tpu.train import trainvocab as jtv
import tokenmonster_tpu_torch as tt
from tokenmonster_tpu_torch import cli as tcli
from tokenmonster_tpu_torch import server as tserver
from tokenmonster_tpu_torch.client import RemoteVocab
from tokenmonster_tpu_torch.train import tools as ttools

from torch_cases import ROOT
from torch_cases import jax_native  # noqa: F401 (autouse fixture)

CORPUS = (b"The quick brown fox jumps over the lazy dog. The dog sleeps "
          b"while the fox runs through the forest; every morning the sun "
          b"rises over the mountains and the birds sing their songs. ") * 40
OTHER = (b"def f(x):\n    return x * 2  # the quick python\n"
         b"int main() { printf(\"hello world\\n\"); return 0; }\n") * 30


def _pool(tmp_path, name, corpus, **kw):
    counter, char_table, header = jgat.get_all_tokens(
        corpus, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=5, min_occur_singles=1, add_extra_tokens=False, **kw)
    path = str(tmp_path / name)
    jgat.save_tokens_file(path, counter, char_table, header)
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A results directory trained to its end (final files with scores)
    by the JAX loop's native backend, and the pool it came from."""
    tmp = tmp_path_factory.mktemp("trained")
    tok = _pool(tmp, "pool.tok", CORPUS)
    out = str(tmp / "results")
    jtv.train_vocab(CORPUS, tok, out, jtv.TrainConfig(
        vocab_size=150, workers=2, fast=True, seed=5, keep_trying=4,
        backend="native"))
    return tok, out


def test_tools_equal_jax(tmp_path):
    """Merging pools of two corpora (the first with a special token) and
    comparing them: the same file and the same sets."""
    a = _pool(tmp_path, "a.tok", CORPUS)
    b = _pool(tmp_path, "b.tok", OTHER)
    d = jgat.load_tokens_file(a)
    jgat.save_tokens_with_scores(str(tmp_path / "s.tok"), d, d["tokens"],
                                 None, [b"<s>"])
    inputs = [str(tmp_path / "s.tok"), b]
    nj = jtools.merge_tokens(inputs, str(tmp_path / "mj.tok"))
    nt = ttools.merge_tokens(inputs, str(tmp_path / "mt.tok"))
    assert nj == nt > len(d["tokens"])
    assert (tmp_path / "mj.tok").read_bytes() == \
        (tmp_path / "mt.tok").read_bytes()
    got, want = ttools.compare_tokens(a, b), jtools.compare_tokens(a, b)
    assert got == want and all(got)


EXPORTS = {
    "plain": [],
    "resize-unk": ["-resize", "120", "-unk", "true"],
    "specials-bytes": ["-add-special-token", "<s>", "-add-special-token",
                       "</s>", "-add-single-bytes", "ascii", "-unk",
                       "false", "-reset-token-ids"],
    "tokens-yaml-exists": ["-output-tokens", "OUT.tok", "-output-yaml",
                           "OUT.yaml", "-order-by-score", "-exists", " the"],
}


@pytest.mark.parametrize("case", sorted(EXPORTS))
def test_exportvocab_equals_jax(case, trained, tmp_path, capsys):
    """``exportvocab`` of the trained directory, each option set through
    both packages' command: every file written and every line printed,
    the JAX exporter's known faults included."""
    _tok, results = trained
    outs = {}
    for name, cmd in (("jax", jcli._cmd_exportvocab),
                      ("port", tcli._cmd_exportvocab)):
        d = tmp_path / name
        d.mkdir()
        argv = ["-input", results, "-output", str(d / "out.vocab")]
        argv += [str(d / a[4:]) if a.startswith("OUT.") else a
                 for a in EXPORTS[case]]
        cmd(argv)
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        outs[name] = (files, capsys.readouterr().out.replace(str(d), "D"))
    assert outs["port"] == outs["jax"]
    files, printed = outs["port"]
    assert "out.vocab" in files and printed.startswith("Vocabulary size: ")


def test_trainvocab_backends(tmp_path):
    """``trainvocab -backend`` takes native or cuda (the default); tpu,
    the JAX package's mesh-sharded backend, raises and points to cuda;
    ``-device cuda`` without a card raises."""
    tok = _pool(tmp_path, "pool.tok", CORPUS)
    data = tmp_path / "data.txt"
    data.write_bytes(CORPUS)
    argv = ["-vocab-size", "120", "-dataset", str(data), "-dictionary", tok,
            "-dir", str(tmp_path / "out"), "-max-rounds", "1"]
    with pytest.raises(ValueError, match="'cuda' backend here"):
        tcli._cmd_trainvocab(argv + ["-backend", "tpu"])
    with pytest.raises(SystemExit):
        tcli._cmd_trainvocab(argv + ["-backend", "pallas"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tcli._cmd_trainvocab(argv)


CHILD = r'''
import json, os, random, runpy, sys

pkg, steps = sys.argv[1], json.loads(sys.argv[2])
if pkg == "tokenmonster_tpu_torch":
    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "tokenmonster_tpu"):
                raise ImportError(f"refused: {name}")
            return None
    sys.meta_path.insert(0, Refuse())


class Seeded(random.Random):
    def __init__(self, x=None):
        super().__init__(17 if x is None else x)


random.Random = Seeded
module = pkg if pkg == "tokenmonster_tpu_torch" else pkg + ".cli"
for argv in steps:
    sys.argv = ["-m"] + argv
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    print("--", flush=True)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "tokenmonster_tpu")]
assert pkg != "tokenmonster_tpu_torch" or not bad, bad
'''


def _pipeline(pkg, work, backend):
    work.mkdir()
    (work / "data.txt").write_bytes(CORPUS)
    (work / "other.txt").write_bytes(OTHER)
    gat = ["-mode", "balanced", "-capcode", "2", "-min-occur", "5",
           "-min-occur-byte", "1"]
    steps = [
        ["getalltokens", "-dataset", "data.txt", "-output", "pool.tok"] + gat,
        ["getalltokens", "-dataset", "other.txt", "-output", "other.tok"]
        + gat,
        ["mergetokens", "pool.tok", "other.tok", "-output", "merged.tok"],
        ["comparetokens", "pool.tok", "other.tok"],
        ["trainvocab", "-dataset", "data.txt", "-dictionary", "pool.tok",
         "-dir", "out", "-vocab-size", "150", "-fast", "-keep-trying", "4",
         "-max-rounds", "10"] + backend,
        ["exportvocab", "-input", "out", "-output", "final.vocab",
         "-output-tokens", "final.tok", "-exists", "the"],
    ]
    res = subprocess.run([sys.executable, "-c", CHILD, pkg,
                          json.dumps(steps)], cwd=work, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr[-4000:]
    files = {}
    for dirpath, _dirs, names in os.walk(work):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, work)] = f.read()
    return res.stdout, files


def test_cli_pipeline_equals_jax(tmp_path):
    """The port's command line with ``-backend cuda -device cpu`` (the
    kernels' plain versions) against the JAX command line with ``-backend
    native``: the same pools, merge, comparison, every file of the
    training run, the exported vocabulary and its tokens, the same
    printed lines."""
    port = _pipeline("tokenmonster_tpu_torch", tmp_path / "port",
                     ["-backend", "cuda", "-device", "cpu"])
    jax = _pipeline("tokenmonster_tpu", tmp_path / "jax",
                    ["-backend", "native"])
    assert sorted(port[1]) == sorted(jax[1])
    for name in port[1]:
        assert port[1][name] == jax[1][name], name
    assert port[0] == jax[0]
    assert "final.vocab" in port[1] and "merged.tok" in port[1]
    assert any(n.startswith("out" + os.sep) for n in port[1])
    assert "Best: " in port[0] and "Looking for token: 'the'" in port[0]
    v = tt.load(str(tmp_path / "port" / "final.vocab"), device="cpu",
                route="device")
    ids = v.tokenize(CORPUS.decode())
    assert v.last_route == "device"
    np.testing.assert_array_equal(ids, japi.load(
        str(tmp_path / "jax" / "final.vocab")).tokenize(CORPUS.decode()))


def _u32(v):
    return struct.pack("<I", v)


def _batch1(payload: bytes) -> bytes:
    return _u32(1) + struct.pack("<Q", len(payload)) + payload


def _server_jobs(tmp_path):
    """The requests of ``tests/test_server.py``, in its order, with the
    ids its responses give, as (job, id, payload) functions of the
    responses so far; and the vocabulary file they load."""
    v = JVocab.new(tokens=[b"hello", b" hello", b"world", b" world"],
                   special_tokens=[b"<s>"], charset=1, normalization="none",
                   using_capcode=2, include_ascii_bytes=True)
    path = tmp_path / "s.vocab"
    v.save(path)
    fname = str(path).encode()
    out_path = str(tmp_path / "resaved.vocab").encode()
    vid = lambda r: struct.unpack_from("<I", r["load"], 1)[0]  # noqa: E731

    def ser(r):
        blen = struct.unpack_from("<Q", r["tok"], 13)[0]
        return r["tok"][21:21 + blen]

    def tid(i):
        def f(r):
            return struct.pack("<H", np.frombuffer(ser(r), "<u2")[i])
        return f

    did = lambda r: struct.unpack_from("<I", r["dec"], 1)[0]  # noqa: E731
    modify = bytes([0, 0]) + _u32(1) + bytes([3]) + b"zzz" + _u32(0) * 3

    def yml(r):
        ln = struct.unpack_from("<Q", r["yaml"], 1)[0]
        return r["yaml"][9:9 + ln]
    jobs = [
        ("version", 0, lambda r: 0, lambda r: b""),
        ("load", 10, lambda r: 0, lambda r: bytes([len(fname)]) + fname),
        ("tok", 1, vid, lambda r: _batch1(b"hello world")),
        ("count", 20, vid, lambda r: _batch1(b"hello world")),
        ("decode", 2, vid, lambda r: _batch1(ser(r))),
        ("dec", 5, vid, lambda r: b""),
    ]
    jobs += [(f"stream{i}", 7, did, tid(i)) for i in range(2)]
    jobs += [
        ("deldec", 6, did, lambda r: b""),
        ("list", 15, vid, lambda r: b""),
        ("modify", 14, vid, lambda r: modify),
        ("delete_id", 16, vid, lambda r: _u32(3)),
        ("yaml", 19, vid, lambda r: bytes([0])),
        ("from_yaml", 18, lambda r: 0, yml),
        ("modify_yaml", 17, vid, yml),
        ("bad_yaml", 17, vid, lambda r: b"\x00: [unclosed"),
        ("save", 12, vid, lambda r: bytes([len(out_path)]) + out_path),
        ("unload", 11, vid, lambda r: b""),
        ("unloaded", 1, vid, lambda r: _batch1(b"x")),
        ("missing", 1, lambda r: 99, lambda r: _batch1(b"x")),
        ("bad_job", 13, lambda r: 0, lambda r: b""),
    ]
    return jobs


def test_server_handle_equals_jax(tmp_path):
    """Every response of the port's server equals the JAX server's, byte
    for byte, request after request, the file it saves included."""
    jobs = _server_jobs(tmp_path)
    seen = {}
    for name, make in (("jax", jserver.TokenMonsterServer),
                       ("port", lambda: tserver.TokenMonsterServer("cpu"))):
        s, r = make(), {}
        for key, job, vid, payload in jobs:
            r[key] = s.handle(job, vid(r), payload(r))
        r["saved"] = (tmp_path / "resaved.vocab").read_bytes()
        seen[name] = r
    assert seen["port"] == seen["jax"]
    assert tserver.VERSION == jserver.VERSION == 5
    r = seen["port"]
    assert r["tok"][0] == 0 and r["unloaded"][0] == 11
    assert r["missing"][0] == 10 and r["bad_job"][0] == 15


def test_server_tokenizes_through_the_device_route(tmp_path, monkeypatch):
    """The port's server holds ``api.Vocab`` objects on its device: with the
    device threshold at 0 every tokenize request takes the device route
    (here the kernels' plain versions), and its bytes equal the JAX
    server's.  A "cuda" server without a card raises."""
    path = os.path.join(ROOT, "examples", "realtext-1024-fast.vocab")
    fname = path.encode()
    text = CORPUS + OTHER
    monkeypatch.setattr(tt.Vocab, "TPU_THRESHOLD", 0)
    got = {}
    for name, srv in (("jax", jserver.TokenMonsterServer()),
                      ("port", tserver.TokenMonsterServer("cpu"))):
        load = srv.handle(10, 0, bytes([len(fname)]) + fname)
        vid = struct.unpack_from("<I", load, 1)[0]
        got[name] = [srv.handle(1, vid, _batch1(t)) for t in (text, b"")]
        if name == "port":
            vocab = srv.vocabs[vid]
            assert isinstance(vocab, tt.Vocab)
            assert vocab.device == torch.device("cpu")
            assert vocab.route_counts == {"device": 1, "native": 0}
            assert vocab._tpu.host_fallbacks == 0
    assert got["port"] == got["jax"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tserver.TokenMonsterServer()


def test_load_multiprocess_safe_round_trip(tmp_path):
    """``load_multiprocess_safe`` starts the port's server in a process of
    its own; its ids and decode equal ``load(device="cpu")``'s."""
    path = os.path.join(ROOT, "examples", "realtext-1024-fast.vocab")
    text = (CORPUS + OTHER).decode()
    remote = tt.load_multiprocess_safe(path, device="cpu")
    try:
        assert isinstance(remote, RemoteVocab)
        local = tt.load(path, device="cpu")
        assert len(remote) == len(local)
        ids = remote.tokenize(text)
        np.testing.assert_array_equal(ids, local.tokenize(text))
        assert remote.decode(ids) == local.decode(ids)
        remote.unload()
    finally:
        remote._server.close()
    assert remote._server._proc.returncode == 0
