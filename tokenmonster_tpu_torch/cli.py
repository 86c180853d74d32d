"""Command-line tools mirroring the reference training pipeline:

  python -m tokenmonster_tpu_torch getalltokens -dataset D -output O -mode M ...
  python -m tokenmonster_tpu_torch trainvocab -dataset D -dictionary T -dir R ...
  python -m tokenmonster_tpu_torch exportvocab -input T -output V ...
  python -m tokenmonster_tpu_torch mergetokens A B ... -output O
  python -m tokenmonster_tpu_torch comparetokens A B
  python -m tokenmonster_tpu_torch server [-device cuda|cpu]
                                                (stdin/stdout RPC server)

Copy of ``tokenmonster_tpu/cli.py`` (``python -m tokenmonster_tpu_torch.cli``
works too).  One difference, the device: ``trainvocab -backend`` takes
"native" or "cuda" and defaults to "cuda" (candidates scored on the card,
as ``TrainConfig`` does), and ``-device`` of ``trainvocab`` and ``server``
("cuda" by default; "cpu" runs the kernels' plain PyTorch versions) names
where.  For ``trainvocab``, "cuda" is every visible card, "cuda:k" one,
and a comma-separated list one scoring slot each ("cuda:0,cuda:1").  The
JAX package's mesh-sharded ``-backend tpu`` is ``-backend cuda`` here:
``train_vocab`` raises for "tpu" and says so.  Launched as several
processes with ``WORLD_SIZE`` above 1 in the environment (``torchrun``,
or ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set by
hand), ``trainvocab`` joins their process group and splits every
candidate over the ranks (``parallel/multihost.py``); only rank 0 writes.
Every other flag, default and printed line is the JAX CLI's.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def _cmd_getalltokens(argv):
    p = argparse.ArgumentParser(prog="getalltokens")
    p.add_argument("-dataset", required=True)
    p.add_argument("-output", required=True)
    p.add_argument("-mode", required=True)
    p.add_argument("-charset", default="utf-8")
    p.add_argument("-norm", default="")
    p.add_argument("-capcode", type=int, default=2)
    p.add_argument("-max-token-length", type=int, default=40, dest="maxlen")
    p.add_argument("-min-occur", type=int, default=0)
    p.add_argument("-min-occur-byte", type=int, default=0)
    p.add_argument("-min-occur-chunk", type=int, default=4)
    p.add_argument("-min-occur-micro-chunk", type=int, default=2)
    p.add_argument("-chunk-size", type=int, default=100_000_000)
    p.add_argument("-micro-chunks", type=int, default=5)
    p.add_argument("-only-latin", action="store_true")
    p.add_argument("-only-valid", action="store_true")
    p.add_argument("-words-per-token", type=int, default=0)
    p.add_argument("-workers", type=int, default=0,
                   help="accepted for reference CLI compatibility "
                        "(getalltokens.go -workers); counting here is "
                        "vectorised numpy + the native counter, which "
                        "parallelise internally")
    p.add_argument("-prefilter-min-raw", type=int, default=1,
                   help="drop raw substrings seen fewer than N times before "
                        "the mode filters (default 1 = reference-exact "
                        "output; 2 is ~6x faster counting at 100 MB with "
                        "negligible pool loss — opt in for large datasets)")
    a = p.parse_args(argv)
    from .train.getalltokens import get_all_tokens, save_tokens_file
    charset = {"utf-8": 1, "utf8": 1, "none": 0, "binary": 0}[a.charset.lower()]
    norm = a.norm or ("nfd" if charset == 1 else "")
    with open(a.dataset, "rb") as f:
        data = f.read()
    counter, char_table, header = get_all_tokens(
        data, a.mode, charset=charset, normalization=norm,
        using_capcode=a.capcode, max_token_length=a.maxlen,
        min_occur_total=a.min_occur, min_occur_singles=a.min_occur_byte,
        min_occur_chunk=a.min_occur_chunk,
        min_occur_micro_chunk=a.min_occur_micro_chunk,
        chunk_size=a.chunk_size, micro_chunks=a.micro_chunks,
        only_latin=a.only_latin, only_valid=a.only_valid,
        words_per_token=a.words_per_token,
        prefilter_min_raw=max(1, a.prefilter_min_raw))
    if a.prefilter_min_raw > 1:
        print(f"prefilter-min-raw={a.prefilter_min_raw}: raw substrings "
              f"seen fewer times per micro-chunk were dropped before the "
              f"mode filters (output may differ from the reference's)")
    save_tokens_file(a.output, counter, char_table, header)
    print(f"Saved: {a.output} ({len(counter)} tokens)")


def _cmd_trainvocab(argv):
    p = argparse.ArgumentParser(prog="trainvocab")
    p.add_argument("-vocab-size", type=int, required=True, dest="vocab_size")
    p.add_argument("-dataset", required=True)
    p.add_argument("-dictionary", required=True)
    p.add_argument("-dictionary2", default=None)
    p.add_argument("-dir", required=True)
    p.add_argument("-workers", type=int, default=2)
    p.add_argument("-percentage", type=int, default=15)
    p.add_argument("-midway-target", type=int, default=0, dest="midway_target")
    p.add_argument("-keep-trying", type=int, default=1000, dest="keep_trying")
    p.add_argument("-special", default=None)
    p.add_argument("-fast", action="store_true")
    p.add_argument("-backend", default="cuda",
                   choices=["native", "cuda", "tpu"])   # tpu: raises
    p.add_argument("-device", default="cuda")
    p.add_argument("-include-256-bytes", action="store_true")
    p.add_argument("-include-128-bytes", action="store_true")
    p.add_argument("-include-utf8-bytes", action="store_true")
    p.add_argument("-include-ascii-bytes", action="store_true")
    p.add_argument("-include-extended-bytes", action="store_true")
    p.add_argument("-include-missing-bytes", action="store_true")
    p.add_argument("-exclude-other-bytes", action="store_true")
    p.add_argument("-max-rounds", type=int, default=None, dest="max_rounds")
    a = p.parse_args(argv)
    from .train.trainvocab import TrainConfig, train_vocab
    specials = []
    if a.special:
        import json
        with open(a.special) as f:
            data = json.load(f)
        for s in (data if isinstance(data, list) else data.get("special", [])):
            specials.append(s.encode("utf-8"))
    cfg = TrainConfig(
        vocab_size=a.vocab_size, workers=a.workers, percentage=a.percentage,
        midway_target=a.midway_target, keep_trying=a.keep_trying,
        fast=a.fast, backend=a.backend,
        include_256_bytes=a.include_256_bytes,
        include_128_bytes=a.include_128_bytes,
        include_utf8_bytes=a.include_utf8_bytes,
        include_ascii_bytes=a.include_ascii_bytes,
        include_extended_bytes=a.include_extended_bytes,
        include_missing_bytes=a.include_missing_bytes,
        exclude_other_bytes=a.exclude_other_bytes,
        special_tokens=specials, max_rounds=a.max_rounds)
    with open(a.dataset, "rb") as f:
        dataset = f.read()
    rank, world = 0, int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        from .parallel.multihost import init_distributed
        rank, world = init_distributed()
    dictionary = a.dictionary
    if a.dictionary2:
        # set-union of the two candidate dictionaries before training,
        # header from the first (trainvocab.go dictionary2 merge)
        dictionary = os.path.join(a.dir, "merged_dictionary.tok")
        if rank == 0:
            from .train.tools import merge_tokens
            os.makedirs(a.dir, exist_ok=True)
            n = merge_tokens([a.dictionary, a.dictionary2], dictionary)
            print(f"Merged dictionaries: {n} tokens")
        if world > 1:                 # the other ranks read rank 0's file
            import torch.distributed as dist
            dist.barrier()
    best = train_vocab(dataset, dictionary, a.dir, cfg, device=a.device)
    print(f"Best: {best}")


def _cmd_exportvocab(argv):
    p = argparse.ArgumentParser(prog="exportvocab")
    p.add_argument("-input", default=None)
    p.add_argument("-input-yaml", default=None, dest="input_yaml")
    p.add_argument("-input-vocab", default=None, dest="input_vocab")
    p.add_argument("-output", default=None)
    p.add_argument("-output-yaml", default=None, dest="output_yaml")
    p.add_argument("-resize", type=int, default=0)
    p.add_argument("-add-special-token", action="append", default=[])
    p.add_argument("-add-single-bytes", action="append", default=[])
    p.add_argument("-exclude-other-bytes", action="store_true")
    p.add_argument("-unk", default=None)
    p.add_argument("-reset-token-ids", action="store_true")
    p.add_argument("-order-by-score", action="store_true")
    p.add_argument("-output-tokens", default=None, dest="output_tokens")
    p.add_argument("-exists", default=None)
    a = p.parse_args(argv)
    from .train.exportvocab import export_vocab
    unk = None
    if a.unk is not None:
        unk = a.unk.lower() in ("1", "true", "yes")
    v = export_vocab(
        input_path=a.input, input_yaml=a.input_yaml, input_vocab=a.input_vocab,
        output=a.output, output_yaml=a.output_yaml, resize=a.resize,
        add_special_tokens=a.add_special_token,
        add_single_bytes=a.add_single_bytes,
        exclude_other_bytes=a.exclude_other_bytes, unk=unk,
        reset_token_ids=a.reset_token_ids, order_by_score=a.order_by_score,
        output_tokens=a.output_tokens)
    print(f"Vocabulary size: {len(v)}")
    if a.exists is not None:
        # token-existence probe: raw form, then the normalized form if it
        # differs (exportvocab.go:397-416)
        print(f"Looking for token: '{a.exists}'")
        raw = a.exists.encode()
        from .core.vocab import normalize_safe
        norm = normalize_safe(raw, v.using_capcode, v.normalizer)
        found_any = False
        seen = None
        for tok in (raw, norm):
            tid, found = v.token_to_id(tok)
            if found and tid != seen:
                seen = tid
                found_any = True
                print(f"\tID: {tid}")
                print(f"\t\tEncoded: '{tok.decode('utf-8', 'replace')}'")
                dec = v.denormalize(tok).decode("utf-8", "replace")
                print(f"\t\tDecoded: '{dec}'")
        if not found_any:
            print("\tNo tokens found")


def _cmd_mergetokens(argv):
    p = argparse.ArgumentParser(prog="mergetokens")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-output", required=True)
    a = p.parse_args(argv)
    from .train.tools import merge_tokens
    n = merge_tokens(a.inputs, a.output)
    print(f"Merged {len(a.inputs)} files -> {n} tokens")


def _cmd_comparetokens(argv):
    p = argparse.ArgumentParser(prog="comparetokens")
    p.add_argument("a")
    p.add_argument("b")
    a = p.parse_args(argv)
    from .train.tools import compare_tokens
    only_a, only_b, common = compare_tokens(a.a, a.b)
    print(f"Only in {a.a}: {len(only_a)}")
    print(f"Only in {a.b}: {len(only_b)}")
    print(f"In both: {len(common)}")


def _cmd_server(argv):
    p = argparse.ArgumentParser(prog="server")
    p.add_argument("-device", default="cuda")
    a = p.parse_args(argv)
    from .server import serve_stdio
    serve_stdio(device=a.device)


COMMANDS = {
    "getalltokens": _cmd_getalltokens,
    "trainvocab": _cmd_trainvocab,
    "exportvocab": _cmd_exportvocab,
    "mergetokens": _cmd_mergetokens,
    "comparetokens": _cmd_comparetokens,
    "server": _cmd_server,
}


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        print("usage: python -m tokenmonster_tpu_torch "
              f"{{{','.join(COMMANDS)}}} ...", file=sys.stderr)
        sys.exit(1)
    COMMANDS[sys.argv[1]](sys.argv[2:])


if __name__ == "__main__":
    main()
