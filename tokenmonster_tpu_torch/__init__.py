"""tokenmonster_tpu_torch: the TokenMonster device tokenizer in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of ``tokenmonster_tpu``'s device tokenization (match -> decide ->
follow -> stitch/compact) and of its trainer's candidate scorer and
distillation loop; the JAX package stays the reference it is tested
against.  The framework-free layers (``utils/``, ``core/``, ``native/``,
``ops/hashmatch.py``, ``train/getalltokens.py`` and its filters, the
user API, the trainer loop, ``exportvocab``, the token tools, the
wire-protocol server and client and the command line, ``python -m
tokenmonster_tpu_torch``) are this package's own copies, laid out as
in the JAX package: this package imports neither jax nor anything of
``tokenmonster_tpu``.

Quick start::

    import tokenmonster_tpu_torch as tokenmonster
    vocab = tokenmonster.load("examples/realtext-32000-fast.vocab")
    ids = vocab.tokenize("some text")     # device route for large inputs
    text = vocab.decode(ids)

``device="cpu"`` runs the kernels' plain PyTorch versions instead.
"""

from .api import Vocab, load, load_multiprocess_safe
from .ops.scan import GpuTokenizer

__version__ = "0.1.0"

__all__ = ["GpuTokenizer", "Vocab", "load", "load_multiprocess_safe",
           "__version__"]
