"""tokenmonster_tpu_torch: the TokenMonster device tokenizer in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of ``tokenmonster_tpu``'s device tokenization (match -> decide ->
follow -> stitch/compact), which stays the reference it is tested against.
The host layers (vocabulary formats, normalisation, capcode, the native
host tokenizer, the hash-table construction) are imported from it; this
package never imports jax.

Quick start::

    import tokenmonster_tpu_torch as tokenmonster
    vocab = tokenmonster.load("examples/realtext-32000-fast.vocab")
    ids = vocab.tokenize("some text")     # device route for large inputs
    text = vocab.decode(ids)

``device="cpu"`` runs the kernels' plain PyTorch versions instead.
"""

from .api import Vocab, load
from .ops.scan import GpuTokenizer

__version__ = "0.1.0"

__all__ = ["GpuTokenizer", "Vocab", "load", "__version__"]
