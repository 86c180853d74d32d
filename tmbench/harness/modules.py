"""The check, once the window has closed, that the process loaded neither
JAX nor the JAX package: each module's top-level name, the part before
the first dot, compared whole (``tokenmonster_tpu_torch`` begins with the
JAX package's name and is not it)."""

from __future__ import annotations

REFUSED = ("jax", "jaxlib", "flax", "tokenmonster_tpu")


def refused(modules) -> list:
    """The names among ``modules`` whose top-level name is refused."""
    return sorted(m for m in modules if m.split(".", 1)[0] in REFUSED)
