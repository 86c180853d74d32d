"""The id that marks an absent token, frozen from
``tokenmonster_tpu_torch/core/tokenmeta.py`` at commit 6d463e6b506c.

Only the pieces that the plain reference calls, each copied whole.
``tmbench/tests/test_tmbench_frozen.py`` holds each piece to its
source at that commit; the copy stays as it is when the source
changes."""

from __future__ import annotations


DOES_NOT_EXIST = 0xFFFFFF
