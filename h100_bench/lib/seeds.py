"""Sub-seeds of a run's ``--seed``: one stream per purpose, so that adding a
draw to one purpose moves no other."""

from __future__ import annotations

import hashlib


def sub(seed: int, tag: str) -> int:
    """A 60-bit seed for ``tag``, fixed by ``seed`` (any whole number)."""
    return int(hashlib.sha256(f"{int(seed)}:{tag}".encode()).hexdigest()[:15], 16)
