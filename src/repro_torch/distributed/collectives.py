"""Collectives inside a sharded train step: not ported yet (ROADMAP Queue 1
#13).  On one device the compressed reduce's numerics are
``optim.compress_decompress`` on the gradients, which the trainer runs."""
from __future__ import annotations

__all__ = ["psum_compressed", "tree_psum"]


def _unported(name: str, what: str = "a collective over a mesh"):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} ({what}) is not ported yet (ROADMAP Queue 1 #13)")

    fn.__name__ = name
    return fn


tree_psum = _unported("tree_psum")
psum_compressed = _unported("psum_compressed")
