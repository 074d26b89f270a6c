"""Resharding a training state onto another mesh: not ported yet (ROADMAP
Queue 1 #13).  On one device a restored checkpoint goes back to the
state's device in ``TrainSupervisor``."""
from __future__ import annotations

from .collectives import _unported

__all__ = ["reshard_tree", "make_shardings"]

make_shardings = _unported("make_shardings", "shardings over a mesh")
reshard_tree = _unported("reshard_tree", "resharding onto a mesh")
