"""Checkpoints on the port's own file structure (``core/fstore``)."""
from .checkpoint import CheckpointManager, load_tree, save_tree

__all__ = ["CheckpointManager", "load_tree", "save_tree"]
