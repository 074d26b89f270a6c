"""Packed mode's merge: the hand-written kernel (``csrc/leaf_merge.cu``),
its plain PyTorch version, and the wrapper that dispatches between them by
the device of the inputs."""
from .ops import SLOTS_SMEM, SORT_SMEM, launches, leaf_merge, reset_launches, sort_keys
from .ref import leaf_merge_ref

__all__ = ["SLOTS_SMEM", "SORT_SMEM", "launches", "leaf_merge", "leaf_merge_ref", "reset_launches", "sort_keys"]
