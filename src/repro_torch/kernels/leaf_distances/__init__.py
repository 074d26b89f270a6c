"""Packed mode's leaf scoring: the hand-written kernel
(``csrc/leaf_distances.cu``), its plain PyTorch version, and the wrapper
that dispatches between them by the device of the inputs."""
from .ops import (QUERY_GROUP, ROW_TILE, WARP_PAIRS, add_launch, launches, leaf_distances, leaf_work,
                  reset_launches, rows_scored, scored_rows)
from .ref import leaf_distances_ref

__all__ = ["QUERY_GROUP", "ROW_TILE", "WARP_PAIRS", "add_launch", "launches", "leaf_distances", "leaf_distances_ref",
           "leaf_work", "reset_launches", "rows_scored", "scored_rows"]
