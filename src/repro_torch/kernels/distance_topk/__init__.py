from .ops import (
    distance_topk,
    grouped_distance_topk,
    grouped_distance_topk_tensors,
    launches,
    reset_launches,
)
from .ref import distance_topk_ref, grouped_distance_topk_ref

__all__ = [
    "distance_topk",
    "distance_topk_ref",
    "grouped_distance_topk",
    "grouped_distance_topk_ref",
    "grouped_distance_topk_tensors",
    "launches",
    "reset_launches",
]
