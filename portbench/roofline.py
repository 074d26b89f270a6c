"""Peaks of the chip and the least bytes and operations each measured
kernel must spend.

Peaks: NVIDIA's H100 SXM data sheet, at the full 700 W limit.  A share of
a roofline is the least time the bytes (or operations) need at the peak,
over the time the device took; the result line names the card, and
``PERF.md`` its power limit.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores: the port scores in full float32, TF32 off


def distance_topk_full_bytes(rows: np.ndarray, dim: int, storage_itemsize: int) -> int:
    """A leaf-scorer launch per entry of ``rows``: the leaf's rows at the
    index's storage dtype, the float32 query, and a float32 distance and
    an int32 index out for each row, each read or written once (whatever
    the kernel pads or casts)."""
    rows = np.asarray(rows, np.int64)
    return int(rows.sum() * (dim * storage_itemsize + 8) + len(rows) * dim * 4)


def packed_batch_bytes(leaf_rows: int, centroid_rows: int, n_queries: int, dim: int,
                       storage_itemsize: int, served: int) -> int:
    """A packed request: every row of the distinct leaves its beams scan and
    every centroid its ranking reads, once, at the storage dtype; the
    float32 queries; ``served`` (float32 distance, int64 id) pairs out."""
    return int((leaf_rows + centroid_rows) * dim * storage_itemsize + n_queries * dim * 4 + served * 12)


def share(bytes_moved: float, flops: float, device_s: float) -> float | None:
    """Percent of the roofline: the least time the bytes or the float32
    operations need, whichever is longer, over the device's time; None
    when nothing was timed."""
    if device_s <= 0 or (bytes_moved <= 0 and flops <= 0):
        return None
    return 100.0 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS) / device_s
