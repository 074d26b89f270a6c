"""Scalar quantization for leaf blocks — the compressed-scan side of the
device-resident scoring pipeline (blob format v3).

Two tiers, chosen per blob at ``convert(..., quant=...)`` time:

  ``int8``     per-node affine quantization: one (scale, offset) pair for
               the whole node, codes in [-127, 127].  4x smaller than
               float32 rows, ~2.25x smaller than the f16+ids rows the
               full-precision block stores at dim=32.
  ``float16``  a lossless-ish middle tier: codes are the rows cast to
               f16.  When the index's storage dtype already is float16
               (the default), decode is bit-exact and the reconstruction
               radius is 0 — the quantized scan IS the fp scan.

The engine never trusts decoded distances: every scanned row carries a
reconstruction radius ``r`` (max L2 error between the decoded row and the
stored full-precision row), from which ``distance_bounds`` derives sound
lower/upper bounds on the exact distance.  Survivor selection keeps every
row whose lower bound could still make the top-R, so the full-precision
rerank reproduces the fp32 scan bit-for-bit (see core/search.py).

Codes are always computed from the *storage-dtype-rounded* rows (what
``get_node`` returns), so a blob's persisted codes and an fstore's
on-the-fly codes agree bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "QFORMATS",
    "QuantNode",
    "qdtype",
    "encode_node",
    "decode_codes",
    "reconstruction_radius",
    "distance_bounds",
]

QFORMATS = ("int8", "float16")

# int8 codes span [-127, 127]: 254 steps, -128 left unused so the range
# is symmetric around the offset
_INT8_STEPS = 254.0


def qdtype(qformat: str) -> np.dtype:
    if qformat == "int8":
        return np.dtype(np.int8)
    if qformat == "float16":
        return np.dtype(np.float16)
    raise ValueError(f"unknown quant format: {qformat!r} (int8|float16)")


@dataclass
class QuantNode:
    """One node's quantized rows + the decode/error parameters.

    ``scale`` doubles as the error carrier: for int8 it is the affine
    step; for float16 it is 0.0 when the cast roundtrips exactly (decode
    is bit-identical) else an upper bound on 2x the per-coordinate cast
    error.  Either way the L2 reconstruction radius of any row is
    ``0.5 * scale * sqrt(dim)``.
    """

    codes: np.ndarray  # [n_rows, dim] int8 | float16
    scale: float
    offset: float
    qformat: str

    @property
    def n_rows(self) -> int:
        return int(self.codes.shape[0])

    @property
    def dim(self) -> int:
        return int(self.codes.shape[1])

    @property
    def nbytes(self) -> int:
        return int(self.codes.nbytes) + 8  # + packed scale/offset

    _radius: float | None = None

    @property
    def radius(self) -> float:
        if self._radius is None:
            self._radius = reconstruction_radius(self.scale, self.dim)
        return self._radius

    def decode(self) -> np.ndarray:
        return decode_codes(self.codes, self.scale, self.offset, self.qformat)


def encode_node(emb: np.ndarray, qformat: str) -> QuantNode:
    """Quantize one node's float32 rows (as returned by ``get_node``)."""
    emb = np.ascontiguousarray(np.asarray(emb, np.float32))
    if emb.ndim != 2:
        raise ValueError(f"encode_node expects [n_rows, dim], got {emb.shape}")
    if qformat == "float16":
        codes = emb.astype(np.float16)
        if np.array_equal(codes.astype(np.float32), emb):
            scale = 0.0  # storage was already f16: decode is bit-exact
        else:
            # half-ulp cast error <= max_abs * 2^-11 per coordinate for
            # normal f16; the 2^-24 floor covers subnormal spacing
            max_abs = float(np.max(np.abs(emb))) if emb.size else 0.0
            scale = max(max_abs * 2.0**-10, 2.0**-24)
        return QuantNode(codes, scale, 0.0, qformat)
    if qformat != "int8":
        raise ValueError(f"unknown quant format: {qformat!r} (int8|float16)")
    if emb.size == 0:
        return QuantNode(emb.astype(np.int8), 0.0, 0.0, qformat)
    lo = float(emb.min())
    hi = float(emb.max())
    # scale/offset are persisted as f32 in the blob companion: round them
    # BEFORE computing codes so every path (blob-persisted, fstore
    # on-the-fly) lands on identical codes AND identical decode params
    offset = float(np.float32(0.5 * (lo + hi)))
    step = float(np.float32((hi - lo) / _INT8_STEPS))
    if step <= 0.0:  # constant node: offset reconstructs exactly
        return QuantNode(np.zeros(emb.shape, np.int8), 0.0, offset, qformat)
    codes = np.clip(np.rint((emb - offset) / step), -127, 127).astype(np.int8)
    return QuantNode(codes, step, offset, qformat)


def decode_codes(codes: np.ndarray, scale: float, offset: float, qformat: str) -> np.ndarray:
    """Codes -> approximate float32 rows (must match the kernel's dequant)."""
    if qformat == "float16":
        return codes.astype(np.float32)
    return codes.astype(np.float32) * np.float32(scale) + np.float32(offset)


def reconstruction_radius(scale: float, dim: int) -> float:
    """Max L2 distance between a decoded row and its source row: the
    per-coordinate error is <= scale/2 (int8 rounding step, or the f16
    cast bound ``encode_node`` stores in ``scale``), widened by a small
    factor to cover the f32 rounding of scale/offset and extreme-value
    clipping (bounded by ~127 * scale * 2^-23 per coordinate)."""
    return 0.5 * (1.0 + 2.0**-12) * float(scale) * float(np.sqrt(dim))


def distance_bounds(
    d_approx: np.ndarray, radius: float, metric: str, q_norm: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """Sound (lb, ub) on the exact distance given distances computed
    against decoded rows with L2 reconstruction error <= ``radius``.

    l2 distances here are SQUARED (np_distances convention): with
    ``s = sqrt(d~)`` the true euclidean distance lies in [s-r, s+r].
    ip/cosine are the negated-similarity forms; for ip the error is
    bounded by ``|q| * r`` (Cauchy-Schwarz).  cosine normalizes by the
    *decoded* row norm, which admits no cheap sound bound — every scanned
    row survives to the rerank (still bit-identical, just no candidate
    pruning).  Returns float64 arrays shaped like ``d_approx``.
    """
    d = np.asarray(d_approx, np.float64)
    r = float(radius)
    if metric == "l2":
        s = np.sqrt(np.maximum(d, 0.0))
        lb = np.square(np.maximum(s - r, 0.0))
        ub = np.square(s + r)
    elif metric == "ip":
        m = float(q_norm) * r
        lb = d - m
        ub = d + m
    elif metric == "cosine":
        lb = np.full(d.shape, -np.inf)
        ub = np.full(d.shape, np.inf)
    else:
        raise ValueError(f"unknown metric: {metric!r}")
    return lb, ub
