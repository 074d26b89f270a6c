"""Public op: ``leaf_distances``, packed mode's leaf scoring.

Dispatch goes by the device of the inputs: tensors on the CPU take the
plain PyTorch version (``ref.leaf_distances_ref``: distinct leaves padded
to the largest, in blocks of ``budget_bytes``), tensors on a CUDA device
launch the hand-written kernel (``csrc/leaf_distances.cu``: each query
against only the real rows of its own leaves, read in place) or raise;
there is no switch that sends CUDA tensors to the plain version.
``launches`` counts the calls that launched the kernel (a plain integer,
bumped only there); ``reset_launches()`` zeroes it.  Every such call is
one launch of the kernel, after ``leaf_work`` groups the pairs by leaf
with a few PyTorch operations on the device and no host synchronisation.
"""
from __future__ import annotations

import threading

import torch

from .. import _build
from .ref import leaf_distances_ref

# rows and pairs of one work item, and the pairs of one warp (kTR, kQG and
# 4 a warp in csrc/leaf_distances.cu)
ROW_TILE = 128
QUERY_GROUP = 32
WARP_PAIRS = 4

launches = {"leaf_distances": 0}
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        launches["leaf_distances"] = 0


def leaf_work(leaf_c: torch.Tensor, lvalid: torch.Tensor, n_rows: torch.Tensor):
    """The kernel's work list, on the inputs' device: (perm [B*b] int32,
    the pair ids ``query * b + slot`` of the valid slots grouped by leaf,
    ascending within a leaf, the invalid ones last; first [L + 1] int32,
    the position in perm of each leaf's first pair, first[L] the valid
    pairs; ends [L] int32, the inclusive sums of the leaves' work items,
    ceil(pairs / QUERY_GROUP) x ceil(n_rows / ROW_TILE) each)."""
    L = n_rows.shape[0]
    key = torch.where(lvalid, leaf_c, L).reshape(-1)
    skey, perm = torch.sort(key, stable=True)
    first = torch.searchsorted(skey, torch.arange(L + 1, device=key.device, dtype=skey.dtype))
    pairs = first[1:] - first[:-1]
    tiles = (n_rows.long() + ROW_TILE - 1) // ROW_TILE
    items = (pairs + QUERY_GROUP - 1) // QUERY_GROUP * tiles
    return perm.int(), first.int(), torch.cumsum(items, 0).int()


def scored_rows(leaf_c: torch.Tensor, lvalid: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    """The (row, pair) distances the kernel computes for these inputs, as a
    0-d int64 tensor on their device, with no host synchronisation: each
    leaf's row tiles (ROW_TILE rows, zero-filled past its real rows) times
    its valid pairs rounded up to whole warps (WARP_PAIRS)."""
    L = n_rows.shape[0]
    pairs = torch.zeros(L, dtype=torch.int64, device=leaf_c.device)
    pairs.scatter_add_(0, leaf_c.reshape(-1), lvalid.reshape(-1).long())
    warps = (pairs + WARP_PAIRS - 1) // WARP_PAIRS * WARP_PAIRS
    tiles = (n_rows.long() + ROW_TILE - 1) // ROW_TILE * ROW_TILE
    return (warps * tiles).sum()


def _check_args(q, q_sq, emb, sq, n_rows, leaf_c, lvalid, metric):
    if q.ndim != 2 or emb.ndim != 3 or q.shape[1] != emb.shape[2]:
        raise ValueError(f"leaf_distances expects q [B, D], emb [L, cap, D]; got {tuple(q.shape)}, {tuple(emb.shape)}")
    B = q.shape[0]
    L, cap = emb.shape[0], emb.shape[1]
    if leaf_c.ndim != 2 or leaf_c.shape[0] != B or lvalid.shape != leaf_c.shape:
        raise ValueError(f"leaf_c and lvalid must be [B, b] with B = {B}; got {tuple(leaf_c.shape)}, {tuple(lvalid.shape)}")
    if n_rows.shape != (L,):
        raise ValueError(f"n_rows must be [L] = [{L}], got {tuple(n_rows.shape)}")
    if metric == "l2":
        if q_sq is None or sq is None or q_sq.shape != (B,) or sq.shape != (L, cap):
            raise ValueError(f"l2 takes q_sq [B] = [{B}] and sq [L, cap] = [{L}, {cap}]")
    elif q_sq is not None or sq is not None:
        raise ValueError(f"q_sq and sq are for l2 alone, not {metric!r}")
    given = [t for t in (q, q_sq, emb, sq) if t is not None]
    if any(t.dtype != torch.float32 for t in given):
        raise TypeError(f"q, q_sq, emb and sq must be float32, got {[t.dtype for t in given]}")
    if n_rows.dtype != torch.int32 or leaf_c.dtype != torch.int64 or lvalid.dtype != torch.bool:
        raise TypeError(f"n_rows int32, leaf_c int64 and lvalid bool expected, got {n_rows.dtype}, "
                        f"{leaf_c.dtype}, {lvalid.dtype}")
    tensors = [*given, n_rows, leaf_c, lvalid]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("leaf_distances takes contiguous tensors")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev} (cuda|cpu)")
    return dev


def leaf_distances(q, q_sq, emb, sq, n_rows, leaf_c, lvalid, metric: str,
                   budget_bytes: int = 2 << 30) -> torch.Tensor:
    """Distances of each query to the rows of its visited leaves: q [B, D]
    prepared queries (unit-normalised for cosine), q_sq [B] and sq [L, cap]
    squared norms (l2 alone, else None), emb [L, cap, D] the leaves padded
    to cap rows (float32), n_rows [L] int32 each leaf's real rows (a
    prefix), leaf_c [B, b] int64 leaf ids in [0, L), lvalid [B, b] bool ->
    [B, b, cap] float32: out[i, j, r] is query i's distance to row r of
    leaf leaf_c[i, j] for r < n_rows in a valid slot; the entries past
    n_rows and in invalid slots hold no distance (the caller masks them).
    ``budget_bytes`` sizes the plain version's blocks of leaves."""
    m = _build.metric_code(metric)
    dev = _check_args(q, q_sq, emb, sq, n_rows, leaf_c, lvalid, metric)
    (B, b), cap = leaf_c.shape, emb.shape[1]
    if leaf_c.numel() == 0:
        return torch.empty((B, b, cap), device=dev)
    if dev.type == "cpu":
        return leaf_distances_ref(q, q_sq, emb, sq, n_rows, leaf_c, lvalid, metric, budget_bytes)
    lib = _build.lib("leaf_distances")
    L, D = emb.shape[0], emb.shape[2]
    perm, first, ends = leaf_work(leaf_c, lvalid, n_rows)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((B, b, cap), device=dev)
    with _build.on(dev):
        err = lib.leaf_distances_launch(
            q.data_ptr(), None if q_sq is None else q_sq.data_ptr(), emb.data_ptr(),
            None if sq is None else sq.data_ptr(), n_rows.data_ptr(), perm.data_ptr(),
            first.data_ptr(), ends.data_ptr(), counter.data_ptr(), out.data_ptr(),
            b, L, cap, D, m, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "leaf_distances")
    with _launches_lock:
        launches["leaf_distances"] += 1
    return out

