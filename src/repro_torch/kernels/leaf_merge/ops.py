"""Public op: ``leaf_merge``, packed mode's merge of a scan chunk into the
candidate buffer.

Dispatch goes by the device of the inputs: tensors on the CPU take the
plain PyTorch version (``ref.leaf_merge_ref``: mask, concatenate, a stable
sort), tensors on a CUDA device launch the hand-written kernel
(``csrc/leaf_merge.cu``: each query's best C selected from only the real
rows of its valid slots, read in place) or raise; there is no switch that
sends CUDA tensors to the plain version.  ``launches`` counts the calls
that launched the kernel (a plain integer, bumped there, not while a CUDA
graph is being captured, and by ``add_launch()`` for each replay of a
graph that holds it); ``reset_launches()`` zeroes it.  Every such call is
one launch and no other device work: the kernel sums the slots' rows
itself.
"""
from __future__ import annotations

import threading

import torch

from .. import _build
from .ref import leaf_merge_ref

# the kernel's sort area (keys, a power of two >= C and at least MIN_SORT)
# and its slots' row sums stay in shared memory up to SORT_SMEM keys and
# SLOTS_SMEM slots, and go to a global scratch beyond (kSortSmem and
# kSlotsSmem in csrc/leaf_merge.cu)
MIN_SORT = 2048
SORT_SMEM = 16384
SLOTS_SMEM = 8192

launches = {"leaf_merge": 0}
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        launches["leaf_merge"] = 0


def add_launch() -> None:
    """Count one launch of the kernel: a call of ``leaf_merge`` that ran it,
    or a replay of a CUDA graph that holds it (a capture runs nothing and
    counts nothing)."""
    with _launches_lock:
        launches["leaf_merge"] += 1


def sort_keys(C: int) -> int:
    """The kernel's sort area for a buffer of C: the power of two at least
    max(C, MIN_SORT).  Radix selection stops once the keys up to its bin
    fit there."""
    return 1 << (max(C, MIN_SORT) - 1).bit_length()


def _check_args(buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid):
    if buf_d.ndim != 2 or buf_i.shape != buf_d.shape:
        raise ValueError(f"buf_d and buf_i must be [B, C]; got {tuple(buf_d.shape)}, {tuple(buf_i.shape)}")
    B, C = buf_d.shape
    if d.ndim != 3 or d.shape[0] != B:
        raise ValueError(f"d must be [B, b, cap] with B = {B}; got {tuple(d.shape)}")
    b, cap = d.shape[1], d.shape[2]
    if leaf_c.shape != (B, b) or lvalid.shape != (B, b):
        raise ValueError(f"leaf_c and lvalid must be [B, b] = [{B}, {b}]; got {tuple(leaf_c.shape)}, "
                         f"{tuple(lvalid.shape)}")
    if leaf_ids.ndim != 2 or leaf_ids.shape[1] != cap or n_rows.shape != (leaf_ids.shape[0],):
        raise ValueError(f"leaf_ids must be [L, cap = {cap}] and n_rows [L]; got {tuple(leaf_ids.shape)}, "
                         f"{tuple(n_rows.shape)}")
    if C + b * cap >= 2**31:
        raise ValueError(f"C + b * cap = {C + b * cap} positions: the merge takes fewer than 2^31")
    want = ((buf_d, torch.float32), (buf_i, torch.int64), (d, torch.float32), (leaf_ids, torch.int64),
            (n_rows, torch.int32), (leaf_c, torch.int64), (lvalid, torch.bool))
    if any(t.dtype != dt for t, dt in want):
        raise TypeError("buf_d float32, buf_i int64, d float32, leaf_ids int64, n_rows int32, leaf_c int64 and "
                        f"lvalid bool expected, got {[t.dtype for t, _ in want]}")
    tensors = [t for t, _ in want]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("leaf_merge takes contiguous tensors")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev} (cuda|cpu)")
    return dev


def leaf_merge(buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid):
    """Merge a scan chunk into each query's candidate buffer: buf_d [B, C]
    float32 ascending (+inf pad) and buf_i [B, C] int64 (-1 pad), d [B, b,
    cap] float32 the chunk's distances (``leaf_distances``' output: only
    the real rows of valid slots are read), leaf_ids [L, cap] int64 the
    leaves' item ids, n_rows [L] int32 each leaf's real rows (a prefix),
    leaf_c [B, b] int64 leaf ids in [0, L), lvalid [B, b] bool -> the new
    (buf_d, buf_i) [B, C]: the C smallest of the buffer and those rows,
    ascending, equal distances in the order of the buffer then slot then
    row (-0.0 equal to +0.0), padded with (+inf, -1).  The kernel takes a
    real row whose distance is +inf or NaN for padding too."""
    dev = _check_args(buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid)
    if dev.type == "cpu":
        return leaf_merge_ref(buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid)
    (B, C), (b, cap) = buf_d.shape, d.shape[1:]
    out_d = torch.empty((B, C), device=dev)
    out_i = torch.empty((B, C), dtype=torch.int64, device=dev)
    if B == 0 or C == 0:
        return out_d, out_i
    lib = _build.lib("leaf_merge")
    S = sort_keys(C)
    ends = torch.empty((B, b), dtype=torch.int32, device=dev) if b > SLOTS_SMEM else None
    keys = torch.empty((B, S), dtype=torch.int64, device=dev) if S > SORT_SMEM else None
    with _build.on(dev):
        err = lib.leaf_merge_launch(
            buf_d.data_ptr(), buf_i.data_ptr(), d.data_ptr(), leaf_ids.data_ptr(), n_rows.data_ptr(),
            leaf_c.data_ptr(), lvalid.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            None if ends is None else ends.data_ptr(), None if keys is None else keys.data_ptr(),
            B, C, b, cap, leaf_ids.shape[0], S, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "leaf_merge")
    if not torch.cuda.is_current_stream_capturing():
        add_launch()
    return out_d, out_i
