"""Public ops: ``distance_topk`` and ``grouped_distance_topk``.

Dispatch goes by the device of the inputs: tensors on the CPU take the
plain PyTorch version (``ref.py``), tensors on a CUDA device launch the
hand-written Hopper kernel (``csrc/*.cu``) or raise — there is no switch
that sends CUDA tensors to the plain version.  ``launches`` counts, per op,
the wrapper calls that launched their kernel (plain integers, bumped only
there); ``reset_launches()`` zeroes them.  Every such call is exactly one
CUDA launch.

Both kernels finish their top-k in the last block of a group of blocks
(found by an atomic counter that block resets), through keys in a scratch
buffer.  The scratch and the counters are allocated once per device and
stream and grow when a call needs more (``workspace``); the shared-memory
opt-in is read once per device.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import _build
from .ref import distance_topk_ref, grouped_distance_topk_ref

METRIC_CODE = {"l2": 0, "ip": 1, "cosine": 2}
QFORMAT_CODE = {"int8": 0, "float16": 1}
QFORMAT_DTYPE = {"int8": torch.int8, "float16": torch.float16}
DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

launches = {"distance_topk": 0, "grouped_distance_topk": 0}
_launches_lock = threading.Lock()  # launches come from the serving workers' threads too


def reset_launches() -> None:
    with _launches_lock:
        for name in launches:
            launches[name] = 0


def _count_launch(name: str) -> None:
    with _launches_lock:
        launches[name] += 1


def _metric(metric: str) -> int:
    if metric not in METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r} (l2|ip|cosine)")
    return METRIC_CODE[metric]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _on_one_cuda_device(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (cuda|cpu)")
    return True


# rows of a leaf one block of the grouped kernel scores (kTile in
# csrc/grouped_distance_topk.cu, which checks it)
GROUPED_TILE = 256

_optin: dict = {}       # device index -> largest opt-in shared memory (bytes)
workspaces: dict = {}   # (device index, stream) -> (key lists [bytes] uint8, counters int32)


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _align16(n: int) -> int:
    return -(-n // 16) * 16


# rows one block of the full-selection path scores (kFullRows in
# csrc/distance_topk.cu: two a warp of 16)
FULL_ROWS = 32


def topk_full_plan(N: int, D: int, optin: int) -> int:
    """The full-selection path's blocks per query row (FULL_ROWS rows
    each).  Raises when the last block's sort of the row's keys (pow2 of
    the blocks' rows, 8 bytes a key) or a block's query row does not fit in
    ``optin`` bytes of shared memory."""
    nblk = max(1, -(-N // FULL_ROWS))
    keys = _pow2(nblk * FULL_ROWS) if nblk > 1 else 0
    if keys * 8 > optin:
        raise ValueError(
            f"distance_topk full selection sorts {keys} keys ({keys * 8} B) in one block's shared memory, "
            f"more than the {optin} B a block may have: N={N} is too large"
        )
    if _align16(D * 4) > optin:
        raise ValueError(f"distance_topk: a query row of D={D} does not fit in {optin} B of shared memory")
    return nblk


def grouped_plan(N: int, D: int, k: int, itemsize: int, optin: int) -> tuple[int, int]:
    """The grouped kernel's (tiles per group, keys kept per tile P =
    min(pow2(k), GROUPED_TILE)).  Raises when a block's query, tile keys and
    2-stage ring (16 rows of int8, 8 of float16) do not fit in ``optin``
    bytes of shared memory, or when the last tile's merge does not: it
    merges the pow2(tiles) lists of P keys in the tile's own shared memory
    (at once, or in batches behind a running list of pow2(k) keys) and only
    needs more when pow2(k) is over half of that."""
    tiles = max(1, -(-N // GROUPED_TILE))
    P, cap = min(_pow2(k), GROUPED_TILE), _pow2(k)
    ring = 2 * 16 * D if itemsize == 1 else 2 * 8 * D * itemsize
    tile = _align16(D * 4) + GROUPED_TILE * 8 + ring
    if 128 + tile > optin:
        raise ValueError(
            f"grouped_distance_topk: a block's query, tile keys and ring take {128 + tile} B of shared "
            f"memory at D={D}, more than the {optin} B a block may have"
        )
    merge = _pow2(tiles) * P * 8
    if merge > tile and tile // 8 - cap >= cap:
        merge = 0  # batches behind a running list, in the tile's shared memory
    if 128 + merge > optin:
        raise ValueError(
            f"grouped_distance_topk merges {_pow2(tiles)} tile lists of {P} keys ({128 + merge} B of shared "
            f"memory) at N={N}, k={k}, more than the {optin} B a block may have"
        )
    return tiles, P


def workspace(device: torch.device, key_bytes: int, counters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scratch key lists and zeroed counters for launches on ``device``'s
    current stream, kept and reused; grown (anew, zeroed) when too small.
    The kernels leave every counter at 0.

    Threads that share a stream (the serving scheduler's workers all launch
    on the default stream) share its workspace: their launches run in
    stream order, so one kernel finishes with the scratch and leaves the
    counters at 0 before the next starts.  A workspace that another
    thread's growth replaces stays alive through the caller's reference,
    and the caching allocator hands its memory out again only to work
    queued on the same stream after it."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = workspaces.get(key)
    if ws is None or ws[0].numel() < key_bytes or ws[1].numel() < counters:
        old_b, old_c = (ws[0].numel(), ws[1].numel()) if ws is not None else (0, 0)
        ws = (torch.empty(max(key_bytes, old_b, 1 << 20), dtype=torch.uint8, device=device),
              torch.zeros(max(counters, old_c, 1024), dtype=torch.int32, device=device))
        workspaces[key] = ws
    return ws


def _device_optin(lib, fn: str, device: torch.device) -> int:
    if device.index not in _optin:
        with torch.cuda.device(device):
            _optin[device.index] = getattr(lib, fn)()
    return _optin[device.index]


@contextlib.contextmanager
def _on(device: torch.device):
    """Launch on ``device``: enter it only when it is not the current one."""
    if device.index == torch.cuda.current_device():
        yield
    else:
        with torch.cuda.device(device):
            yield


def distance_topk(q, c, k: int, metric: str = "l2"):
    """q [B, D], c [N, D] (float32 | bfloat16 | float16 tensors, numpy
    taken as CPU) -> (dists [B, k] float32, idx [B, k] int32) tensors on
    the inputs' device, ascending, ties to the lower index; entries with no
    candidate are (inf, -1).  k >= N takes the kernel's full-selection path
    (one launch: blocks of rows sort their keys, the last block of a query
    row finishes the sort of them all)."""
    q, c = _as_tensor(q), _as_tensor(c)
    m = _metric(metric)
    if q.ndim != 2 or c.ndim != 2 or q.shape[1] != c.shape[1]:
        raise ValueError(f"distance_topk expects q [B, D], c [N, D]; got {tuple(q.shape)}, {tuple(c.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not _on_one_cuda_device(q, c):
        return distance_topk_ref(q, c, k, metric)
    if q.dtype != c.dtype or q.dtype not in DTYPE_CODE:
        raise TypeError(f"distance_topk kernel takes float32/float16/bfloat16 q and c of one dtype, got {q.dtype}, {c.dtype}")
    lib = _build.lib("distance_topk")
    B, D = q.shape
    N = c.shape[0]
    dev = q.device
    optin = _device_optin(lib, "distance_topk_smem_optin", dev)
    nblk = 0
    if k >= N:  # full selection: one launch, the last block of a row sorts
        nblk = topk_full_plan(N, D, optin)
    else:  # running top-k: query + 2 * max(pow2(k), 256) keys
        keys = 2 * max(_pow2(k), 256)
        if _align16(D * 4) + keys * 8 > optin:
            raise ValueError(f"distance_topk k={k} needs {keys} shared-memory keys, more than fit at D={D}")
    q, c = q.contiguous(), c.contiguous()
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    keys, counters = workspace(dev, B * nblk * FULL_ROWS * 8, B)
    with _on(dev):
        err = lib.distance_topk_launch(
            q.data_ptr(), c.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), keys.data_ptr(),
            counters.data_ptr(), B, N, D, int(k), m, DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "distance_topk")
    _count_launch("distance_topk")
    return out_d, out_i


def grouped_distance_topk(
    q, codes, scales, offsets, n_rows, k: int, metric: str = "l2", qformat: str = "int8"
):
    """One launch for a whole traversal round: group g scores q[g] against
    its leaf's quantized codes[g].  q [G, D] f32; codes [G, N, D] int8 |
    float16; scales/offsets [G] f32; n_rows [G] i32 -> numpy (dists [G, k]
    f32, idx [G, k] i32), ascending; rows past n_rows[g] are (inf, -1)."""
    d, i = grouped_distance_topk_tensors(q, codes, scales, offsets, n_rows, k, metric, qformat)
    return d.cpu().numpy(), i.cpu().numpy()


def grouped_distance_topk_tensors(
    q, codes, scales, offsets, n_rows, k: int, metric: str = "l2", qformat: str = "int8"
):
    """``grouped_distance_topk`` with the results left as tensors on the
    inputs' device (no device-to-host copy, no synchronisation)."""
    q, codes = _as_tensor(q), _as_tensor(codes)
    scales, offsets, n_rows = _as_tensor(scales), _as_tensor(offsets), _as_tensor(n_rows)
    m = _metric(metric)
    if qformat not in QFORMAT_CODE:
        raise ValueError(f"unknown quant format {qformat!r} (int8|float16)")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not _on_one_cuda_device(q, codes, scales, offsets, n_rows):
        return grouped_distance_topk_ref(q, codes, scales, offsets, n_rows, k, metric, qformat)
    G, N, D = codes.shape
    if q.shape != (G, D):
        raise ValueError(f"q must be [G, D] = [{G}, {D}], got {tuple(q.shape)}")
    for name, t in (("scales", scales), ("offsets", offsets), ("n_rows", n_rows)):
        if t.shape != (G,):
            raise ValueError(f"{name} must be [G] = [{G}], got {tuple(t.shape)}")
    if codes.dtype != QFORMAT_DTYPE[qformat]:
        raise TypeError(f"codes must be {QFORMAT_DTYPE[qformat]} for qformat {qformat!r}, got {codes.dtype}")
    lib = _build.lib("grouped_distance_topk")
    dev = q.device
    tiles, P = grouped_plan(N, D, k, codes.element_size(),
                            _device_optin(lib, "grouped_smem_optin", dev))
    q = q.to(torch.float32).contiguous()
    codes = codes.contiguous()
    scales = scales.to(torch.float32).contiguous()
    offsets = offsets.to(torch.float32).contiguous()
    n_rows = n_rows.to(torch.int32).contiguous()
    out_d = torch.empty((G, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((G, k), dtype=torch.int32, device=dev)
    lists, counters = workspace(dev, G * tiles * P * 8, G)
    with _on(dev):
        err = lib.grouped_distance_topk_launch(
            q.data_ptr(), codes.data_ptr(), scales.data_ptr(), offsets.data_ptr(),
            n_rows.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), lists.data_ptr(),
            counters.data_ptr(), G, N, D, int(k), m, QFORMAT_CODE[qformat], GROUPED_TILE,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "grouped_distance_topk")
    _count_launch("grouped_distance_topk")
    return out_d, out_i
