"""Public ops: ``distance_topk`` and ``grouped_distance_topk``.

Dispatch goes by the device of the inputs: tensors on the CPU take the
plain PyTorch version (``ref.py``), tensors on a CUDA device launch the
hand-written Hopper kernel (``csrc/*.cu``) or raise — there is no switch
that sends CUDA tensors to the plain version.  ``launches`` counts, per op,
the wrapper calls that launched their kernel (plain integers, bumped only
there); ``reset_launches()`` zeroes them.  A call is one count although
``distance_topk``'s full-selection path (k >= N) runs two CUDA kernels, the
distances and then the per-row sort.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .ref import distance_topk_ref, grouped_distance_topk_ref

METRIC_CODE = {"l2": 0, "ip": 1, "cosine": 2}
QFORMAT_CODE = {"int8": 0, "float16": 1}
QFORMAT_DTYPE = {"int8": torch.int8, "float16": torch.float16}
DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

launches = {"distance_topk": 0, "grouped_distance_topk": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def _smem_rows(optin: int, D: int) -> int:
    """Largest power of two of 8-byte keys that fits next to the query."""
    room = optin - (-(-D * 4 // 16) * 16)
    p = 1
    while p * 2 * 8 <= room:
        p *= 2
    return p if p * 8 <= room else 0


def distance_topk(q, c, k: int, metric: str = "l2"):
    """q [B, D], c [N, D] (float32 | bfloat16 | float16 tensors, numpy
    taken as CPU) -> (dists [B, k] float32, idx [B, k] int32) tensors on
    the inputs' device, ascending, ties to the lower index; entries with no
    candidate are (inf, -1).  k >= N takes the kernel's full-selection path
    (distances, then one sort per row)."""
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
    optin = lib.distance_topk_smem_optin()
    if k >= N:  # full selection: one row's keys, nothing else, in shared memory
        cap = _smem_rows(optin, 0)
        if N > cap:
            raise ValueError(f"distance_topk full selection sorts at most {cap} candidates in shared memory, got N={N}")
    else:  # running top-k: query + 2 * max(pow2(k), 256) keys
        keys = 2 * max(1 << (k - 1).bit_length(), 256)
        if keys > _smem_rows(optin, D):
            raise ValueError(f"distance_topk k={k} needs {keys} shared-memory keys, more than fit at D={D}")
    q, c = q.contiguous(), c.contiguous()
    out_d = torch.empty((B, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=q.device)
    scratch = torch.empty((B * N if k >= N else 0,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.distance_topk_launch(
            q.data_ptr(), c.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), scratch.data_ptr(),
            B, N, D, int(k), m, DTYPE_CODE[q.dtype], stream,
        )
    _build.check(err, "distance_topk")
    launches["distance_topk"] += 1
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
    rows = _smem_rows(lib.grouped_smem_optin(), D)
    if N > rows:
        raise ValueError(
            f"grouped_distance_topk holds at most {rows} rows of a leaf in shared memory "
            f"at D={D}; this round's largest leaf has {N}"
        )
    q = q.to(torch.float32).contiguous()
    codes = codes.contiguous()
    scales = scales.to(torch.float32).contiguous()
    offsets = offsets.to(torch.float32).contiguous()
    n_rows = n_rows.to(torch.int32).contiguous()
    out_d = torch.empty((G, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((G, k), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grouped_distance_topk_launch(
            q.data_ptr(), codes.data_ptr(), scales.data_ptr(), offsets.data_ptr(),
            n_rows.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            G, N, D, int(k), m, QFORMAT_CODE[qformat], stream,
        )
    _build.check(err, "grouped_distance_topk")
    launches["grouped_distance_topk"] += 1
    return out_d, out_i
