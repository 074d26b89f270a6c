"""Plain PyTorch versions of the two distance kernels.

They repeat the kernels' arithmetic (float32 accumulation; cosine
normalizes with ``rsqrt(sum(x*x) + 1e-12)`` as the kernels do) and their
selection rule: ascending distance, ties to the lower index, entries that
hold no valid row come back as ``(inf, -1)``.  The wrappers in ``ops.py``
run them for tensors on the CPU; ``chip_smoke.py`` holds each kernel
against them on the card.
"""
from __future__ import annotations

import torch


def _score(q: torch.Tensor, c: torch.Tensor, metric: str) -> torch.Tensor:
    """q [..., B, D], c [..., N, D] (float32) -> [..., B, N] distances."""
    if metric == "cosine":
        q = q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
        c = c * torch.rsqrt(torch.sum(c * c, dim=-1, keepdim=True) + 1e-12)
    s = torch.matmul(q, c.transpose(-1, -2))
    if metric == "ip":
        return -s
    if metric == "l2":
        qn = torch.sum(q * q, dim=-1)[..., :, None]
        cn = torch.sum(c * c, dim=-1)[..., None, :]
        return qn + cn - 2.0 * s
    if metric == "cosine":
        return 1.0 - s
    raise ValueError(f"unknown metric {metric!r}")


def _select(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending top-k of each row of d [R, N], ties to the lower index,
    invalid entries (inf) and entries past N as (inf, -1)."""
    R, N = d.shape
    d = d + 0.0  # -0.0 -> +0.0, as the kernels do
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    out_d = torch.gather(d, 1, order)
    out_i = torch.where(torch.isinf(out_d), -1, order).to(torch.int32)
    if out_d.shape[1] < k:
        pad = k - out_d.shape[1]
        out_d = torch.cat([out_d, d.new_full((R, pad), float("inf"))], dim=1)
        out_i = torch.cat([out_i, out_i.new_full((R, pad), -1)], dim=1)
    return out_d.contiguous(), out_i.contiguous()


def distance_topk_ref(q: torch.Tensor, c: torch.Tensor, k: int, metric: str = "l2"):
    """q [B, D], c [N, D] (float32, bfloat16 or float16) -> (dists [B, k]
    f32, idx [B, k] i32), ascending; (inf, -1) past N."""
    d = _score(q.to(torch.float32), c.to(torch.float32), metric)
    return _select(d, k)


def grouped_distance_topk_ref(
    q, codes, scales, offsets, n_rows, k: int, metric: str = "l2", qformat: str = "int8"
):
    """q [G, D] f32; codes [G, N, D] int8|float16; scales/offsets [G] f32;
    n_rows [G] i32 -> (dists [G, k] f32, idx [G, k] i32); rows past
    n_rows[g] come back as (inf, -1)."""
    G, N = codes.shape[0], codes.shape[1]
    if G == 0 or N == 0:
        return (
            torch.full((G, k), float("inf"), dtype=torch.float32, device=codes.device),
            torch.full((G, k), -1, dtype=torch.int32, device=codes.device),
        )
    c = codes.to(torch.float32)
    if qformat == "int8":
        c = c * scales.to(torch.float32)[:, None, None] + offsets.to(torch.float32)[:, None, None]
    elif qformat != "float16":
        raise ValueError(f"unknown quant format {qformat!r} (int8|float16)")
    d = _score(q.to(torch.float32)[:, None, :], c, metric)[:, 0, :]   # [G, N]
    pad = torch.arange(N, device=d.device)[None, :] >= n_rows.to(d.device).long()[:, None]
    d = torch.where(pad, float("inf"), d)
    return _select(d, k)
