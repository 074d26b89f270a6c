"""Public op: ``flash_attention``, the LM prefill's attention.

Dispatch goes by the device of the inputs: tensors on the CPU take the
plain PyTorch version (``ref.flash_attention_ref``), tensors on a CUDA
device launch the hand-written Hopper kernel (``csrc/flash_attention.cu``)
or raise; there is no switch that sends CUDA tensors to the plain version.
``launches["flash_attention"]`` counts the calls that launched the kernel
(a plain integer, bumped only there); ``reset_launches()`` zeroes it.
"""
from __future__ import annotations

import torch

from .. import _build
from ..distance_topk.ops import _on_one_cuda_device
from .ref import flash_attention_ref

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
MAX_D = 128
# the kernel's query tile; the grid's second axis holds ceil(Sq / 64) tiles
_BQ = 64

launches = {"flash_attention": 0}


def _loadable(t: torch.Tensor) -> bool:
    """The kernels read rows with a contiguous last dimension; the bf16 one
    reads 16 bytes at a time, so its base and batch/head/sequence strides
    must be 16-byte aligned (a fresh contiguous copy always is)."""
    if t.stride(-1) != 1:
        return False
    return t.dtype != torch.bfloat16 or (t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]))


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def flash_attention(q, k, v, *, kv_lens=None, causal: bool = True, scale: float | None = None):
    """q [B, Hq, Sq, d]; k, v [B, Hkv, Skv, d] -> [B, Hq, Sq, d] float32.

    kv_lens [B] int: per-sequence valid kv length (default: all Skv keys).
    Query head h reads kv head h // (Hq // Hkv); the causal mask aligns the
    last query with the last valid key; a row with no live key is 0.  On a
    CUDA device the inputs are float32 or bfloat16 (one dtype), d is a
    multiple of 16 up to 128, and the last dimension is contiguous.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention expects q [B,Hq,Sq,d], k = v [B,Hkv,Skv,d]; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree (batch, d, or Hq % Hkv)")
    if kv_lens is not None and tuple(kv_lens.shape) != (B,):
        raise ValueError(f"kv_lens must be [B] = [{B}], got {tuple(kv_lens.shape)}")
    if scale is None:
        scale = 1.0 / (d**0.5)
    ts = (q, k, v) if kv_lens is None else (q, k, v, kv_lens)
    if not _on_one_cuda_device(*ts):
        return flash_attention_ref(q, k, v, kv_lens=kv_lens, causal=causal, scale=scale)
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q, k, v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"flash_attention kernel takes d a multiple of 16 up to {MAX_D}, got {d}")
    if -(-Sq // _BQ) > 65535 or B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention grid too large: B={B}, Hq={Hq}, Sq={Sq}")
    q, k, v = (t if _loadable(t) else t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
    if kv_lens is not None:
        kv_lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, Sq, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.lib("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_lens is None else kv_lens.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)), DTYPE_CODE[q.dtype], stream,
        )
    _build.check(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
