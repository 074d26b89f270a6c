"""Public op: ``flash_attention``, the LM prefill's attention.

Dispatch goes by the device of the inputs: tensors on the CPU take the
plain PyTorch version (``ref.flash_attention_ref``), tensors on a CUDA
device launch a hand-written Hopper kernel or raise; there is no switch
that sends CUDA tensors to the plain version.  Which kernel (``route``):
bfloat16 at d = 128 takes the TMA + wgmma kernel
(``csrc/flash_attention_wgmma.cu``), the other bfloat16 widths the
``mma.sync`` kernel and float32 the FMA kernel (both
``csrc/flash_attention.cu``).  ``launches`` counts the calls that launched
each library's kernel (plain integers, bumped only there);
``reset_launches()`` zeroes them.

The launch is the custom op ``torch.ops.repro_torch.flash_attention``:
on CUDA tensors its body launches the kernel; on fake tensors (the dry
run, ``launch/dryrun.py``) its fake kernel only allocates the output and
``FlopCounterMode`` counts 4·B·Hq·Sq·Skv·d operations (half when causal).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from .ref import flash_attention_ref

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
MAX_D = 128
WGMMA_D = 128
# the query tile of each kernel; the grid's second axis holds ceil(Sq / tile) tiles
_BQ = {"wgmma": 128, "mma": 64, "fma": 64}

launches = {"flash_attention": 0, "flash_attention_wgmma": 0}


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call launches: "wgmma" for bfloat16 at d = 128,
    "mma" for the other bfloat16 widths, "fma" for float32."""
    if dtype == torch.bfloat16:
        return "wgmma" if d == WGMMA_D else "mma"
    return "fma"


def loadable(t: torch.Tensor) -> bool:
    """Whether a kernel reads ``t`` [B, H, S, d] in place.  Rows need a
    contiguous last dimension.  The bfloat16 kernels follow TMA's rule (the
    ``mma`` one reads 16 bytes at a time, which asks the same): a 16-byte
    aligned base, and batch, head and sequence strides that are positive
    multiples of 16 bytes (8 elements) wherever the dimension is longer
    than 1.  A fresh contiguous copy always is loadable."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (s > 0 and s % 8 == 0) for n, s in zip(t.shape[:3], t.stride()[:3])
    )


def as_loadable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where a kernel reads it in place, else a contiguous copy."""
    return t if loadable(t) else t.clone(memory_format=torch.contiguous_format)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(q, k, v, kv_lens):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention expects q [B,Hq,Sq,d], k = v [B,Hkv,Skv,d]; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Hq, Sq, d = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[3] != d or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree (batch, d, or Hq % Hkv)")
    if kv_lens is not None and tuple(kv_lens.shape) != (B,):
        raise ValueError(f"kv_lens must be [B] = [{B}], got {tuple(kv_lens.shape)}")


def _launch(kind: str, q, k, v, kv_lens, causal: bool, scale: float):
    """Check what the kernel ``kind`` takes, then launch it on CUDA tensors
    (through the custom op) and count it."""
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q, k, v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    B, Hq, Sq, d = q.shape
    if d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"flash_attention kernel takes d a multiple of 16 up to {MAX_D}, got {d}")
    if -(-Sq // _BQ[kind]) > 65535 or B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention grid too large: B={B}, Hq={Hq}, Sq={Sq}")
    return _flash_op(q, k, v, kv_lens, kind, bool(causal), float(scale))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_lens: Optional[torch.Tensor],
              kind: str, causal: bool, scale: float) -> torch.Tensor:
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    q, k, v = (as_loadable(t) for t in (q, k, v))
    if kv_lens is not None:
        kv_lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, Sq, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lens = None if kv_lens is None else kv_lens.data_ptr()
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "wgmma":
            name = "flash_attention_wgmma"
            err = _build.lib(name).flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lens, out.data_ptr(),
                B, Hq, Hkv, Sq, Skv, *strides, scale, int(causal), stream,
            )
        else:
            name = "flash_attention"
            err = _build.lib(name).flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lens, out.data_ptr(),
                B, Hq, Hkv, Sq, Skv, d, *strides,
                scale, int(causal), DTYPE_CODE[q.dtype], stream,
            )
    _build.check(err, name)
    launches[name] += 1
    return out


@_flash_op.register_fake
def _(q, k, v, kv_lens, kind, causal, scale):
    return q.new_empty(q.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q, k, v, kv_lens, kind, causal, scale, *, out_shape=None) -> int:
    """4·B·Hq·Sq·Skv·d (q kᵀ and p v) from the shapes, halved when causal."""
    B, Hq, Sq, d = q
    n = 4 * B * Hq * Sq * k[2] * d
    return n // 2 if causal else n


def flash_attention(q, k, v, *, kv_lens=None, causal: bool = True, scale: float | None = None):
    """q [B, Hq, Sq, d]; k, v [B, Hkv, Skv, d] -> [B, Hq, Sq, d] float32.

    kv_lens [B] int: per-sequence valid kv length (default: all Skv keys).
    Query head h reads kv head h // (Hq // Hkv); the causal mask aligns the
    last query with the last valid key; a row with no live key is 0.  On a
    CUDA device the inputs are float32 or bfloat16 (one dtype), d is a
    multiple of 16 up to 128, and the last dimension is contiguous.
    """
    _check(q, k, v, kv_lens)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    ts = (q, k, v) if kv_lens is None else (q, k, v, kv_lens)
    if not _build.on_one_cuda_device(*ts):
        return flash_attention_ref(q, k, v, kv_lens=kv_lens, causal=causal, scale=scale)
    return _launch(route(q.dtype, q.shape[-1]), q, k, v, kv_lens, causal, scale)


def flash_attention_mma(q, k, v, *, kv_lens=None, causal: bool = True, scale: float | None = None):
    """The ``csrc/flash_attention.cu`` kernels on CUDA tensors whatever the
    width: for bfloat16 at d = 128 the ``mma.sync`` kernel that the wgmma
    one replaced.  A yardstick that ``chip_smoke.py`` times beside
    ``flash_attention``; the port never calls it."""
    _check(q, k, v, kv_lens)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    ts = (q, k, v) if kv_lens is None else (q, k, v, kv_lens)
    if not _build.on_one_cuda_device(*ts):
        raise ValueError("flash_attention_mma launches a CUDA kernel: the inputs must be on a CUDA device")
    return _launch("mma" if q.dtype == torch.bfloat16 else "fma", q, k, v, kv_lens, causal, scale)
