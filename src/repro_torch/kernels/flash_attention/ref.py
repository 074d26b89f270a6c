"""Plain PyTorch versions for flash attention (GQA-aware, causal, length-masked).

* ``mha_ref`` is the reference's oracle (``repro.kernels.flash_attention.ref``)
  as it is: a row with no live key comes out NaN.  ``attention(impl="full")``
  uses it.
* ``flash_attention_ref`` computes what the Hopper kernels
  (``csrc/flash_attention_wgmma.cu``, ``csrc/flash_attention.cu``) and the
  TPU kernel they replace compute:
  float32 arithmetic from the inputs cast to float32, ``scale`` applied to q
  first, query head h reading kv head ``h // (Hq // Hkv)``, per-batch
  ``kv_lens``, the last query aligned to the last valid key
  (``q_end_offset = kv_len - Sq``), float32 output, and 0 for a row with no
  live key.  ``ops.flash_attention`` runs it for CPU tensors;
  ``chip_smoke.py`` holds the kernels against it on the card.  It
  materializes the ``[B, Hq, Sq, Skv]`` scores.
"""
from __future__ import annotations

import torch


def _live(Sq: int, Skv: int, kv_lens, causal: bool, B: int, device) -> torch.Tensor:
    """[B, 1, Sq, Skv] bool: key j is live for query i."""
    kv_idx = torch.arange(Skv, device=device)[None, None, None, :]
    end = (
        kv_lens.to(device=device, dtype=torch.int64)[:, None, None, None]
        if kv_lens is not None
        else torch.full((B, 1, 1, 1), Skv, dtype=torch.int64, device=device)
    )
    live = kv_idx < end
    if causal:
        q_idx = torch.arange(Sq, device=device)[None, None, :, None]
        live = live & (kv_idx <= q_idx + (end - Sq))
    return live


def mha_ref(q, k, v, *, causal: bool = True, kv_lens=None, scale: float | None = None):
    """q [B, Hq, Sq, d]; k, v [B, Hkv, Skv, d]; kv_lens [B] or None.

    GQA: Hq must be a multiple of Hkv; query head h attends kv head
    h // (Hq // Hkv).  Causal alignment: the LAST query aligns with the last
    valid kv position (decode convention).  Returns [B, Hq, Sq, d] float32.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    q = q.to(torch.float32)
    k = torch.repeat_interleave(k.to(torch.float32), group, dim=1)
    v = torch.repeat_interleave(v.to(torch.float32), group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    kv_idx = torch.arange(Skv, device=q.device)[None, None, None, :]
    if kv_lens is not None:
        end = kv_lens.to(q.device)[:, None, None, None]
        s = torch.where(kv_idx < end, s, -torch.inf)
    else:
        end = Skv
    if causal:
        q_idx = torch.arange(Sq, device=q.device)[None, None, :, None]
        # last query aligns with last valid kv position
        s = torch.where(kv_idx <= (q_idx + (end - Sq)), s, -torch.inf)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def flash_attention_ref(q, k, v, *, kv_lens=None, causal: bool = True, scale: float | None = None):
    """The kernel's function in plain torch: q [B, Hq, Sq, d]; k, v
    [B, Hkv, Skv, d] (float32 or bfloat16); kv_lens [B] int or None ->
    [B, Hq, Sq, d] float32; a row with no live key is 0."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    q32 = q.to(torch.float32) * scale
    k32 = torch.repeat_interleave(k.to(torch.float32), group, dim=1)
    v32 = torch.repeat_interleave(v.to(torch.float32), group, dim=1)
    live = _live(Sq, Skv, kv_lens, causal, B, q.device)
    s = torch.where(live, torch.matmul(q32, k32.transpose(-1, -2)), -torch.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(live, torch.exp(s - safe_m), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    return torch.matmul(p, v32) / torch.where(l == 0.0, torch.ones_like(l), l)
