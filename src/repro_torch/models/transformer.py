"""Decoder-only LM family on one device: dense GQA transformers and top-1 MoE variants.

The reference's model (``repro.models.transformer``) as plain functions over
a parameter dict: RoPE, SwiGLU, GQA, optional QKV bias, optional MoE FFN
(every layer, or alternating dense and MoE layers: ``moe_every=2``).  The
serving path is ``prefill`` (the prompt, attention by ``cfg.attn_impl``:
``"flash"`` runs the Hopper kernel in every layer) and then ``decode_step``
(one token, chunked attention over the cache, as the reference does on one
device), or ``retrieval_decode_step`` (one token, eCP retrieval attention
over a clustered cache: ``retrieval_attention.py``).

Parameters: ``{"embed": [V, D], "layers": [per-layer dict] * n_layers,
"final_norm": [D], "lm_head": [D, V]}``; the reference stacks the layers
as ``[L, ...]`` arrays (with ``moe_every=2`` as ``{"dense", "moe"}``
stacks of ``L / 2`` blocks) and scans them, the port keeps them apart and
loops, a block's dense layer before its MoE layer.  Every entry point
casts the weights to ``cfg.dtype`` where it uses them, inside the autograd
graph, as the reference's ``_cast_layers`` and per-use ``.astype`` do: a
layer's weights on entry to the layer, the embedding rows after the
lookup, ``final_norm`` and ``lm_head`` at their use.  Training holds
float32 master weights (``init_params(..., dtype=cfg.param_dtype)``);
serving holds them already in ``cfg.dtype`` (the default of
``init_params`` and ``base.params_from_jax``), where each cast is a no-op.

Training: ``lm_loss`` (next-token cross entropy plus the MoE aux loss)
through torch autograd; with ``cfg.remat`` each layer is a
``torch.utils.checkpoint`` region (the reference's ``jax.checkpoint`` on
its scan body), and chunked attention checkpoints its query blocks.

On a mesh (``ShardingRules`` naming its axes and carrying the
``DeviceMesh``) every entry point takes and returns this rank's shards,
cut by the partition specs of ``param_specs`` (``launch.mesh``), and makes
the reference's sharding constraints explicit collectives
(``distributed.collectives``):

* sequence parallelism (``seq == model``: the train and prefill cells):
  the residual stream is sharded over the sequence; each layer
  all-gathers it on entry, runs its rank's query heads (whole heads,
  ``torch.chunk``'s cut of Hq, so a rank may hold none and then launches
  no attention) against every kv head (replicated), and reduce-scatters
  the row-parallel ``wo`` and ``w_down`` products back; MoE layers run
  ``moe_ffn_ep``.  The vocabulary-sharded embedding is a masked lookup
  reduce-scattered over the sequence; the loss's logits stay
  sequence-sharded against the gathered ``lm_head``.
* pure FSDP (no "model" rule: the dense train cells on one pod): every
  weight is gathered at use, its gradient reduce-scattered by the
  gather's backward; each rank runs the one-device layer on its batch.
* decode (``model`` without ``seq``): tensor-parallel projections with
  their activations gathered (a token a sequence) and ``flash_decode_sharded``
  over the cache's sequence slice, or ``retrieval_update_and_attend_sharded``
  over its clusters.
* ``fsdp_axis``: the weights' other axes, gathered at use.

A loss on a mesh is the sum of the ranks' shares (``collectives.total``),
so autograd on each rank gives that rank's part of the gradient; the
train step (``launch.cells.make_train_step``) sums a weight's gradient
over the axes it is replicated on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed import collectives as C
from ..launch.mesh import axes_of, axis_index, axis_size, chunk_range, placements
from .attention import attention, flash_decode_sharded
from .base import ParamSpec as P
from .base import init_params as _init_params
from .layers import rms_norm, rope, softmax_xent, swiglu
from .moe import MoEConfig, moe_ffn, moe_ffn_ep
from .retrieval_attention import (
    ClusteredKVCache,
    RetrievalAttnConfig,
    clustered_cache_update,
    retrieval_decode_attention,
    retrieval_update_and_attend_sharded,
)

__all__ = [
    "LMConfig", "ShardingRules", "KVCache", "param_specs", "decay_mask", "stacked_groups", "init_params",
    "forward", "lm_loss", "prefill", "decode_step", "retrieval_decode_step", "init_cache",
]


@dataclass(frozen=True)
class ShardingRules:
    """The reference's logical-axis -> mesh-axis mapping, and the mesh.

    ``batch``: the axes the batch shards over; ``model``: the tensor and
    expert axis; ``seq``: the sequence axis (equal to ``model``: Megatron
    sequence parallelism).  The reference reads the ambient mesh; the port
    carries it in ``mesh``, which rules naming an axis need before an
    entry point runs (``launch.cells.lower_cell`` binds a cell's)."""

    batch: tuple = ()
    model: str | None = None
    seq: str | None = None
    mesh: Any = field(default=None, compare=False)

    @staticmethod
    def null() -> "ShardingRules":
        return ShardingRules()

    @property
    def sharded(self) -> bool:
        return bool(self.batch) or self.model is not None or self.seq is not None

    def spec(self, *axes) -> tuple:
        """The partition spec of logical axes: "B" batch, "M" model, "S"
        sequence, anything else unsharded."""
        out = []
        for a in axes:
            if a == "B":
                out.append((self.batch[0] if len(self.batch) == 1 else tuple(self.batch)) if self.batch else None)
            elif a == "M":
                out.append(self.model)
            elif a == "S":
                out.append(self.seq)
            else:
                out.append(None)
        return tuple(out)

    def shard(self, x, *axes):
        """``x`` (a ``DTensor`` on ``mesh``) laid out by ``spec(*axes)``, the
        reference's sharding constraint; with no axis named, ``x`` itself."""
        if not self.sharded:
            return x
        return x.redistribute(_mesh(self), placements(self.mesh, self.spec(*axes)))


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    max_seq: int = 4096
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    moe: MoEConfig | None = None
    moe_every: int = 1              # 2 => alternate dense/MoE layers (Llama-4)
    retrieval: RetrievalAttnConfig = field(default_factory=RetrievalAttnConfig)
    attn_impl: str = "chunked"      # full | chunked | flash
    attn_chunk: int = 1024
    remat: bool = True              # training: recompute each layer in the backward pass
    fsdp_axis: Any = None           # mesh axis (or tuple) to ZeRO-3 shard params over: pspecs only
    pure_fsdp: bool = False         # no tensor parallelism (FSDP-only layout): pspecs only
    microbatches: int = 1           # gradient-accumulation chunks per step

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


def _sharded(rules) -> bool:
    return rules is not None and rules.sharded


def _mesh(rules):
    if rules.mesh is None:
        raise ValueError(f"sharding rules {rules.spec('B', 'M', 'S')} name mesh axes but carry no mesh: "
                         "pass ShardingRules(..., mesh=...) (launch.cells.lower_cell binds a cell's)")
    return rules.mesh


# ------------------------------------------------------------------ params
def _layer_specs(cfg: LMConfig, *, moe: bool) -> dict:
    """Specs of one layer with a dense or an MoE FFN.  Each ``pspec`` is
    the reference's for its stacked ``[L, ...]`` leaf without the leading
    ``None`` of the layer axis."""
    D, F = cfg.d_model, cfg.d_ff
    pdt = cfg.param_dtype
    fs = cfg.fsdp_axis  # None -> replicate the non-"model" big dim
    tp = None if cfg.pure_fsdp else "model"   # pure FSDP: no TP axis at all
    layers: dict[str, P] = {
        "attn_norm": P((D,), pdt, (None,), "ones"),
        "wq": P((D, cfg.q_dim), pdt, (fs, tp)),
        "wk": P((D, cfg.kv_dim), pdt, (fs, tp)),
        "wv": P((D, cfg.kv_dim), pdt, (fs, tp)),
        "wo": P((cfg.q_dim, D), pdt, (tp, fs)),
        "ffn_norm": P((D,), pdt, (None,), "ones"),
    }
    if cfg.qkv_bias:
        layers["bq"] = P((cfg.q_dim,), pdt, (tp,), "zeros")
        layers["bk"] = P((cfg.kv_dim,), pdt, (tp,), "zeros")
        layers["bv"] = P((cfg.kv_dim,), pdt, (tp,), "zeros")
    if not moe:
        layers["w_gate"] = P((D, F), pdt, (fs, tp))
        layers["w_up"] = P((D, F), pdt, (fs, tp))
        layers["w_down"] = P((F, D), pdt, (tp, fs))
    else:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff
        layers["router"] = P((D, E), pdt, (fs, None))
        layers["we_gate"] = P((E, D, Fe), pdt, ("model", fs, None))
        layers["we_up"] = P((E, D, Fe), pdt, ("model", fs, None))
        layers["we_down"] = P((E, Fe, D), pdt, ("model", fs, None))
    return layers


def _is_block(cfg: LMConfig) -> bool:
    return cfg.moe is not None and cfg.moe_every == 2


def _moe_layers(cfg: LMConfig) -> list[bool]:
    """Whether each layer's FFN is an MoE, in the port's layer order (with
    ``moe_every=2``, each block's dense layer, then its MoE layer)."""
    if cfg.moe is None:
        return [False] * cfg.n_layers
    if cfg.moe_every not in (1, 2):
        raise ValueError("moe_every must be 1 or 2")
    if not _is_block(cfg):
        return [True] * cfg.n_layers
    if cfg.n_layers % 2:
        raise ValueError("moe_every=2 needs an even layer count")
    return [i % 2 == 1 for i in range(cfg.n_layers)]


def param_specs(cfg: LMConfig):
    pdt = cfg.param_dtype
    fs = cfg.fsdp_axis
    V, D = cfg.vocab, cfg.d_model
    # pure FSDP: embed and lm_head shard their D dim (vocabularies such as
    # phi4's 200064 do not divide the mesh)
    embed_ps, head_ps = ((None, fs), (fs, None)) if cfg.pure_fsdp else (("model", fs), (fs, "model"))
    return {
        "embed": P((V, D), pdt, embed_ps, "embed"),
        "layers": [_layer_specs(cfg, moe=m) for m in _moe_layers(cfg)],
        "final_norm": P((D,), pdt, (None,), "ones"),
        "lm_head": P((D, V), pdt, head_ps),
    }


def decay_mask(cfg: LMConfig) -> dict:
    """The leaves AdamW decays, as it decays the reference's: those the
    reference holds with ndim >= 2.  It stacks each layer's leaves as
    ``[L, ...]``, so it decays the layers' norm gains and biases too; of the
    1-D leaves only ``final_norm`` is left undecayed."""
    return {"embed": True, "final_norm": False, "lm_head": True,
            "layers": [{k: True for k in lp} for lp in param_specs(cfg)["layers"]]}


def stacked_groups(cfg: LMConfig) -> dict:
    """Each leaf's key in the reference's stacked layout: the per-layer
    leaves of one weight share the key of the reference's ``[L, ...]`` leaf
    (with ``moe_every=2``, of its "dense" or its "moe" stack).  Gradient
    compression scales each such group as the reference scales its leaf."""
    out = {k: k for k in ("embed", "final_norm", "lm_head")}
    out["layers"] = [{k: f"{('moe' if m else 'dense') if _is_block(cfg) else 'layers'}/{k}" for k in lp}
                     for m, lp in zip(_moe_layers(cfg), param_specs(cfg)["layers"])]
    return out


def init_params(cfg: LMConfig, generator: torch.Generator, *, device="cuda", dtype=None):
    """Random weights from ``generator`` on ``device``, stored in ``dtype``:
    ``cfg.dtype`` by default (serving), ``cfg.param_dtype`` for training's
    master weights."""
    return _init_params(param_specs(cfg), generator, device=device, dtype=dtype or cfg.dtype)


# ----------------------------------------------------------------- forward
def _qkv(h, lp, cfg: LMConfig, positions):
    B, S, _ = h.shape
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(h2, lp, cfg: LMConfig):
    """The layer's FFN on h2 [B, S, D]: (y, the MoE aux loss, 0.0 if dense)."""
    if "router" not in lp:
        return swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0
    B, S, D = h2.shape
    y, aux = moe_ffn(h2.reshape(B * S, D), lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], cfg.moe)
    return y.reshape(B, S, D), aux


def _cast(lp: dict, dtype) -> dict:
    return {k: w.to(dtype) for k, w in lp.items()}


def _layer(x, lp, cfg: LMConfig, positions):
    """One transformer layer; also returns its k, v [B, Hkv, S, dh] and
    its aux loss."""
    B, S, _ = x.shape
    lp = _cast(lp, x.dtype)
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = _qkv(h, lp, cfg, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    o = attention(q.transpose(1, 2), k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                  remat=cfg.remat)
    o = o.transpose(1, 2).reshape(B, S, cfg.q_dim).to(x.dtype)    # [B, S, Hq*dh]
    x = x + o @ lp["wo"]
    h2 = rms_norm(x, lp["ffn_norm"])
    y, aux = _ffn(h2, lp, cfg)
    return x + y, k, v, aux


def _embed(params, tokens, cfg: LMConfig):
    """The rows of ``tokens``, cast after the lookup (``F.embedding``: its
    backward on CUDA sorts the ids and sums each row's repeats in a fixed
    order, so a training step replays bit for bit)."""
    return F.embedding(tokens, params["embed"]).to(cfg.dtype)


def _head(params, x):
    """Final norm and the vocabulary projection: logits in float32."""
    x = rms_norm(x, params["final_norm"].to(x.dtype))
    return (x @ params["lm_head"].to(x.dtype)).to(torch.float32)


def _train_layer(x, lp, cfg: LMConfig, positions):
    x, _, _, aux = _layer(x, lp, cfg, positions)
    return x, aux


def forward(params, tokens, cfg: LMConfig, rules: ShardingRules | None = None):
    """tokens [B, S] int -> (logits [B, S, V] float32, the layers' summed
    MoE aux loss, float32).  Under grad with ``cfg.remat`` each layer is a
    checkpoint region: the backward pass recomputes it from its input."""
    if _sharded(rules):
        return _forward_sharded(params, tokens, cfg, rules)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if ckpt:
            x, a = checkpoint(_train_layer, x, lp, cfg, positions, use_reentrant=False)
        else:
            x, a = _train_layer(x, lp, cfg, positions)
        aux = aux + a
    return _head(params, x), aux


def lm_loss(params, batch, cfg: LMConfig, rules: ShardingRules | None = None):
    """batch: {"tokens": [B, S]} -> (next-token cross entropy + MoE aux,
    {"xent", "aux"})."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens[:, :-1], cfg, rules)
    if not _sharded(rules):
        xent = softmax_xent(logits, tokens[:, 1:])
        return xent + aux, {"xent": xent, "aux": aux}
    return _loss_shares(logits, aux, tokens[:, 1:], cfg, rules)


# ------------------------------------------------------------------ serving
@dataclass
class KVCache:
    k: torch.Tensor   # [L, B, Hkv, Smax, dh] in cfg.dtype
    v: torch.Tensor
    pos: int          # tokens written so far


def init_cache(cfg: LMConfig, batch: int, max_seq: int | None = None, *, device="cuda") -> KVCache:
    S = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, cfg.d_head)
    dev = resolve_device(device)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        pos=0,
    )


def prefill(params, tokens, cfg: LMConfig, rules: ShardingRules | None = None, *, max_seq: int | None = None):
    """Run the prompt; return (last-position logits [B, V] float32, filled
    KVCache).  The cache holds ``max_seq`` positions (default
    ``max(cfg.max_seq, S)``), zeros past the prompt."""
    B, S = tokens.shape
    Smax = max_seq or max(cfg.max_seq, S)
    if _sharded(rules):
        return _prefill_sharded(params, tokens, cfg, rules, Smax)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, Smax, cfg.d_head)
    kall = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    vall = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, k, v, _ = _layer(x, lp, cfg, positions)
        kall[i, :, :, :S] = k
        vall[i, :, :, :S] = v
    logits = _head(params, x[:, -1])
    return logits, KVCache(k=kall, v=vall, pos=S)


def _decode_layer(x, lp, cfg: LMConfig, positions, attend):
    """One layer on one new token per sequence.  ``attend(q, k, v)`` (each
    [B, H, dh]) writes k and v into the layer's cache and returns the
    attention output [B, Hq, dh] in float32."""
    B = x.shape[0]
    lp = _cast(lp, x.dtype)
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = _qkv(h, lp, cfg, positions)                           # [B, 1, H, dh]
    o = attend(q[:, 0], k[:, 0], v[:, 0])
    x = x + o.reshape(B, 1, cfg.q_dim).to(x.dtype) @ lp["wo"]
    h2 = rms_norm(x, lp["ffn_norm"])
    y, _ = _ffn(h2, lp, cfg)
    return x + y


def _attend_cache(q, k, v, kc, vc, pos, kv_lens):
    kc[:, :, pos] = k.to(kc.dtype)
    vc[:, :, pos] = v.to(vc.dtype)
    return attention(q[:, :, None], kc, vc, causal=True, kv_lens=kv_lens, impl="chunked")[:, :, 0]


def decode_step(params, cache: KVCache, tokens, cfg: LMConfig, rules: ShardingRules | None = None):
    """One token per sequence. tokens [B] -> (logits [B, V] float32, cache).

    Unlike the reference, which returns a new cache, the new token's k and v
    are written into ``cache``'s tensors in place (a copy of a 32k-token
    cache a step would double its memory); the returned cache shares them,
    with ``pos`` one further.
    """
    if _sharded(rules):
        return _decode_sharded(params, cache, tokens, cfg, rules)
    B = tokens.shape[0]
    pos = cache.pos
    if pos >= cache.k.shape[3]:
        raise ValueError(f"the cache holds {cache.k.shape[3]} positions, all written")
    x = _embed(params, tokens[:, None], cfg)                        # [B, 1, D]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    kv_lens = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x = _decode_layer(x, lp, cfg, positions, partial(_attend_cache, kc=cache.k[i], vc=cache.v[i],
                                                         pos=pos, kv_lens=kv_lens))
    logits = _head(params, x[:, 0])
    return logits, KVCache(k=cache.k, v=cache.v, pos=pos + 1)


def _attend_retrieval(q, k, v, kc, vc, cent, pos, cfg: LMConfig):
    cs = cfg.retrieval.cluster_size
    clustered_cache_update(kc, vc, cent, k, v, pos, cs)
    return retrieval_decode_attention(q, kc, vc, cent, pos + 1, cs=cs, top_b=cfg.retrieval.top_clusters)


def retrieval_decode_step(params, cache: ClusteredKVCache, tokens, cfg: LMConfig,
                          rules: ShardingRules | None = None):
    """Long-context decode with eCP retrieval attention (the paper's
    technique).  tokens [B] -> (logits [B, V] float32, cache).

    As ``decode_step``, the token's k and v and its cluster's centroid are
    written into ``cache``'s tensors in place, and the returned cache shares
    them with ``pos`` one further.
    """
    if _sharded(rules):
        return _decode_sharded(params, cache, tokens, cfg, rules)
    B = tokens.shape[0]
    pos = cache.pos
    nC, cs = cache.k.shape[3], cache.k.shape[4]
    if pos >= nC * cs:
        raise ValueError(f"the clustered cache holds {nC * cs} positions, all written")
    x = _embed(params, tokens[:, None], cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x = _decode_layer(x, lp, cfg, positions, partial(_attend_retrieval, kc=cache.k[i], vc=cache.v[i],
                                                         cent=cache.centroids[i], pos=pos, cfg=cfg))
    logits = _head(params, x[:, 0])
    return logits, ClusteredKVCache(k=cache.k, v=cache.v, centroids=cache.centroids, pos=pos + 1)


# ------------------------------------------------------------- on a mesh
def _sp_on(rules: ShardingRules) -> bool:
    """Megatron sequence-parallel mode: residuals seq-sharded on 'model'."""
    return rules.model is not None and rules.seq == rules.model


def _tp(rules: ShardingRules) -> tuple[int, int]:
    """(size, this rank's index) of the tensor-parallel axis; (1, 0) without one."""
    if rules.model is None:
        return 1, 0
    return axis_size(rules.mesh, rules.model), axis_index(rules.mesh, rules.model)


def _use1(w, spec, rules: ShardingRules, keep):
    """The weight ``w`` gathered over every mesh axis its partition spec
    names but ``keep`` (the tensor-parallel axis, or None): FSDP's gather
    at use, whose backward reduce-scatters the gradient."""
    for dim, e in enumerate(spec.pspec):
        axes = axes_of(e)
        if keep in axes and len(axes) > 1:
            raise ValueError(f"dim {dim} of {spec.shape} shards over {axes}: the tensor-parallel axis and others")
        if axes and keep not in axes:
            w = C.gather(w, rules.mesh, axes, dim, spec.shape[dim])
    return w


def _use(lp: dict, specs: dict, rules: ShardingRules, keep) -> dict:
    return {name: _use1(w, specs[name], rules, keep) for name, w in lp.items()}


def _heads(cfg: LMConfig, rules: ShardingRules) -> tuple[int, int]:
    """This rank's query heads (lo, hi): ``torch.chunk``'s cut of Hq over the
    tensor-parallel axis, ceil(Hq / size) a rank, the last ranks short or empty."""
    return chunk_range(cfg.n_heads, *_tp(rules))


def _head_part(w, cfg: LMConfig, rules: ShardingRules, dim: int):
    """The part of ``w`` (wq's columns, wo's rows, bq) for this rank's query
    heads: its own shard where the heads split evenly (then they cut the q
    dimension as the shards do), else cut from the whole gathered over the
    tensor-parallel axis."""
    h_lo, h_hi = _heads(cfg, rules)
    dh = cfg.d_head
    if cfg.n_heads % _tp(rules)[0] == 0:     # on every rank alike: the gather is a collective
        return w
    whole = C.gather(w, rules.mesh, rules.model, dim, cfg.q_dim)
    return whole.narrow(dim, h_lo * dh, (h_hi - h_lo) * dh)


def _kv_for_heads(k, v, h_lo: int, H: int, group: int):
    """k, v [B, Hkv, S, dh] for the query heads h_lo .. h_lo + H: the kv
    heads they read (``h // group``), as a slice where the heads hold whole
    groups, else repeated to one a query head."""
    if h_lo % group == 0 and H % group == 0:
        return k[:, h_lo // group:(h_lo + H) // group], v[:, h_lo // group:(h_lo + H) // group]
    idx = torch.div(h_lo + torch.arange(H, device=k.device), group, rounding_mode="floor")
    return k.index_select(1, idx), v.index_select(1, idx)


def _embed_tp(embed, tokens, cfg: LMConfig, rules: ShardingRules, spec):
    """This rank's part of the embedding rows of ``tokens`` [B, S]: the rows
    of its vocabulary shard, zeros for the others (sum over the
    tensor-parallel axis to get them all)."""
    E = _use1(embed, spec, rules, rules.model)
    lo, hi = chunk_range(cfg.vocab, *_tp(rules))
    inside = (tokens >= lo) & (tokens < hi)
    if hi == lo:
        return torch.zeros(tokens.shape + (cfg.d_model,), dtype=cfg.dtype, device=tokens.device)
    rows = F.embedding(torch.where(inside, tokens - lo, 0), E).to(cfg.dtype)
    return torch.where(inside[..., None], rows, torch.zeros((), dtype=cfg.dtype, device=rows.device))


def _head_tp(params, x, specs, rules: ShardingRules):
    """Logits [..., V] float32 of rows ``x`` that every rank of the
    tensor-parallel axis holds alike: each rank's vocabulary columns, gathered."""
    W = _use1(params["lm_head"], specs["lm_head"], rules, rules.model)
    x = rms_norm(x, params["final_norm"].to(x.dtype))
    logits = (x @ W.to(x.dtype)).to(torch.float32)
    return C.gather(logits, rules.mesh, rules.model, -1, specs["lm_head"].shape[1]) if rules.model else logits


def _sp_layer(x, lp, specs, cfg: LMConfig, rules: ShardingRules, positions):
    """One layer on this rank's piece of the sequence, x [B, S_loc, D]:
    all-gather the sequence, this rank's query heads against every kv
    head, reduce-scatter the row-parallel products.  Returns (x, k, v
    [B, Hkv, S, dh] whole, aux)."""
    mesh, ax = rules.mesh, rules.model
    B, S = positions.shape
    dh = cfg.d_head
    lp = _use(_cast(lp, x.dtype), specs, rules, ax)     # cast first: the gathers move cfg.dtype
    h_lo, h_hi = _heads(cfg, rules)
    H = h_hi - h_lo
    h = C.gather(rms_norm(x, lp["attn_norm"]), mesh, ax, 1, S)                 # all-gather seq
    q = h @ _head_part(lp["wq"], cfg, rules, 1)
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q = q + _head_part(lp["bq"], cfg, rules, 0)
        k = k + lp["bk"]
        v = v + lp["bv"]
    # kv heads replicate: every rank's query heads read them
    k = C.gather(k, mesh, ax, -1, cfg.kv_dim).reshape(B, S, cfg.n_kv_heads, dh)
    v = C.gather(v, mesh, ax, -1, cfg.kv_dim).reshape(B, S, cfg.n_kv_heads, dh)
    q = rope(q.reshape(B, S, H, dh), positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)
    kh, vh = _kv_for_heads(k, v, h_lo, H, cfg.n_heads // cfg.n_kv_heads)
    if H:
        o = attention(q.transpose(1, 2), kh, vh, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                      remat=cfg.remat)
    else:   # no head on this rank: no attention; the empty q, k, v still reach the
        # output, so that the backward pass runs their gathers' transposes on every rank
        o = q.transpose(1, 2) + kh + vh
    o = o.transpose(1, 2).reshape(B, S, H * dh).to(x.dtype)
    x = x + C.scatter(o @ _head_part(lp["wo"], cfg, rules, 0), mesh, ax, 1)      # reduce-scatter
    h2 = C.gather(rms_norm(x, lp["ffn_norm"]), mesh, ax, 1, S)
    if "router" not in lp:
        return x + C.scatter(swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"]), mesh, ax, 1), k, v, 0.0
    y, aux = moe_ffn_ep(h2.reshape(B * S, cfg.d_model), lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
                        cfg.moe, mesh=mesh, model_axis=ax, batch_axes=rules.batch)
    s_lo, s_hi = chunk_range(S, *_tp(rules))
    return x + y.reshape(B, S, cfg.d_model)[:, s_lo:s_hi], k, v, aux


def _sp_train_layer(x, lp, specs, cfg, rules, positions):
    x, _, _, aux = _sp_layer(x, lp, specs, cfg, rules, positions)
    return x, aux


def _fsdp_train_layer(x, lp, specs, cfg, rules, positions):
    if "router" in lp:
        raise ValueError("MoE layers on a mesh run expert-parallel: rules with seq == model")
    return _train_layer(x, _use(_cast(lp, x.dtype), specs, rules, None), cfg, positions)


def _forward_sharded(params, tokens, cfg: LMConfig, rules: ShardingRules):
    """``forward`` on this rank's tokens [B_loc, S]: logits float32,
    [B_loc, S_loc, V] (sequence-parallel) or [B_loc, S, V] (pure FSDP),
    and the layers' aux loss (replicated)."""
    mesh = _mesh(rules)
    specs = param_specs(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    sp = _sp_on(rules)
    if sp:
        x = C.scatter(_embed_tp(params["embed"], tokens, cfg, rules, specs["embed"]), mesh, rules.model, 1)
    elif rules.model is None:
        x = F.embedding(tokens, _use1(params["embed"], specs["embed"], rules, None)).to(cfg.dtype)
    else:
        raise ValueError("tensor parallelism runs with sequence parallelism on the train and prefill paths: "
                         "rules with seq == model")
    body = _sp_train_layer if sp else _fsdp_train_layer
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    ckpt = cfg.remat and torch.is_grad_enabled()
    for lp, lsp in zip(params["layers"], specs["layers"]):
        if ckpt:
            x, a = checkpoint(body, x, lp, lsp, cfg, rules, positions, use_reentrant=False)
        else:
            x, a = body(x, lp, lsp, cfg, rules, positions)
        aux = aux + a
    # the logits stay sequence-sharded (sequence-parallel): every rank takes the whole lm_head
    W = _use1(params["lm_head"], specs["lm_head"], rules, rules.model)
    if sp:
        W = C.gather(W, mesh, rules.model, 1, cfg.vocab)
    x = rms_norm(x, params["final_norm"].to(x.dtype))
    return (x @ W.to(x.dtype)).to(torch.float32), aux


def _loss_shares(logits, aux, labels, cfg: LMConfig, rules: ShardingRules):
    """The loss on a mesh from this rank's logits: each rank's share (its
    tokens' cross entropy over all the mesh's tokens, and 1 / ranks of the
    replicated aux loss) summed by ``collectives.total``."""
    mesh = rules.mesh
    axes = tuple(mesh.mesh_dim_names)
    if _sp_on(rules):
        s_lo, s_hi = chunk_range(labels.shape[1], *_tp(rules))
        labels = labels[:, s_lo:s_hi]
    with torch.no_grad():
        n_tok = C.all_reduce(torch.full((), float(labels.numel()), device=logits.device), mesh, axes)
    xent = softmax_xent(logits, labels) * (labels.numel() / n_tok) if labels.numel() else logits.sum() * 0.0
    loss = C.total(xent + aux / mesh.size(), mesh, axes)
    with torch.no_grad():
        xent_all = C.total(xent.detach(), mesh, axes)
    return loss, {"xent": xent_all, "aux": aux.detach() if isinstance(aux, torch.Tensor) else aux}


def _prefill_sharded(params, tokens, cfg: LMConfig, rules: ShardingRules, Smax: int):
    """``prefill`` on this rank's tokens [B_loc, S] (sequence-parallel):
    logits [B_loc, V] and this rank's slice of the cache's sequence."""
    mesh = _mesh(rules)
    if not _sp_on(rules):
        raise ValueError("prefill on a mesh is sequence-parallel: rules with seq == model")
    specs = param_specs(cfg)
    ax = rules.model
    B, S = tokens.shape
    n, i = _tp(rules)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = C.scatter(_embed_tp(params["embed"], tokens, cfg, rules, specs["embed"]), mesh, ax, 1)
    c_lo, c_hi = chunk_range(Smax, n, i)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, c_hi - c_lo, cfg.d_head)
    kall = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    vall = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    w_hi = max(c_lo, min(c_hi, S))
    for li, (lp, sp) in enumerate(zip(params["layers"], specs["layers"])):
        x, k, v, _ = _sp_layer(x, lp, sp, cfg, rules, positions)
        kall[li, :, :, : w_hi - c_lo] = k[:, :, c_lo:w_hi]
        vall[li, :, :, : w_hi - c_lo] = v[:, :, c_lo:w_hi]
    # the last position's residual, from the rank whose piece holds it
    s_lo, s_hi = chunk_range(S, n, i)
    last = x[:, S - 1 - s_lo] if s_lo <= S - 1 < s_hi else torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                                                          device=x.device)
    logits = _head_tp(params, C.all_reduce(last, mesh, ax), specs, rules)
    return logits, KVCache(k=kall, v=vall, pos=S)


def _tp_layer(x, lp, specs, cfg: LMConfig, rules: ShardingRules, positions, attend, batch_axes):
    """One decode layer on x [B_loc, 1, D] (replicated over the tensor-parallel
    axis): column-parallel q, k, v gathered whole, ``attend`` (each [B, H,
    dh] -> [B, Hq, dh] float32) over the sharded cache, row-parallel ``wo``
    and FFN summed over the axis; an MoE layer gathers the tokens of
    ``batch_axes`` and runs ``moe_ffn_ep`` at the global batch's capacity."""
    mesh, ax = rules.mesh, rules.model
    B = x.shape[0]
    lp = _use(_cast(lp, x.dtype), specs, rules, ax)     # cast first: the gathers move cfg.dtype
    h = rms_norm(x, lp["attn_norm"])

    def cols(w, b, n):
        y = h @ w
        return C.gather(y + b if b is not None else y, mesh, ax, -1, n)

    q = cols(lp["wq"], lp.get("bq"), cfg.q_dim).reshape(B, 1, cfg.n_heads, cfg.d_head)
    k = cols(lp["wk"], lp.get("bk"), cfg.kv_dim).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    v = cols(lp["wv"], lp.get("bv"), cfg.kv_dim).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attend(q[:, 0], k[:, 0], v[:, 0]).reshape(B, 1, cfg.q_dim).to(x.dtype)
    r_lo, r_hi = chunk_range(cfg.q_dim, *_tp(rules))
    x = x + C.all_reduce(o[..., r_lo:r_hi] @ lp["wo"], mesh, ax)
    h2 = rms_norm(x, lp["ffn_norm"])
    if "router" not in lp:
        return x + C.all_reduce(swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"]), mesh, ax)
    nb = axis_size(mesh, batch_axes)
    flat = C.gather(h2.reshape(B, cfg.d_model), mesh, batch_axes, 0, B * nb)
    y, _ = moe_ffn_ep(flat, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], cfg.moe, mesh=mesh,
                      model_axis=ax)
    b0 = axis_index(mesh, batch_axes) * B
    return x + y[b0:b0 + B].reshape(B, 1, cfg.d_model)


def _decode_sharded(params, cache, tokens, cfg: LMConfig, rules: ShardingRules):
    """``decode_step`` / ``retrieval_decode_step`` on a mesh: this rank's
    tokens and its slice of the cache (a ``KVCache``'s sequence split over
    "model", evenly, the batch over ``rules.batch``; a
    ``ClusteredKVCache``'s clusters over ``rules.batch`` + "model", the
    batch replicated).  The new token's k and v go into the slice that
    owns its position, in place.  Returns (logits [B, V] float32, cache)."""
    mesh = _mesh(rules)
    if rules.model is None:
        raise ValueError("decode on a mesh shards the cache over the 'model' rule")
    ax = rules.model
    specs = param_specs(cfg)
    B = tokens.shape[0]
    pos = cache.pos
    x = C.all_reduce(_embed_tp(params["embed"], tokens[:, None], cfg, rules, specs["embed"]), mesh, ax)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    retrieval = isinstance(cache, ClusteredKVCache)
    if retrieval:
        seq_axes = tuple(rules.batch) + (ax,)
        cs, top_b = cfg.retrieval.cluster_size, cfg.retrieval.top_clusters
    else:
        S_loc = cache.k.shape[3]
        off = axis_index(mesh, ax) * S_loc
        kv_lens = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)

    for i, (lp, sp) in enumerate(zip(params["layers"], specs["layers"])):
        if retrieval:
            def attend(q, k, v, i=i):
                return retrieval_update_and_attend_sharded(q, cache.k[i], cache.v[i], cache.centroids[i], k, v, pos,
                                                           cs=cs, top_b=top_b, mesh=mesh, seq_axes=seq_axes)[0]
        else:
            def attend(q, k, v, i=i):
                kc, vc = cache.k[i], cache.v[i]
                if off <= pos < off + S_loc:
                    kc[:, :, pos - off] = k.to(kc.dtype)
                    vc[:, :, pos - off] = v.to(vc.dtype)
                return flash_decode_sharded(q[:, :, None], kc, vc, kv_lens, mesh=mesh, model_axis=ax)[:, :, 0]
        x = _tp_layer(x, lp, sp, cfg, rules, positions, attend, () if retrieval else tuple(rules.batch))
    logits = _head_tp(params, x[:, 0], specs, rules)
    if retrieval:
        return logits, ClusteredKVCache(k=cache.k, v=cache.v, centroids=cache.centroids, pos=pos + 1)
    return logits, KVCache(k=cache.k, v=cache.v, pos=pos + 1)
