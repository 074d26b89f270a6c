"""CTR / ranking models: BST, DIEN, AutoInt, DCN-v2 (the reference's
``repro.models.recsys``, in PyTorch).

All categorical fields live in ONE concatenated mega-table
``[total_vocab, embed_dim]`` with per-field row offsets: a batch of field
ids becomes a single gather; multi-hot bags reduce with a mask (fixed
shapes) or ``index_add_`` (the ragged path, the reference's
``segment_sum``).

``retrieval_cand``: ``user_tower`` embeds the request, and
``candidate_scores`` returns the top k of the candidate embeddings by inner
product, one launch of the port's ``distance_topk`` kernel on the card
(its k < N path), the plain version on the CPU.

On a mesh (``mesh=``): the table is sharded by rows over "model" (its
pspec).  A lookup is masked to the rank's rows, zeros for the others, and
summed over "model" (the LM's vocabulary-sharded embedding); the batch is
the rank's rows, and the loss the mean over every rank's
(``bce_logits`` on the mesh).  ``candidate_scores_sharded`` takes the top k
of each rank's candidate shard (one ``distance_topk`` launch), gathers the
ranks' lists and merges them (``merge_topk``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from ..distributed import collectives as C
from ..kernels.distance_topk import ops as topk_ops
from ..launch.mesh import axis_size, local_range
from .base import ParamSpec as P
from .base import init_params as _init_params
from .layers import bce_logits, layer_norm

__all__ = [
    "RecSysConfig", "param_specs", "init_params", "forward", "recsys_loss", "user_tower",
    "embedding_lookup", "embedding_bag", "embedding_bag_ragged", "candidate_scores", "candidate_scores_sharded",
    "merge_topk", "table_rows",
]


@dataclass(frozen=True)
class RecSysConfig:
    name: str
    interaction: str                  # "transformer-seq" | "augru" | "self-attn" | "cross"
    embed_dim: int
    field_vocabs: tuple               # rows per categorical field (mega-table layout)
    n_dense: int = 0                  # continuous features
    seq_len: int = 0                  # behavior sequence length (BST/DIEN)
    seq_fields: int = 0               # id fields per sequence position
    mlp: tuple = (256, 128)
    # BST / AutoInt attention params
    n_blocks: int = 1
    n_heads: int = 2
    d_attn: int = 32
    # DIEN
    gru_dim: int = 0
    # DCN
    n_cross_layers: int = 0
    dtype: Any = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.field_vocabs)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.field_vocabs))

    @property
    def field_offsets(self) -> tuple:
        offs, acc = [], 0
        for v in self.field_vocabs:
            offs.append(acc)
            acc += v
        return tuple(offs)


# ------------------------------------------------------------- embeddings
def table_rows(cfg: RecSysConfig) -> int:
    """The mega-table's rows: padded to a shard-divisible count, as the
    reference's (model axis <= 512 on its meshes); offsets never address
    the pad rows."""
    return -(-cfg.total_vocab // 512) * 512 if cfg.total_vocab > 512 else cfg.total_vocab


def embedding_lookup(table, ids, *, mesh=None, rows: int | None = None):
    """ids [...] (already offset into the mega-table) -> [..., dim].

    On ``mesh`` ``table`` is this rank's shard of a ``rows``-row table cut
    over "model": the rank's rows, zeros for the others, summed over
    "model"."""
    ids = ids.long()
    if mesh is None:
        return table[ids]
    lo, hi = local_range(rows, mesh, "model")
    inside = (ids >= lo) & (ids < hi)
    if hi > lo:
        e = torch.where(inside[..., None], table[torch.where(inside, ids - lo, 0)], 0.0)
    else:   # the sum over no rows: zeros that keep the table in the graph, so
        # that this rank too runs the backward pass's sum over "model"
        e = table.sum(0).expand(*ids.shape, table.shape[1])
    return C.all_reduce(e, mesh, "model")


def embedding_bag(table, ids, mask, *, mode: str = "mean", mesh=None, rows: int | None = None):
    """Fixed-shape embedding bag: ids [B, L], mask [B, L] -> [B, dim] (on
    ``mesh``: of a row-sharded table, as ``embedding_lookup``)."""
    e = embedding_lookup(table, ids, mesh=mesh, rows=rows) * mask[..., None]
    if mode == "sum":
        return e.sum(1)
    if mode == "mean":
        return e.sum(1) / torch.clamp_min(mask.sum(1, keepdim=True), 1.0)
    if mode == "max":
        neg = torch.where(mask[..., None] > 0, e, -torch.inf)
        return torch.amax(neg, dim=1)
    raise ValueError(mode)


def embedding_bag_ragged(table, flat_ids, segment_ids, n_bags, *, mode: str = "sum"):
    """Ragged bag: the rows of flat_ids summed into bag segment_ids[i]
    (``index_add_``, the reference's ``segment_sum``); "mean" divides by
    the bag's size (at least 1)."""
    e = table[flat_ids.long()]
    seg = segment_ids.long()
    s = torch.zeros((n_bags, e.shape[-1]), dtype=e.dtype, device=e.device).index_add_(0, seg, e)
    if mode == "sum":
        return s
    cnt = torch.zeros(n_bags, dtype=torch.float32, device=e.device).index_add_(
        0, seg, torch.ones(seg.shape, dtype=torch.float32, device=e.device))
    return s / torch.clamp_min(cnt[:, None], 1.0)


def _mlp_specs(dims, dt, prefix=""):
    out = {}
    for i in range(len(dims) - 1):
        out[f"{prefix}w{i}"] = P((dims[i], dims[i + 1]), dt)
        out[f"{prefix}b{i}"] = P((dims[i + 1],), dt, (), "zeros")
    return out


def _mlp_apply(params, x, n, prefix="", act=F.relu, final_act=False):
    for i in range(n):
        x = x @ params[f"{prefix}w{i}"] + params[f"{prefix}b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ----------------------------------------------------------- param specs
def param_specs(cfg: RecSysConfig):
    """One flat dict of ``ParamSpec``, the reference's names and shapes."""
    dt = cfg.dtype
    d = cfg.embed_dim
    specs: dict = {"table": P((table_rows(cfg), d), dt, ("model", None), "embed")}
    seq_d = d * cfg.seq_fields
    if cfg.interaction == "transformer-seq":  # BST
        dm = seq_d
        specs.update(
            {
                "pos_embed": P((cfg.seq_len + 1, dm), dt, (None, None), "embed"),
                "wq": P((cfg.n_blocks, dm, cfg.n_heads * cfg.d_attn), dt),
                "wk": P((cfg.n_blocks, dm, cfg.n_heads * cfg.d_attn), dt),
                "wv": P((cfg.n_blocks, dm, cfg.n_heads * cfg.d_attn), dt),
                "wo": P((cfg.n_blocks, cfg.n_heads * cfg.d_attn, dm), dt),
                "ln_g": P((cfg.n_blocks, 2, dm), dt, (None, None, None), "ones"),
                "ln_b": P((cfg.n_blocks, 2, dm), dt, (None, None, None), "zeros"),
                "ffw1": P((cfg.n_blocks, dm, 4 * dm), dt),
                "ffb1": P((cfg.n_blocks, 4 * dm), dt, (None, None), "zeros"),
                "ffw2": P((cfg.n_blocks, 4 * dm, dm), dt),
                "ffb2": P((cfg.n_blocks, dm), dt, (None, None), "zeros"),
            }
        )
        mlp_in = (cfg.seq_len + 1) * dm + (cfg.n_fields - cfg.seq_fields) * d
    elif cfg.interaction == "augru":  # DIEN
        g = cfg.gru_dim
        specs.update(
            {
                "gru_wx": P((seq_d, 3 * g), dt),
                "gru_wh": P((g, 3 * g), dt),
                "gru_b": P((3 * g,), dt, (), "zeros"),
                "att_w": P((g, seq_d), dt),
                "augru_wx": P((g, 3 * g), dt),
                "augru_wh": P((g, 3 * g), dt),
                "augru_b": P((3 * g,), dt, (), "zeros"),
            }
        )
        mlp_in = g + (cfg.n_fields - cfg.seq_fields) * d + seq_d
    elif cfg.interaction == "self-attn":  # AutoInt
        da, H = cfg.d_attn, cfg.n_heads
        specs.update(
            {
                "wq": P((1, d, H * da), dt),
                "wk": P((1, d, H * da), dt),
                "wv": P((1, d, H * da), dt),
                "w_res": P((1, d, H * da), dt),
            }
        )
        if cfg.n_blocks > 1:  # after block 0 the field dim becomes H*da
            specs["wq2"] = P((cfg.n_blocks - 1, H * da, H * da), dt)
            specs["wk2"] = P((cfg.n_blocks - 1, H * da, H * da), dt)
            specs["wv2"] = P((cfg.n_blocks - 1, H * da, H * da), dt)
            specs["w_res2"] = P((cfg.n_blocks - 1, H * da, H * da), dt)
        mlp_in = cfg.n_fields * H * da
    elif cfg.interaction == "cross":  # DCN-v2
        x0_dim = cfg.n_dense + cfg.n_fields * d
        specs.update(
            {
                "cross_w": P((cfg.n_cross_layers, x0_dim, x0_dim), dt),
                "cross_b": P((cfg.n_cross_layers, x0_dim), dt, (None, None), "zeros"),
            }
        )
        mlp_in = x0_dim
    else:
        raise ValueError(cfg.interaction)

    specs.update(_mlp_specs((mlp_in,) + tuple(cfg.mlp), dt, "mlp_"))
    if cfg.interaction == "cross":
        # DCN-v2 parallel structure: concat(cross_out, deep_out) -> logit
        head_in = (cfg.n_dense + cfg.n_fields * d) + cfg.mlp[-1]
    else:
        head_in = cfg.mlp[-1]
    specs["w_head"] = P((head_in, 1), dt)
    specs["b_head"] = P((1,), dt, (), "zeros")
    # retrieval tower projection (retrieval_cand workload)
    specs["w_ret"] = P((d, d), dt)
    return specs


def init_params(cfg: RecSysConfig, generator: torch.Generator, *, device="cuda"):
    """Random parameters from the reference's distributions, drawn on
    ``device`` from ``generator`` (which must live there)."""
    return _init_params(param_specs(cfg), generator, device=device, dtype=cfg.dtype)


# ----------------------------------------------------------- interactions
def _attend(q, k, v, da):
    """q, k, v [B, S, H, da] -> [B, S, H * da]: softmax attention over S."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(torch.tensor(float(da), dtype=torch.float32))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o.reshape(q.shape[0], q.shape[1], -1)


def _bst_block(params, i, x, cfg: RecSysConfig):
    B, S, _ = x.shape
    H, da = cfg.n_heads, cfg.d_attn
    h = layer_norm(x, params["ln_g"][i, 0], params["ln_b"][i, 0])
    q = (h @ params["wq"][i]).reshape(B, S, H, da)
    k = (h @ params["wk"][i]).reshape(B, S, H, da)
    v = (h @ params["wv"][i]).reshape(B, S, H, da)
    x = x + _attend(q, k, v, da) @ params["wo"][i]
    h2 = layer_norm(x, params["ln_g"][i, 1], params["ln_b"][i, 1])
    y = F.relu(h2 @ params["ffw1"][i] + params["ffb1"][i]) @ params["ffw2"][i] + params["ffb2"][i]
    return x + y


def _gru_scan(x_seq, w_x, w_h, b, g, att=None):
    """GRU / AUGRU over time. x_seq [B, S, d] -> hidden states [B, S, g].

    att [B, S] (attention scores) turns the update gate into DIEN's AUGRU:
    z_t <- a_t * z_t. With att = 1 this is exactly a plain GRU.
    """
    B, S, _ = x_seq.shape
    if att is None:
        att = torch.ones((B, S), dtype=x_seq.dtype, device=x_seq.device)
    h = torch.zeros((B, g), dtype=x_seq.dtype, device=x_seq.device)
    hs = []
    for t in range(S):
        gx = x_seq[:, t] @ w_x + b                 # [B, 3g]
        gh = h @ w_h                               # [B, 3g]
        z = torch.sigmoid(gx[:, :g] + gh[:, :g])
        r = torch.sigmoid(gx[:, g : 2 * g] + gh[:, g : 2 * g])
        hh = torch.tanh(gx[:, 2 * g :] + r * gh[:, 2 * g :])
        z = z * att[:, t, None]                    # AUGRU attentional gate
        h = (1 - z) * h + z * hh
        hs.append(h)
    return torch.stack(hs, dim=1)


def _autoint_block(x, wq, wk, wv, wres, H, da):
    B, Fn, _ = x.shape
    q = (x @ wq).reshape(B, Fn, H, da)
    k = (x @ wk).reshape(B, Fn, H, da)
    v = (x @ wv).reshape(B, Fn, H, da)
    return F.relu(_attend(q, k, v, da) + x @ wres)


# ---------------------------------------------------------------- forward
def _ids(batch, key, device):
    return torch.as_tensor(batch[key], device=device)


def forward(params, batch, cfg: RecSysConfig, *, mesh=None):
    """batch fields (numpy or tensors; ids are RAW per field, offsets
    applied here):
       "cat": [B, n_fields - seq_fields] non-sequence categorical ids
       "seq": [B, seq_len, seq_fields] behavior ids (BST/DIEN)
       "seq_mask": [B, seq_len]
       "target": [B, seq_fields] target item ids (BST/DIEN)
       "dense": [B, n_dense]
    Returns logits [B] on the parameters' device.  On ``mesh``: the
    table is the rank's row shard, the batch the rank's rows.
    """
    table = params["table"]
    dev = table.device
    lookup = partial(embedding_lookup, mesh=mesh, rows=table_rows(cfg))
    offs = torch.tensor(cfg.field_offsets, dtype=torch.int64, device=dev)
    cat = _ids(batch, "cat", dev).long()

    if cfg.interaction in ("transformer-seq", "augru"):
        seq, tgt = _ids(batch, "seq", dev).long(), _ids(batch, "target", dev).long()
        seq_e = lookup(table, seq + offs[None, None, : cfg.seq_fields]).reshape(*seq.shape[:2], -1)
        tgt_e = lookup(table, tgt + offs[None, : cfg.seq_fields]).reshape(tgt.shape[0], -1)
        plain = lookup(table, cat + offs[None, cfg.seq_fields :]).reshape(cat.shape[0], -1)
    if cfg.interaction == "transformer-seq":
        x = torch.cat([seq_e, tgt_e[:, None, :]], dim=1)             # [B, S+1, dm]
        x = x + params["pos_embed"][None, : x.shape[1]]
        for i in range(cfg.n_blocks):
            x = _bst_block(params, i, x, cfg)
        feat = torch.cat([x.reshape(x.shape[0], -1), plain], dim=-1)
        h = _mlp_apply(params, feat, len(cfg.mlp), "mlp_", final_act=True)
    elif cfg.interaction == "augru":
        g = cfg.gru_dim
        hs = _gru_scan(seq_e, params["gru_wx"], params["gru_wh"], params["gru_b"], g)
        att_logit = torch.einsum("bsg,gd,bd->bs", hs, params["att_w"], tgt_e)
        mask = _ids(batch, "seq_mask", dev)
        # -1e9 not -inf: an all-masked row degrades to uniform, never NaN
        att = torch.softmax(torch.where(mask > 0, att_logit, torch.full_like(att_logit, -1e9)), dim=-1)
        hs2 = _gru_scan(hs, params["augru_wx"], params["augru_wh"], params["augru_b"], g, att=att)
        feat = torch.cat([hs2[:, -1], plain, tgt_e], dim=-1)
        h = _mlp_apply(params, feat, len(cfg.mlp), "mlp_", final_act=True)
    elif cfg.interaction == "self-attn":
        x = lookup(table, cat + offs[None, :])                       # [B, F, d]
        H, da = cfg.n_heads, cfg.d_attn
        x = _autoint_block(x, params["wq"][0], params["wk"][0], params["wv"][0], params["w_res"][0], H, da)
        for i in range(cfg.n_blocks - 1):
            x = _autoint_block(x, params["wq2"][i], params["wk2"][i], params["wv2"][i], params["w_res2"][i], H, da)
        h = _mlp_apply(params, x.reshape(x.shape[0], -1), len(cfg.mlp), "mlp_", final_act=True)
    elif cfg.interaction == "cross":
        emb = lookup(table, cat + offs[None, :]).reshape(cat.shape[0], -1)
        x0 = torch.cat([_ids(batch, "dense", dev).to(emb.dtype), emb], dim=-1)
        x = x0
        for i in range(cfg.n_cross_layers):
            x = x0 * (x @ params["cross_w"][i] + params["cross_b"][i]) + x
        deep = _mlp_apply(params, x0, len(cfg.mlp), "mlp_", final_act=True)
        h = torch.cat([x, deep], dim=-1)
    else:
        raise ValueError(cfg.interaction)

    return (h @ params["w_head"] + params["b_head"])[:, 0]


def recsys_loss(params, batch, cfg: RecSysConfig, *, mesh=None, axes=None):
    """(mean binary cross-entropy of the logits against batch["label"], {});
    on ``mesh`` over the rows of every rank, the batch split over ``axes``."""
    logits = forward(params, batch, cfg, mesh=mesh)
    return bce_logits(logits, _ids(batch, "label", logits.device), mesh=mesh, axes=axes), {}


# ---------------------------------------------------------- retrieval cand
def user_tower(params, batch, cfg: RecSysConfig, *, mesh=None):
    """Query embedding for retrieval scoring: mean field embedding -> proj
    (on ``mesh`` from the rank's table shard, alike on every rank)."""
    table = params["table"]
    dev = table.device
    offs = torch.tensor(cfg.field_offsets, dtype=torch.int64, device=dev)
    if cfg.seq_len and "seq" in batch:
        seq = _ids(batch, "seq", dev).long()
        ids = (seq + offs[None, None, : cfg.seq_fields]).reshape(seq.shape[0], -1)
        mask = torch.repeat_interleave(_ids(batch, "seq_mask", dev), cfg.seq_fields, dim=-1)
        e = embedding_bag(table, ids, mask, mode="mean", mesh=mesh, rows=table_rows(cfg))
    else:
        cat = _ids(batch, "cat", dev).long()
        e = embedding_lookup(table, cat + offs[None, : cat.shape[1]], mesh=mesh, rows=table_rows(cfg)).mean(1)
    return e @ params["w_ret"]


def candidate_scores(query, cand_emb, k: int):
    """Retrieval scoring: query [B, d] x cand_emb [N, d] -> the top k by
    inner product, (scores [B, k] descending, ids [B, k] int32).

    On CUDA tensors one launch of the port's ``distance_topk`` kernel
    (metric ip, its k < N path: the [B, N] scores never exist); on CPU
    tensors its plain version.
    """
    d, i = topk_ops.distance_topk(query, cand_emb, k, "ip")
    return -d, i


def merge_topk(scores, ids, k: int):
    """The top k of candidate lists: scores [B, M] (higher first), ids
    [B, M] int32 global; pads (-inf, -1) anywhere.  By score descending,
    ties to the lower id (as the kernel and ``lax.top_k`` break them), the
    pads last: a stable sort on the id, then a stable sort on -score
    (``torch.topk`` leaves the order among ties unspecified).  Returns
    ([B, k], [B, k]), ``(-inf, -1)`` where fewer than k are real."""
    pad = ids < 0
    by_id = torch.sort(torch.where(pad, torch.iinfo(torch.int32).max, ids), dim=-1, stable=True).indices
    scores, ids, pad = scores.gather(-1, by_id), ids.gather(-1, by_id), pad.gather(-1, by_id)
    order = torch.sort(torch.where(pad, torch.inf, -scores), dim=-1, stable=True).indices[:, :k]
    return scores.gather(-1, order), ids.gather(-1, order)


def candidate_scores_sharded(query, cand_shard, k: int, *, mesh, axes, n_rows: int, n_valid: int):
    """``candidate_scores`` over candidates whose ``n_rows`` rows are
    sharded over ``axes``, the first ``n_valid`` of them real: query [B, d]
    alike on every rank, ``cand_shard`` this rank's rows
    (``launch.mesh.local_range``).  The rank takes the top k of its valid
    rows (one ``distance_topk`` launch; none where it holds no valid row),
    offsets the ids to global ones, gathers every rank's list over
    ``axes`` and merges them (``merge_topk``); a rank with fewer than k
    valid rows gives (-inf, -1) pads, which the merge puts last.  The
    result is the same on every rank."""
    lo, hi = local_range(n_rows, mesh, axes)
    nv = max(0, min(hi, n_valid) - lo)
    B = query.shape[0]
    if nv:
        s, i = candidate_scores(query, cand_shard[:nv], k)
        i = torch.where(i >= 0, i + lo, -1).to(torch.int32)
    else:
        s = torch.full((B, k), -torch.inf, dtype=torch.float32, device=query.device)
        i = torch.full((B, k), -1, dtype=torch.int32, device=query.device)
    n = k * axis_size(mesh, axes)
    return merge_topk(C.gather(s, mesh, axes, 1, n), C.gather(i, mesh, axes, 1, n), k)
