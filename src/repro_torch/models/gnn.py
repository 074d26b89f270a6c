"""GraphSAGE (Hamilton et al., arXiv:1706.02216) in three execution regimes
(the reference's ``repro.models.gnn``).

Message passing from first principles: gather source features by edge
index, sum them into their destinations (``index_add``, where the
reference has ``jax.ops.segment_sum``), degree-normalise.  The gather and
the sum are one autograd op over chunks of ``EDGE_CHUNK`` edges
(``gather_scatter``): no [E, d] message tensor is held, forward or
backward, so ogbn-products' 61.9 M edges need ~2 GB of messages at a time
where the whole [E, 128] would be 31.7 GB, and its gradient as much
again.  The three regimes:

  * full-batch    — a sum over the whole edge list (Cora / ogbn scale);
  * sampled       — dense fanout tensors from the neighbour sampler
                    (``data/graph.py``): hop-h features [B, f1..fh, d]; mean
                    aggregation is an axis mean;
  * batched small graphs (molecule) — per-graph edge lists flattened with
                    node offsets, the same sum, a masked mean-pool readout.

On a mesh (``mesh=``, ``axes=``) each regime takes this rank's shards
and its loss is the mean over every rank's rows (``softmax_xent`` on the
mesh).  Full batch: nodes and edges are sharded over the same axes and the
edge ids index the whole graph, so each layer does what GSPMD does with
the gather: all-gather ``h`` over the node axes, run the rank's edges
through ``gather_scatter`` into a whole ``[N, d]`` buffer, and
reduce-scatter that buffer to the nodes' owners (the degree alike); the
collectives' transposes give the backward.  Every rank holds the whole
``[N, d]`` twice a layer (ogbn-products: 1.25 GB at d = 128); a halo
exchange of the rank's neighbours only would not.  Sampled and batched
graphs: the batch is sharded over the batch axes and needs no
collective but the loss's.

On CUDA ``index_add`` sums with atomics: its float32 sums, forward and
backward, are not deterministic from run to run.  The paper's
technique (eCP-FS) does not apply to GraphSAGE; this model runs without it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..distributed import collectives as C
from .base import ParamSpec as P
from .base import init_params as _init_params
from .layers import softmax_xent

__all__ = [
    "GraphSAGEConfig", "param_specs", "init_params", "gather_scatter", "full_batch_forward", "sampled_forward",
    "batched_graph_forward", "gnn_loss_full", "gnn_loss_sampled", "gnn_loss_graphs",
]


@dataclass(frozen=True)
class GraphSAGEConfig:
    name: str
    d_in: int
    n_classes: int
    n_layers: int = 2
    d_hidden: int = 128
    aggregator: str = "mean"
    fanouts: tuple = (25, 10)
    dtype: Any = torch.float32


def param_specs(cfg: GraphSAGEConfig):
    dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
    layers = []
    for l in range(cfg.n_layers):
        layers.append(
            {
                "w_self": P((dims[l], dims[l + 1]), cfg.dtype),
                "w_neigh": P((dims[l], dims[l + 1]), cfg.dtype),
                "b": P((dims[l + 1],), cfg.dtype, (), "zeros"),
            }
        )
    return {
        "layers": layers,
        "w_out": P((cfg.d_hidden, cfg.n_classes), cfg.dtype),
        "b_out": P((cfg.n_classes,), cfg.dtype, (), "zeros"),
    }


def init_params(cfg: GraphSAGEConfig, generator: torch.Generator, *, device="cuda"):
    """Random weights from ``generator`` (which lives on ``device``)."""
    return _init_params(param_specs(cfg), generator, device=device)


def _sage_layer(h_self, h_agg, lp, act=True):
    y = h_self @ lp["w_self"] + h_agg @ lp["w_neigh"] + lp["b"]
    return F.relu(y) if act else y


EDGE_CHUNK = 1 << 22


def _segment_sum(x, dst, n: int):
    """Rows of ``x`` summed into ``n`` rows by ``dst`` (``segment_sum``)."""
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add(0, dst, x)


def _gather_scatter(h, src, dst, w, n: int, chunk: int):
    out = torch.zeros((n,) + h.shape[1:], dtype=h.dtype, device=h.device)
    for e0 in range(0, src.shape[0], chunk):
        msg = torch.index_select(h, 0, src[e0 : e0 + chunk])
        if w is not None:
            msg = msg * w[e0 : e0 + chunk, None]
        out.index_add_(0, dst[e0 : e0 + chunk], msg)
    return out


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, src, dst, w, n, chunk):
        ctx.save_for_backward(src, dst, w)
        ctx.rows, ctx.chunk = h.shape[0], chunk
        return _gather_scatter(h, src, dst, w, n, chunk)

    @staticmethod
    def backward(ctx, grad):
        src, dst, w = ctx.saved_tensors
        # d out[dst[e]] / d h[src[e]] = w[e]: the same op with the edges reversed
        return _gather_scatter(grad, dst, src, w, ctx.rows, ctx.chunk), None, None, None, None, None


def gather_scatter(h, src, dst, n: int, *, edge_weight=None, chunk: int = EDGE_CHUNK):
    """``segment_sum(h[src] * edge_weight[:, None], dst, n)``, differentiable
    in ``h`` (the edge weights are data), over chunks of ``chunk`` edges.
    Without weights the messages are the gathered rows as they are (the
    reference multiplies them by ones: the same values)."""
    return _GatherScatter.apply(h, src, dst, edge_weight, n, chunk)


# ------------------------------------------------------------- full batch
def full_batch_forward(params, feats, edge_src, edge_dst, cfg: GraphSAGEConfig, *, edge_weight=None, mesh=None,
                       axes=None, n_nodes: int | None = None):
    """feats [N, d]; edge_src/dst [E] int32 or int64 (messages flow src ->
    dst).

    edge_weight [E] (optional): 0-weight edges are padding — node and edge
    arrays are padded to shard-divisible sizes by a launcher, and the
    weights keep padded edges out of both the sum and the degree.

    On ``mesh``: feats are this rank's nodes and the edges its edges, both
    cut over ``axes`` (``launch.mesh.local_range``), the edge ids global
    among ``n_nodes``; returns this rank's nodes' logits.
    """
    n = feats.shape[0] if mesh is None else n_nodes
    w = (torch.ones(edge_dst.shape, dtype=torch.float32, device=feats.device) if edge_weight is None
         else edge_weight)
    deg = _segment_sum(w, edge_dst, n)
    if mesh is not None:
        deg = C.scatter(deg, mesh, axes, 0)
    inv_deg = 1.0 / torch.clamp_min(deg, 1.0)
    h = feats.to(cfg.dtype)
    for lp in params["layers"]:
        src_h = h if mesh is None else C.gather(h, mesh, axes, 0, n)
        agg = gather_scatter(src_h, edge_src, edge_dst, n, edge_weight=edge_weight)
        if mesh is not None:
            agg = C.scatter(agg, mesh, axes, 0)
        h = _sage_layer(h, agg * inv_deg[:, None], lp)
    return h @ params["w_out"] + params["b_out"]


def gnn_loss_full(params, batch, cfg: GraphSAGEConfig, *, mesh=None, axes=None, n_nodes: int | None = None):
    logits = full_batch_forward(
        params,
        batch["feats"],
        batch["edge_src"],
        batch["edge_dst"],
        cfg,
        edge_weight=batch.get("edge_weight"),
        mesh=mesh,
        axes=axes,
        n_nodes=n_nodes,
    )
    return softmax_xent(logits, batch["labels"], mask=batch.get("label_mask"), mesh=mesh, axes=axes), {}


# --------------------------------------------------------------- sampled
def sampled_forward(params, hops, cfg: GraphSAGEConfig):
    """hops: tuple of fanout tensors, outermost hop first.

    hops[-1] = seed features [B, d]; hops[-2] = 1-hop [B, f1, d];
    hops[0] = (L)-hop [B, f1, ..., fL, d]. Mean aggregation = axis mean.
    """
    hs = [h.to(cfg.dtype) for h in hops]
    for lp in params["layers"]:
        new_hs = []
        for i in range(len(hs) - 1):
            neigh = torch.mean(hs[i], dim=-2)  # collapse the innermost fanout axis
            new_hs.append(_sage_layer(hs[i + 1], neigh, lp))
        hs = new_hs
    return hs[0] @ params["w_out"] + params["b_out"]


def gnn_loss_sampled(params, batch, cfg: GraphSAGEConfig, *, mesh=None, axes=None):
    logits = sampled_forward(params, batch["hops"], cfg)
    return softmax_xent(logits, batch["labels"], mesh=mesh, axes=axes), {}


# -------------------------------------------------- batched small graphs
def batched_graph_forward(params, feats, edge_src, edge_dst, node_mask, cfg: GraphSAGEConfig):
    """feats [G, N, d]; edges [G, E] local indices; node_mask [G, N].

    Flattens graphs with node offsets and reuses the segment-sum path;
    readout = masked mean pool -> graph logits [G, n_classes].
    """
    G, N, d = feats.shape
    offs = (torch.arange(G, device=feats.device) * N)[:, None]
    src = (edge_src + offs).reshape(-1)
    dst = (edge_dst + offs).reshape(-1)
    flat = feats.reshape(G * N, d)
    n = G * N
    deg = _segment_sum(torch.ones(dst.shape, dtype=torch.float32, device=feats.device), dst, n)
    inv_deg = 1.0 / torch.clamp_min(deg, 1.0)
    h = flat.to(cfg.dtype)
    for lp in params["layers"]:
        agg = gather_scatter(h, src, dst, n) * inv_deg[:, None]
        h = _sage_layer(h, agg, lp)
    h = h.reshape(G, N, -1) * node_mask[..., None]
    pooled = h.sum(1) / torch.clamp_min(node_mask.sum(1, keepdim=True), 1.0)
    return pooled @ params["w_out"] + params["b_out"]


def gnn_loss_graphs(params, batch, cfg: GraphSAGEConfig, *, mesh=None, axes=None):
    logits = batched_graph_forward(
        params, batch["feats"], batch["edge_src"], batch["edge_dst"], batch["node_mask"], cfg
    )
    return softmax_xent(logits, batch["labels"], mesh=mesh, axes=axes), {}
