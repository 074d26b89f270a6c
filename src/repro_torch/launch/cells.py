"""Cells: one step function and its abstract inputs per (architecture x
input shape), as the reference's ``launch/cells.py``.

A ``Cell`` is everything the dry run needs and nothing it must allocate:
  fn          the port's step (``make_train_step``, ``prefill``,
              ``decode_step``, ``retrieval_decode_step``, sigmoid of the
              recsys ``forward``, or the retrieval tower)
  args        the inputs as tensors on the meta device (shape and dtype)
  in_pspecs   the reference's partition specs, same structure as args:
              tuples of mesh-axis names a dimension (``()`` replicated)
  donate      the args a step updates in place (the optimizer's state, the
              caches); the reference donates the same buffers
  meta        parameter and token counts for the roofline

``example_inputs`` allocates concrete inputs for a cell on a device, and
``args_from_jax`` carries the reference's concrete inputs of the same cell
across, so that tests run both packages' steps on the same numbers.

On a mesh: a cell built with mesh axes carries the reference's partition
specs and rules naming those axes; ``lower_cell(cell, mesh)`` binds its
step to a ``DeviceMesh`` (the reference's jit with shardings): the
returned ``Lowered`` cuts each rank's shards of the inputs by
``in_pspecs``, runs the rank's step and gives the outputs as ``DTensor``s
laid out by ``out_pspecs``.  Unbound, such an LM cell's ``fn`` raises.  The 20
GraphSAGE and recsys cells have no distribution code in the reference
(GSPMD partitions them with the same pspecs); here each has an explicit
body of the rank's shards (``models/gnn.py``, ``models/recsys.py`` with
``mesh=``), its ``fn`` the one-device step, and the placements of its
outputs in ``meta["out_pspecs"]`` (the reference sets no out_shardings).
``make_train_step`` runs ``value_and_grad`` (torch autograd) and the
optimizer in place; on a mesh it first sums each gradient over the axes
its weight is replicated on and clips by the global norm of the shards.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Any, Callable

import numpy as np
import torch

from ..configs import arch_shapes, get_arch
from ..device import resolve_device
from ..distributed import collectives as C
from ..distributed.elastic import local_tree, map_specs
from ..models import gnn, recsys
from ..models import transformer as T
from ..models.base import abstract_params, init_params, param_count, param_pspecs, params_from_jax
from ..models.retrieval_attention import ClusteredKVCache
from ..optim import adamw, apply_updates, warmup_cosine
from ..tree import tree_leaves, tree_map, tree_unflatten
from .mesh import axes_of, axis_size, placements

__all__ = ["Cell", "Lowered", "build_cell", "lower_cell", "make_rules", "example_inputs", "live_inputs", "args_from_jax",
           "map_args", "arg_leaves", "make_train_step", "value_and_grad", "to_device"]

_CACHES = (T.KVCache, ClusteredKVCache)


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple
    in_pspecs: tuple
    donate: tuple = ()
    out_pspecs: Any = None     # the reference's out_shardings specs
    meta: dict = field(default_factory=dict)


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_axes(rules):
    """The batch dims' pspec entry: None, one axis name, or a tuple of
    them (``PartitionSpec`` keeps a one-name tuple as the name)."""
    if not rules.batch:
        return None
    return rules.batch[0] if len(rules.batch) == 1 else tuple(rules.batch)


def make_rules(mesh_axes) -> T.ShardingRules:
    batch = tuple(a for a in ("pod", "data") if a in mesh_axes)
    return T.ShardingRules(batch=batch, model="model" if "model" in mesh_axes else None)


# ------------------------------------------------------------- train step
def to_device(batch, device):
    """Numpy leaves of ``batch`` as tensors on ``device``; tensors moved."""
    return tree_map(lambda x: torch.as_tensor(x, device=device), batch)


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``, as ``jax.value_and_grad(..., has_aux=True)``: the gradient
    of every parameter (zeros where the loss does not reach it), the loss
    and the metrics detached.  ``params`` need not require grad."""
    leaves = tree_leaves(params)
    xs = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    detach = lambda m: m.detach() if isinstance(m, torch.Tensor) else m
    return (loss.detach(), tree_map(detach, metrics)), tree_unflatten(params, grads)


def _replica_axes(mesh, ps) -> tuple:
    named = {a for e in ps for a in axes_of(e)}
    return tuple(a for a in mesh.mesh_dim_names if a not in named)


@torch.no_grad()
def _sum_replicas(grads, mesh, pspecs):
    """Each rank's gradient of its shard summed over the axes its weight is
    replicated on (the gradient of a loss whose shares the ranks hold), and
    the global norm of the whole gradient (each shard counted once)."""
    sq = []

    def leaf(g, ps):
        rep = _replica_axes(mesh, ps)
        g = C.all_reduce(g, mesh, rep)
        sq.append(torch.sum(torch.square(g.to(torch.float32))) / axis_size(mesh, rep))
        return g

    grads = map_specs(leaf, grads, pspecs)
    return grads, torch.sqrt(C.all_reduce(torch.stack(sq).sum(), mesh, mesh.mesh_dim_names))


def make_train_step(loss_fn, opt, *, microbatches: int = 1, mesh=None, pspecs=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch``'s numpy leaves go to the parameters' device.  microbatches >
    1: gradient accumulation over that many chunks of the batch's leading
    axis, in float32: activation memory scales 1/n while the optimizer
    state is touched once.  The optimizer works in place (``optim.adamw``):
    the returned params and state are the ones passed in, updated.  On
    ``mesh`` the params are this rank's shards by ``pspecs`` and
    ``loss_fn`` returns the loss of the ranks' shares
    (``collectives.total``); the gradients are summed over each weight's
    replica axes and clipped by their global norm.
    """

    def step(params, opt_state, batch):
        batch = to_device(batch, tree_leaves(params)[0].device)
        if microbatches <= 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches) + tuple(x.shape[1:]))

            chunks = tree_map(split, batch)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            loss, ms = 0.0, []
            for i in range(microbatches):
                (l, m), g = value_and_grad(loss_fn, params, tree_map(lambda c: c[i], chunks))
                grads = tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
                loss = loss + l
                ms.append(m)
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = tree_map(lambda *xs: torch.mean(torch.stack(xs), dim=0), *ms)
        if mesh is None:
            updates, opt_state = opt.update(grads, opt_state, params)
        else:
            grads, norm = _sum_replicas(grads, mesh, pspecs)
            updates, opt_state = opt.update(grads, opt_state, params, grad_norm=norm)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **metrics}

    return step


def _opt_for(cfg: T.LMConfig):
    """The reference's LM optimizer.  It decays every leaf of its stacked
    layout with ndim >= 2, the layers' norm gains and biases too; the
    port's per-layer leaves get the same through ``decay_mask``."""
    mdt = torch.bfloat16 if cfg.param_dtype == torch.bfloat16 else torch.float32
    return adamw(warmup_cosine(3e-4, 200, 10_000), moment_dtype=mdt, decay_mask=T.decay_mask(cfg))


def _abstract_opt(aparams, moment_dtype):
    like = lambda p: _abstract(p.shape, moment_dtype)
    return {"mu": tree_map(like, aparams), "nu": tree_map(like, aparams),
            "step": _abstract((), torch.int32)}


def _opt_pspecs(pparams):
    return {"mu": pparams, "nu": pparams, "step": ()}


# ------------------------------------------------------------------ LM
def _lm_cell(arch: str, cfg: T.LMConfig, shape_id: str, sh: dict, rules: T.ShardingRules) -> Cell:
    seq, batch = sh["seq"], sh["batch"]
    cfg = replace(cfg, max_seq=seq)
    specs = T.param_specs(cfg)
    aparams, pparams = abstract_params(specs), param_pspecs(specs)
    Bax = _batch_axes(rules)
    meta = {"n_params": param_count(specs), "family": "lm", "cfg": cfg}
    # the reference's Megatron sequence parallelism of the residual stream
    sp_rules = replace(rules, seq=rules.model) if rules.model else rules

    if sh["kind"] == "train":
        # the reference's policy: dense LMs on the single pod train pure
        # FSDP (batch over data x model, parameters over both axes)
        single_pod = "pod" not in (rules.batch or ()) and rules.model is not None
        if single_pod and cfg.moe is None and batch % 256 == 0:
            cfg = replace(cfg, fsdp_axis=("data", "model"), pure_fsdp=True, microbatches=1)
            t_rules = T.ShardingRules(batch=("data", "model"), model=None, seq=None)
            Bax_t = ("data", "model")
        else:
            t_rules, Bax_t = sp_rules, Bax
        specs_t = T.param_specs(cfg)
        aparams_t, pparams_t = abstract_params(specs_t), param_pspecs(specs_t)
        meta["cfg"] = cfg
        mdt = torch.bfloat16 if cfg.param_dtype == torch.bfloat16 else torch.float32

        def bind(mesh):
            r = replace(t_rules, mesh=mesh)
            return make_train_step(lambda p, b: T.lm_loss(p, b, cfg, r), _opt_for(cfg),
                                   microbatches=cfg.microbatches, mesh=mesh if r.sharded else None, pspecs=pparams_t)

        meta["bind"] = bind
        fn = bind(None)
        args = (aparams_t, _abstract_opt(aparams_t, mdt), {"tokens": _abstract((batch, seq), torch.int32)})
        pspecs = (pparams_t, _opt_pspecs(pparams_t), {"tokens": (Bax_t, None)})
        out_ps = (pparams_t, _opt_pspecs(pparams_t), {"loss": (), "xent": (), "aux": ()})
        meta["tokens"] = batch * (seq - 1)
        return Cell(arch, shape_id, "train", fn, args, pspecs, donate=(0, 1), out_pspecs=out_ps, meta=meta)

    if sh["kind"] == "prefill":
        meta["bind"] = lambda mesh: lambda params, tokens: T.prefill(params, tokens, cfg,
                                                                      replace(sp_rules, mesh=mesh), max_seq=seq)
        fn = meta["bind"](None)
        args = (aparams, _abstract((batch, seq), torch.int32))
        pspecs = (pparams, (Bax, None))
        cache_ps = (None, Bax, None, "model", None)
        out_ps = ((Bax, None), T.KVCache(k=cache_ps, v=cache_ps, pos=()))
        meta["tokens"] = batch * seq
        return Cell(arch, shape_id, "prefill", fn, args, pspecs, out_pspecs=out_ps, meta=meta)

    if sh["kind"] == "decode":
        cshape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.d_head)
        acache = T.KVCache(k=_abstract(cshape, cfg.dtype), v=_abstract(cshape, cfg.dtype),
                           pos=_abstract((), torch.int32))
        cache_ps = (None, Bax, None, "model", None)
        pcache = T.KVCache(k=cache_ps, v=cache_ps, pos=())
        meta["bind"] = lambda mesh: lambda params, cache, tokens: T.decode_step(params, cache, tokens, cfg,
                                                                                 replace(rules, mesh=mesh))
        fn = meta["bind"](None)
        args = (aparams, acache, _abstract((batch,), torch.int32))
        pspecs = (pparams, pcache, (Bax,))
        meta["tokens"] = batch
        return Cell(arch, shape_id, "decode", fn, args, pspecs, donate=(1,),
                    out_pspecs=((Bax, None), pcache), meta=meta)

    if sh["kind"] == "retrieval_decode":
        cs = cfg.retrieval.cluster_size
        nC = -(-seq // cs)
        kv = (cfg.n_layers, batch, cfg.n_kv_heads, nC, cs, cfg.d_head)
        ce = (cfg.n_layers, batch, cfg.n_kv_heads, nC, cfg.d_head)
        seq_ax = (tuple(rules.batch) + ("model",)) if rules.batch else None
        acache = ClusteredKVCache(k=_abstract(kv, cfg.dtype), v=_abstract(kv, cfg.dtype),
                                  centroids=_abstract(ce, torch.float32), pos=_abstract((), torch.int32))
        kv_ps = (None, None, None, seq_ax, None, None)
        pcache = ClusteredKVCache(k=kv_ps, v=kv_ps, centroids=(None, None, None, seq_ax, None), pos=())
        meta["bind"] = lambda mesh: lambda params, cache, tokens: T.retrieval_decode_step(
            params, cache, tokens, cfg, replace(rules, mesh=mesh))
        fn = meta["bind"](None)
        args = (aparams, acache, _abstract((batch,), torch.int32))
        pspecs = (pparams, pcache, (None,))
        meta["tokens"] = batch
        meta["n_clusters"] = nC
        return Cell(arch, shape_id, "retrieval_decode", fn, args, pspecs, donate=(1,),
                    out_pspecs=((None, None), pcache), meta=meta)

    raise ValueError(sh["kind"])


# ------------------------------------------------------------------ GNN
def _gnn_cell(arch: str, cfg0, shape_id: str, sh: dict, rules) -> Cell:
    Bax = _batch_axes(rules)
    node_ax = (tuple(rules.batch) + ("model",)) if rules.batch else None
    f32, i32 = torch.float32, torch.int32

    if sh["kind"] == "full_graph":
        cfg = replace(cfg0, d_in=sh["d_feat"], n_classes=sh["n_classes"])
        loss = gnn.gnn_loss_full
        # node and edge counts padded to shard-divisible sizes (512 covers
        # both production meshes); pads carry edge_weight 0 / label_mask 0
        mult = 512
        N = -(-sh["n_nodes"] // mult) * mult
        E = -(-sh["n_edges"] // mult) * mult
        batch = {"feats": _abstract((N, sh["d_feat"]), f32), "edge_src": _abstract((E,), i32),
                 "edge_dst": _abstract((E,), i32), "edge_weight": _abstract((E,), f32),
                 "labels": _abstract((N,), i32), "label_mask": _abstract((N,), f32)}
        pbatch = {"feats": (node_ax, None), **{k: (node_ax,) for k in batch if k != "feats"}}
    elif sh["kind"] == "sampled":
        cfg = replace(cfg0, d_in=sh["d_feat"], n_classes=sh["n_classes"], fanouts=sh["fanouts"])
        loss = gnn.gnn_loss_sampled
        B, d = sh["batch_nodes"], sh["d_feat"]
        f1, f2 = sh["fanouts"]
        batch = {"hops": (_abstract((B, f1, f2, d), f32), _abstract((B, f1, d), f32), _abstract((B, d), f32)),
                 "labels": _abstract((B,), i32)}
        pbatch = {"hops": ((Bax, None, None, None), (Bax, None, None), (Bax, None)), "labels": (Bax,)}
    elif sh["kind"] == "graphs":
        cfg = replace(cfg0, d_in=sh["d_feat"], n_classes=sh["n_classes"])
        loss = gnn.gnn_loss_graphs
        G, N, E = sh["batch"], sh["n_nodes"], sh["n_edges"]
        batch = {"feats": _abstract((G, N, sh["d_feat"]), f32), "edge_src": _abstract((G, E), i32),
                 "edge_dst": _abstract((G, E), i32), "node_mask": _abstract((G, N), f32),
                 "labels": _abstract((G,), i32)}
        pbatch = {"feats": (Bax, None, None), "edge_src": (Bax, None), "edge_dst": (Bax, None),
                  "node_mask": (Bax, None), "labels": (Bax,)}
    else:
        raise ValueError(sh["kind"])
    specs = gnn.param_specs(cfg)
    aparams, pparams = abstract_params(specs), param_pspecs(specs)
    # the rows a rank's loss averages: the nodes (full graph), else the batch
    axes = node_ax if sh["kind"] == "full_graph" else Bax
    mesh_kw = {"n_nodes": N} if sh["kind"] == "full_graph" else {}

    def bind(mesh):
        """The train step (on ``mesh``: of the rank's shards).  The loss is
        the mean over every rank's rows (``softmax_xent`` on the mesh).
        Full graph: the nodes split over every axis, a rank's share its
        masked sum over the whole mask's.  Sampled and batched graphs: the
        batch splits over the batch axes and every "model" rank holds the
        same rows, so a rank's share is its rows' sum over the batch and
        over the "model" extent: the replicas' equal shares sum to the
        one-device loss, and each gradient, summed over every axis (the
        weights are replicated), and the clipping norm count a row once."""
        return make_train_step(lambda p, b: loss(p, b, cfg, mesh=mesh, axes=axes, **mesh_kw), adamw(3e-3),
                               mesh=mesh, pspecs=pparams)

    args = (aparams, _abstract_opt(aparams, f32), batch)
    pspecs = (pparams, _opt_pspecs(pparams), pbatch)
    meta = {"n_params": param_count(specs), "family": "gnn", "cfg": cfg, "bind": bind,
            "out_pspecs": (pparams, _opt_pspecs(pparams), {"loss": ()})}
    if sh["kind"] == "full_graph":
        meta.update(n_nodes=sh["n_nodes"], n_edges=sh["n_edges"])
    return Cell(arch, shape_id, "train", bind(None), args, pspecs, donate=(0, 1), meta=meta)


# --------------------------------------------------------------- recsys
def _recsys_batch_specs(cfg, batch: int, *, labeled: bool) -> dict:
    n_plain = cfg.n_fields - cfg.seq_fields
    out = {"cat": _abstract((batch, n_plain), torch.int32)}
    if cfg.n_dense:
        out["dense"] = _abstract((batch, cfg.n_dense), torch.float32)
    if cfg.seq_len:
        out["seq"] = _abstract((batch, cfg.seq_len, cfg.seq_fields), torch.int32)
        out["seq_mask"] = _abstract((batch, cfg.seq_len), torch.float32)
        out["target"] = _abstract((batch, cfg.seq_fields), torch.int32)
    if labeled:
        out["label"] = _abstract((batch,), torch.float32)
    return out


def _recsys_batch_pspecs(batch_specs: dict, Bax) -> dict:
    # batch-1 cells (retrieval_cand) cannot shard their batch dim
    return {k: ((Bax if v.shape[0] > 1 else None),) + (None,) * (v.ndim - 1) for k, v in batch_specs.items()}


def _recsys_cell(arch: str, cfg, shape_id: str, sh: dict, rules) -> Cell:
    Bax = _batch_axes(rules)
    specs = recsys.param_specs(cfg)
    aparams, pparams = abstract_params(specs), param_pspecs(specs)
    meta = {"n_params": param_count(specs), "family": "recsys", "cfg": cfg}

    if sh["kind"] == "train":
        def bind(mesh):
            """The train step (on ``mesh``: of the rank's shards).  The
            table's rows split over "model", the batch over the batch
            axes, so every "model" rank holds the same rows: a rank's share
            of the loss is its rows' sum over the batch and over the
            "model" extent (``bce_logits`` on the mesh), so that the shares
            sum to the one-device loss and each gradient, summed over the
            axes its weight is replicated on, and the clipping norm count
            a row once."""
            return make_train_step(lambda p, b: recsys.recsys_loss(p, b, cfg, mesh=mesh, axes=Bax), adamw(1e-3),
                                   mesh=mesh, pspecs=pparams)

        bs = _recsys_batch_specs(cfg, sh["batch"], labeled=True)
        args = (aparams, _abstract_opt(aparams, torch.float32), bs)
        pspecs = (pparams, _opt_pspecs(pparams), _recsys_batch_pspecs(bs, Bax))
        meta.update(bind=bind, out_pspecs=(pparams, _opt_pspecs(pparams), {"loss": ()}))
        return Cell(arch, shape_id, "train", bind(None), args, pspecs, donate=(0, 1), meta=meta)

    if sh["kind"] == "serve":
        meta["bind"] = lambda mesh: lambda params, batch: torch.sigmoid(recsys.forward(params, batch, cfg, mesh=mesh))
        bs = _recsys_batch_specs(cfg, sh["batch"], labeled=False)
        meta["out_pspecs"] = (Bax if sh["batch"] > 1 else None,)
        return Cell(arch, shape_id, "serve", meta["bind"](None), (aparams, bs), (pparams, _recsys_batch_pspecs(bs, Bax)),
                    meta=meta)

    if sh["kind"] == "retrieval":
        n_cand = sh["n_candidates"]
        n_pad = -(-n_cand // 512) * 512 if n_cand > 512 else n_cand
        cand_ax = (tuple(rules.batch) + ("model",)) if rules.batch else None
        bs = _recsys_batch_specs(cfg, sh["batch"], labeled=False)

        def bind(mesh):
            """One device: the reference scores all n_pad rows and masks the
            pad rows to -inf; with n_cand >= 100 the top 100 of the first
            n_cand are the same (one launch of distance_topk's k < N path
            on the card).  On ``mesh``: the candidates over every axis, the
            request and the query alike on every rank; each rank's valid
            rows through the kernel, once, and the ranks' lists merged."""
            if mesh is None:
                return lambda params, batch, cand_emb: recsys.candidate_scores(
                    recsys.user_tower(params, batch, cfg), cand_emb[:n_cand], 100)
            return lambda params, batch, cand_emb: recsys.candidate_scores_sharded(
                recsys.user_tower(params, batch, cfg, mesh=mesh), cand_emb, 100, mesh=mesh, axes=cand_ax,
                n_rows=n_pad, n_valid=n_cand)

        args = (aparams, bs, _abstract((n_pad, cfg.embed_dim), torch.float32))
        pspecs = (pparams, _recsys_batch_pspecs(bs, Bax), (cand_ax, None))
        meta.update(n_candidates=n_cand, bind=bind, out_pspecs=((None, None), (None, None)))
        return Cell(arch, shape_id, "retrieval", bind(None), args, pspecs, meta=meta)

    raise ValueError(sh["kind"])


# ------------------------------------------------------------------ API
def build_cell(arch_id: str, shape_id: str, *, mesh_axes=("data", "model"), reduced: bool = False,
               batch: int | None = None) -> Cell:
    """The cell of ``arch_id`` x ``shape_id``; ``reduced``: the smoke-scale
    config and shape (``_reduce_shape``); ``batch``: the shape's batch
    replaced (the dry run's search for a batch that fits one card)."""
    family, cfg = get_arch(arch_id, reduced=reduced)
    sh = dict(arch_shapes(arch_id)[shape_id])
    rules = make_rules(mesh_axes) if mesh_axes else T.ShardingRules()
    if reduced:
        sh = _reduce_shape(family, sh)
    if batch is not None:
        sh["batch"] = batch
    if family == "lm":
        return _lm_cell(arch_id, cfg, shape_id, sh, rules)
    if family == "gnn":
        return _gnn_cell(arch_id, cfg, shape_id, sh, rules)
    if family == "recsys":
        return _recsys_cell(arch_id, cfg, shape_id, sh, rules)
    raise ValueError(family)


@dataclass
class Lowered:
    """A cell bound to a mesh (the reference's ``jit(..., in_shardings,
    out_shardings)``).  ``step(*local_args)`` is this rank's step on its
    shards; calling the object takes the cell's whole inputs (numpy,
    tensors or ``DTensor``s), cuts this rank's shards by ``in_pspecs``
    (``local_args``), runs the step and lays the outputs out by
    ``out_pspecs`` as ``DTensor``s (``place``)."""

    cell: Cell
    mesh: Any
    step: Callable

    @property
    def out_pspecs(self):
        """The outputs' placements: the reference's ``out_pspecs``, or the
        port's where the reference sets none (GraphSAGE, recsys)."""
        return self.cell.out_pspecs if self.cell.out_pspecs is not None else self.cell.meta["out_pspecs"]

    def local_args(self, args) -> tuple:
        return local_tree(tuple(args), self.mesh, self.cell.in_pspecs)

    def place(self, out):
        return map_specs(lambda t, ps: _as_dtensor(t, self.mesh, ps), out, self.out_pspecs)

    def __call__(self, *args):
        return self.place(self.step(*self.local_args(args)))


def _as_dtensor(t: torch.Tensor, mesh, ps):
    """This rank's shard ``t`` as a ``DTensor`` of spec ``ps``; the whole
    shape sums the shards' lengths over each sharded dim's axes."""
    from torch.distributed.tensor import DTensor

    shape = list(t.shape)
    for dim, e in enumerate(ps):
        if axes_of(e):
            n = C.all_reduce(torch.full((), t.shape[dim], dtype=torch.int64, device=t.device), mesh, e)
            shape[dim] = int(n.item())
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t.contiguous(), mesh, placements(mesh, ps, t.ndim), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def lower_cell(cell: Cell, mesh) -> Lowered:
    """Bind ``cell``'s step to ``mesh`` (a ``DeviceMesh`` whose axis names
    the cell was built with): the step takes the rank's shards, a train
    step sums its gradients over replica axes (``make_train_step``).
    Every family: the LM cells' rules carry the mesh, the GraphSAGE and
    recsys steps take it (``_gnn_cell``, ``_recsys_cell``)."""
    if "bind" not in cell.meta or (cell.out_pspecs is None and "out_pspecs" not in cell.meta):
        raise ValueError(f"{cell.arch} x {cell.shape} has no step to bind")
    return Lowered(cell, mesh, cell.meta["bind"](mesh))


def _reduce_shape(family: str, sh: dict) -> dict:
    sh = dict(sh)
    if family == "lm":
        sh["seq"] = min(sh["seq"], 64 if sh["kind"] != "retrieval_decode" else 128)
        sh["batch"] = min(sh["batch"], 4)
    elif family == "gnn":
        if sh["kind"] == "full_graph":
            sh.update(n_nodes=200, n_edges=800, d_feat=16, n_classes=5)
        elif sh["kind"] == "sampled":
            sh.update(batch_nodes=8, fanouts=(3, 2), d_feat=16, n_classes=5)
        else:
            sh.update(batch=4, n_nodes=10, n_edges=20, d_feat=16, n_classes=5)
    else:
        sh["batch"] = min(sh["batch"], 16)
        if sh["kind"] == "retrieval":
            sh["n_candidates"] = 1000
    return sh


def _param_specs(cell: Cell):
    cfg = cell.meta["cfg"]
    return {"lm": T.param_specs, "gnn": gnn.param_specs, "recsys": recsys.param_specs}[cell.meta["family"]](cfg)


def map_args(fn, tree, path: str = "", *, pos: int | None = None):
    """``fn(path, leaf)`` over the tensor leaves of a cell's args, in the
    order and with the names of the reference's
    ``jax.tree_util.tree_map_with_path`` over the same tree: dict keys
    sorted, list and tuple entries by index, and a cache's fields by their
    index in the flattened cache (its leaves have no names there).  A
    cache's ``pos`` comes back as a Python int: ``pos`` when given (and
    ``fn`` is not called for it), the cache's own where it is an int
    already (concrete args), else ``int`` of ``fn``'s result."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        done = {k: map_args(fn, tree[k], join(k), pos=pos) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [map_args(fn, v, join(i), pos=pos) for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    if isinstance(tree, _CACHES):
        vals = {f.name: map_args(fn, getattr(tree, f.name), join(i), pos=pos)
                for i, f in enumerate(fields(tree)) if f.name != "pos"}
        p = tree.pos if pos is None else pos
        if isinstance(p, torch.Tensor):
            p = fn(join(len(vals)), p)
        return type(tree)(**vals, pos=int(p))
    return fn(path, tree)


def arg_leaves(tree) -> list:
    """The tensors of a cell's args in ``map_args``'s order, a cache's
    fields (and its ``pos`` where it is a tensor) included."""
    if isinstance(tree, _CACHES):
        return [t for f in fields(tree) for t in arg_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in arg_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in arg_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def example_inputs(cell: Cell, seed: int = 0, *, device="cuda"):
    """Concrete inputs of ``cell`` on ``device``.  Parameters come from the
    port's ``init_params`` with a ``torch.Generator`` on the device seeded
    with ``seed``; every other leaf follows the reference's rule, drawn
    from ``numpy.random.default_rng(seed)`` in the reference's leaf order,
    so these leaves equal the reference's bit for bit: integers 0/1
    (``step`` and ``pos`` 0, by name: a cache's ``pos`` has none, so it is
    drawn), ``mask`` and ``weight`` leaves ones, other floats zeros."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def concrete(name: str, leaf: torch.Tensor) -> torch.Tensor:
        if leaf.dtype in (torch.int32, torch.int64):
            if name.endswith("step") or name.endswith("pos"):
                return torch.zeros(leaf.shape, dtype=leaf.dtype, device=dev)
            return torch.from_numpy(rng.integers(0, 2, size=leaf.shape)).to(device=dev, dtype=leaf.dtype)
        if "mask" in name or "weight" in name:
            return torch.ones(leaf.shape, dtype=leaf.dtype, device=dev)
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=dev)

    out = []
    for i, a in enumerate(cell.args):
        if i == 0 and isinstance(a, dict) and "cfg" in cell.meta:
            gen = torch.Generator(device=dev).manual_seed(seed)
            out.append(init_params(_param_specs(cell), gen, device=dev))
        else:
            out.append(map_args(concrete, a))
    return tuple(out)


def live_inputs(cell: Cell, seed: int = 0, *, device="cuda"):
    """``example_inputs`` of a GraphSAGE or recsys cell with a batch the
    step's every path reads, drawn from a ``torch.Generator`` on the device
    seeded with ``seed + 1``: features and dense fields standard normal,
    labels uniform over the classes (recsys: 0/1), masks 0/1; a full
    graph's edges uniform over its real nodes, weight 1 on its real edges
    and 0 on the pads, its label mask 0 on the pad nodes; a batch of
    graphs' edges uniform within each graph; each recsys field's ids
    uniform over the field's vocabulary; retrieval candidates standard
    normal.  (``example_inputs``' zero features and 0/1 ids leave the
    message passing and most of the table unread.)"""
    dev = resolve_device(device)
    args = list(example_inputs(cell, seed, device=dev))
    cfg, family = cell.meta["cfg"], cell.meta["family"]
    if family == "lm":
        raise ValueError("live_inputs: GraphSAGE and recsys cells only")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    normal = lambda t: torch.randn(t.shape, generator=g, device=dev, dtype=t.dtype)
    below = lambda t, n: torch.randint(0, n, t.shape, generator=g, device=dev).to(t.dtype)
    coin = lambda t: below(t, 2)
    first = lambda t, n: (torch.arange(t.shape[0], device=dev) < n).to(t.dtype)
    i = 2 if cell.kind == "train" else 1
    b = args[i]
    if family == "gnn":
        out = {"labels": below(b["labels"], cfg.n_classes)}
        if "hops" in b:
            out["hops"] = tuple(normal(h) for h in b["hops"])
        elif "node_mask" in b:
            n = b["feats"].shape[1]
            out.update(feats=normal(b["feats"]), edge_src=below(b["edge_src"], n),
                       edge_dst=below(b["edge_dst"], n), node_mask=coin(b["node_mask"]))
        else:
            n = cell.meta["n_nodes"]
            out.update(feats=normal(b["feats"]), edge_src=below(b["edge_src"], n),
                       edge_dst=below(b["edge_dst"], n), edge_weight=first(b["edge_weight"], cell.meta["n_edges"]),
                       label_mask=coin(b["label_mask"]) * first(b["label_mask"], n))
    else:
        vocab = torch.tensor(cfg.field_vocabs, dtype=torch.float64, device=dev)
        field = lambda t, v: (torch.rand(t.shape, generator=g, dtype=torch.float64, device=dev) * v).to(t.dtype)
        out = {"cat": field(b["cat"], vocab[cfg.seq_fields:])}
        if "dense" in b:
            out["dense"] = normal(b["dense"])
        if "seq" in b:
            out.update(seq=field(b["seq"], vocab[:cfg.seq_fields]), seq_mask=coin(b["seq_mask"]),
                       target=field(b["target"], vocab[:cfg.seq_fields]))
        if "label" in b:
            out["label"] = coin(b["label"])
    args[i] = {k: out[k] for k in b}
    if cell.kind == "retrieval":
        args[2] = normal(args[2])
    return tuple(args)


def args_from_jax(cell: Cell, ref_args, *, device="cuda"):
    """The reference's concrete inputs of the same cell (its
    ``example_inputs``; arrays numpy can read) as the port's: parameters
    and the AdamW moments through ``params_from_jax`` in the abstract
    args' dtypes (an LM's stacked layers become per-layer dicts), the
    AdamW ``step`` a 0-d int32 tensor, a ``KVCache`` or
    ``ClusteredKVCache`` the port's with ``pos`` an int, every other leaf
    a tensor of its own dtype."""
    dev = resolve_device(device)
    cfg = cell.meta.get("cfg")
    conv = lambda x: torch.from_numpy(np.array(x)).to(dev)

    def params(ref, like):
        dtype = tree_leaves(like)[0].dtype
        return params_from_jax(ref, cfg, device=dev, dtype=dtype)

    def carry(ref, like):
        if isinstance(like, dict) and set(like) == {"mu", "nu", "step"}:
            return {"mu": params(ref["mu"], like["mu"]), "nu": params(ref["nu"], like["nu"]),
                    "step": conv(ref["step"]).to(torch.int32)}
        if isinstance(like, _CACHES):
            vals = {f.name: conv(getattr(ref, f.name)) for f in fields(like) if f.name != "pos"}
            return type(like)(**vals, pos=int(np.asarray(ref.pos)))
        if isinstance(like, dict):
            return {k: carry(ref[k], v) for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            out = [carry(r, v) for r, v in zip(ref, like)]
            return tuple(out) if isinstance(like, tuple) else out
        return conv(ref)

    return tuple(params(r, a) if i == 0 and "cfg" in cell.meta else carry(r, a)
                 for i, (r, a) in enumerate(zip(ref_args, cell.args)))
