"""Parameter specs, initialisation and the carry-over of the reference's weights.

A model declares its parameters once as a tree (dicts and lists) of
``ParamSpec`` leaves; ``init_params`` draws them with a ``torch.Generator``
from the reference's distributions (``repro.models.base``: ``fan_in``,
``normal``, ``embed``, ``zeros``, ``ones``), and ``param_count`` counts
them.  The values differ from ``jax.random``'s; the distributions are the
same.  ``abstract_params`` gives the same tree as tensors on the meta
device (shape and dtype, no storage: what the dry run traces from),
``param_pspecs`` each leaf's mesh-axis names (the reference's
``PartitionSpec`` entries, as plain tuples) and ``param_bytes`` the bytes
at the specs' dtypes.  ``params_from_jax`` carries a parameter tree the reference made
(as numpy arrays) into the port's layout, so that tests run both packages
on the same weights; ``shard_params`` cuts a whole tree into this rank's
shards on a mesh by the specs' partition specs (what the sharded model
functions take).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_leaves, tree_map

__all__ = ["ParamSpec", "init_params", "abstract_params", "param_pspecs", "param_count", "param_bytes",
           "params_from_jax", "shard_params"]


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: Any = torch.float32
    pspec: tuple = ()                 # mesh-axis names a dim, e.g. (None, "model")
    init: str = "fan_in"              # fan_in | normal | zeros | ones | embed
    scale: float | None = None        # stddev override
    fan_in_axis: int = -2             # axis treated as fan-in for scaling


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device, dtype) -> torch.Tensor:
    dtype = dtype or spec.dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 0.02
    elif spec.init == "normal":
        std = spec.scale if spec.scale is not None else 1.0
    elif spec.init == "fan_in":
        fan = spec.shape[spec.fan_in_axis] if len(spec.shape) >= 2 else spec.shape[0]
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def init_params(spec_tree, generator: torch.Generator, *, device="cuda", dtype=None):
    """Draw every leaf of ``spec_tree`` in float32 on ``device`` from
    ``generator`` (which must live on that device), leaf by leaf in tree
    order, and store it as ``dtype`` (default: the spec's own dtype)."""
    dev = resolve_device(device)
    return tree_map(lambda s: _init_leaf(s, generator, dev, dtype), spec_tree)


def abstract_params(spec_tree):
    """Each leaf as an empty tensor of its shape and dtype on the meta
    device: no storage, no generator, no card."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), spec_tree)


def param_pspecs(spec_tree):
    """Each leaf's ``pspec``: a tuple of mesh-axis names (or tuples of
    them, or None) a dimension, () for a replicated leaf."""
    return tree_map(lambda s: tuple(s.pspec), spec_tree)


def param_count(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(spec_tree))


def param_bytes(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize for s in tree_leaves(spec_tree))


def params_from_jax(tree, cfg, *, device="cuda", dtype=None):
    """A parameter tree the reference made (``repro.models.base.init_params``
    of a ``param_specs``; arrays that numpy can read) -> the port's, by the
    config's type.  A recsys or GNN tree keeps its structure: every array
    becomes a float32 tensor on ``device``.  An LM tree: the stacked
    ``[L, ...]`` layer arrays (dense or MoE: ``router``, ``we_*``) become a
    list of ``cfg.n_layers`` per-layer dicts; with ``moe_every=2`` the
    reference's ``{"dense": [L/2, ...], "moe": [L/2, ...]}`` blocks become
    each block's dense layer, then its MoE layer.  Every LM array is cast
    once to ``dtype``: ``cfg.dtype`` by default (serving: what the
    reference's per-use casts give), ``cfg.param_dtype`` for training's
    master weights.  Any tree of the parameters' shape converts alike, so
    the reference's AdamW moments (``mu``, ``nu``) carry across too."""
    from .transformer import LMConfig

    dev = resolve_device(device)
    if not isinstance(cfg, LMConfig):
        return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev), tree)
    dtype = dtype or cfg.dtype

    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    def unstack(stacked, n):
        return [{k: conv(np.asarray(v)[i]) for k, v in stacked.items()} for i in range(n)]

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    if "dense" in layers:
        blocks = zip(unstack(layers["dense"], cfg.n_layers // 2), unstack(layers["moe"], cfg.n_layers // 2))
        out["layers"] = [lp for pair in blocks for lp in pair]
    else:
        out["layers"] = unstack(layers, cfg.n_layers)
    return out


def shard_params(params, spec_tree, mesh):
    """This rank's shard of every leaf of ``params`` (whole tensors, numpy
    arrays or ``DTensor``s) on ``mesh``, by ``param_pspecs(spec_tree)``."""
    from ..distributed.elastic import local_tree

    return local_tree(params, mesh, param_pspecs(spec_tree))
