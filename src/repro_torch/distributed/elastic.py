"""Elastic scaling: place a state onto a mesh, or reshard it onto another.

Checkpoints are host numpy (``checkpoint/``), so a 512-rank state restores
onto 256 ranks (or one card) without a format change: each leaf goes onto
the new mesh by its partition spec.  The only invariant the caller keeps
is that the global batch is split again over the new "data" extent
(``StepLoader.n_shards``), as the launcher does.

``make_shardings`` gives each leaf's ``DTensor`` placements
(``launch.mesh.placements``); ``reshard_tree`` puts a tree of host numpy
arrays, whole tensors or ``DTensor``s (of any mesh over the same ranks)
onto ``mesh`` as ``DTensor``s; ``local_tree`` gives this rank's shards,
what the sharded steps take.  Each rank cuts its shard from the whole
leaf (``launch.mesh.local_range``), so every rank must hold the whole leaf
or a ``DTensor`` of it.  Trees are dicts, lists, tuples and the LM caches
(dataclasses, whose int ``pos`` passes through); the spec tree has the
data tree's structure with a partition spec (a tuple of entries) at each
leaf.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..launch.mesh import local_shard, placements

__all__ = ["make_shardings", "reshard_tree", "local_tree", "map_specs"]


def map_specs(fn, tree, pspec_tree):
    """``fn(leaf, spec)`` over the leaves of ``tree`` and the partition specs
    at the same places of ``pspec_tree``; ints and None pass through."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, pspec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_specs(fn, v, ps) for v, ps in zip(tree, pspec_tree, strict=True)]
        return tuple(out) if isinstance(tree, tuple) else out
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: map_specs(fn, getattr(tree, f.name), getattr(pspec_tree, f.name))
                             for f in dataclasses.fields(tree)})
    if tree is None or isinstance(tree, int):
        return tree
    return fn(tree, pspec_tree)


def _is_spec(ps) -> bool:
    return isinstance(ps, tuple) and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in ps)


def make_shardings(mesh, pspec_tree):
    """Each partition spec of ``pspec_tree`` as its ``DTensor`` placements."""
    if _is_spec(pspec_tree):
        return placements(mesh, pspec_tree)
    if isinstance(pspec_tree, dict):
        return {k: make_shardings(mesh, v) for k, v in pspec_tree.items()}
    return type(pspec_tree)(make_shardings(mesh, v) for v in pspec_tree)


def _whole(x, device) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.full_tensor().to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def mesh_device(mesh) -> torch.device:
    """Where a mesh keeps this rank's tensors: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_tree(tree, mesh, pspec_tree):
    """This rank's shard of every leaf (numpy, a whole tensor or a
    ``DTensor``) by its partition spec, on the mesh's device."""
    dev = mesh_device(mesh)
    return map_specs(lambda x, ps: local_shard(_whole(x, dev), mesh, ps).contiguous(), tree, pspec_tree)


def reshard_tree(tree, mesh, pspec_tree):
    """Place a (host, whole or ``DTensor``) tree onto ``mesh`` by the given
    specs: a tree of ``DTensor``s."""
    from torch.distributed.tensor import DTensor

    dev = mesh_device(mesh)

    def leaf(x, ps):
        whole = _whole(x, dev).contiguous()
        return DTensor.from_local(local_shard(whole, mesh, ps).contiguous(), mesh, placements(mesh, ps, whole.ndim),
                                  run_check=False, shape=whole.shape, stride=whole.stride())

    return map_specs(leaf, tree, pspec_tree)
