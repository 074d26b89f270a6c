"""Collectives over the axes of a mesh, for the sharded steps.

The reference's ``shard_map`` bodies reduce with ``jax.lax.psum`` /
``pmax`` / ``all_gather`` over named axes; here each is a functional
collective (``torch.distributed._functional_collectives``) over the
process groups of a ``DeviceMesh``'s axes.  Several axes act as one,
the first the most significant (``launch.mesh.axis_index``): a gather runs
over the last axis first, a scatter over the first.

Autograd: the gather, the scatter and the sum carry their transposes
(an all-gather's gradient is the reduce-scatter of the ranks' gradients
and the other way round; a sum's is the sum of the ranks' gradients).
That is right when every rank's loss is its share of the loss, the shares
summing to it: ``total`` turns the shares into the loss on every rank with
a backward that passes each rank's gradient through unchanged.

``gather`` and ``scatter`` take the dimension's global length and cut it
as ``launch.mesh.local_range`` does, padding each rank's piece to
``ceil(n / size)`` around the collective: ranks with a short or empty
piece take part all the same.

``mean_of_shares`` is a mean over rows that some axes split and the
others repeat (a loss over a batch- or node-sharded model): each rank's
share is its rows' sum over the whole count and the repeats, so that the
shares sum to the mean and each weight's gradient, summed over the axes
the weight is replicated on, comes out once.

``psum_compressed`` is the cross-pod gradient reduce with int8 codes
(``optim/compress.py``): quantize each leaf, sum the int32 payload over
the slow axis, share the largest scale, dequantize.  Under one device the
same numerics are ``compress_decompress`` on the gradients before the
optimizer, which the trainer runs.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as fc
import torch.nn.functional as F

from ..launch.mesh import axes_of, axis_size, chunk_range
from ..optim.compress import dequantize_int8, quantize_int8
from ..tree import tree_map

__all__ = ["gather", "scatter", "all_reduce", "total", "mean_of_shares", "tree_psum", "psum_compressed"]


# torch 2.13 renames the single-tensor gather and scatter (the old names warn)
_all_gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
_reduce_scatter = getattr(fc, "reduce_scatter_single", None) or fc.reduce_scatter_tensor


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _wait(_all_gather(x.contiguous(), dim, group))

    @staticmethod
    def backward(ctx, g):
        return _wait(_reduce_scatter(g.contiguous(), "sum", ctx.dim, ctx.group)), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _wait(_reduce_scatter(x.contiguous(), "sum", dim, group))

    @staticmethod
    def backward(ctx, g):
        return _wait(_all_gather(g.contiguous(), ctx.dim, ctx.group)), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _wait(fc.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return _wait(fc.all_reduce(g.contiguous(), "sum", ctx.group)), None


class _Total(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _wait(fc.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _pad(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    extra = length - x.shape[dim]
    if not extra:
        return x
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, extra]
    return F.pad(x, pad)


def gather(x: torch.Tensor, mesh, axes, dim: int, n: int) -> torch.Tensor:
    """The whole of a dimension of global length ``n`` that ``axes`` shard,
    on every rank of them: this rank's piece ``x`` joined with the others'
    (``launch.mesh.local_range``'s cut)."""
    dim = dim % x.ndim
    axes = axes_of(axes)
    # the length each prefix of ``axes`` leaves this rank, to undo the cut from the last axis back
    coord = mesh.get_coordinate()
    lengths = [n]
    for a in axes[:-1]:
        i = mesh.mesh_dim_names.index(a)
        lo, hi = chunk_range(lengths[-1], mesh.size(i), coord[i])
        lengths.append(hi - lo)
    for a, m in zip(reversed(axes), reversed(lengths)):
        size = axis_size(mesh, a)
        c = -(-m // size)
        x = _Gather.apply(_pad(x, dim, c), dim, mesh.get_group(a)).narrow(dim, 0, m)
    return x


def scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``axes`` of ``x`` (whole along ``dim``),
    each rank keeping its piece of that dimension."""
    dim = dim % x.ndim
    coord = mesh.get_coordinate()
    for a in axes_of(axes):
        i = mesh.mesh_dim_names.index(a)
        size, m = mesh.size(i), x.shape[dim]
        c = -(-m // size)
        lo, hi = chunk_range(m, size, coord[i])
        x = _Scatter.apply(_pad(x, dim, c * size), dim, mesh.get_group(a)).narrow(dim, 0, hi - lo)
    return x


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``psum`` (``op="sum"``, with its transpose for autograd) or ``pmax``
    (``op="max"``, no gradient) over ``axes``."""
    for a in axes_of(axes):
        if op == "sum":
            x = _Sum.apply(x, mesh.get_group(a))
        elif op == "max":
            x = _wait(fc.all_reduce(x.contiguous(), "max", mesh.get_group(a)))
        else:
            raise ValueError(f"unknown reduction {op!r} (sum|max)")
    return x


def total(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of the ranks' shares ``x`` on every rank of ``axes``; the
    backward pass gives each share the gradient of the total."""
    for a in axes_of(axes):
        x = _Total.apply(x, mesh.get_group(a))
    return x


def mean_of_shares(x_sum: torch.Tensor, count, mesh, axes) -> torch.Tensor:
    """The mean over rows that the ranks of ``axes`` split and the mesh's
    other axes repeat, on every rank, from this rank's sum ``x_sum`` over
    its rows and their ``count`` (a mask's sum where rows are masked).
    The rank's share is ``x_sum / (max(the count over axes, 1) · the
    repeats)``: the repeats' shares are equal, so the shares sum to the
    mean, and ``total`` gives each share the mean's gradient.  A weight's
    gradient summed over the axes it is replicated on then counts every
    row once (``launch.cells._sum_replicas``)."""
    rest = tuple(a for a in mesh.mesh_dim_names if a not in axes_of(axes))
    with torch.no_grad():
        n = all_reduce(torch.as_tensor(count, dtype=torch.float32, device=x_sum.device), mesh, axes)
    share = x_sum / (torch.clamp_min(n, 1.0) * axis_size(mesh, rest))
    return total(share, mesh, mesh.mesh_dim_names)


def tree_psum(tree, mesh, axes):
    return tree_map(lambda x: all_reduce(x, mesh, axes), tree)


@torch.no_grad()
def psum_compressed(tree, mesh, axes):
    """int8-quantized psum over ``axes`` (the cross-pod axis): each leaf's
    codes summed in int32, dequantized with the largest of the ranks'
    scales, back in the leaf's dtype."""

    def leaf(g):
        q, scale = quantize_int8(g)
        tot = all_reduce(q.to(torch.int32), mesh, axes)
        scale = all_reduce(scale, mesh, axes, op="max")
        return dequantize_int8(tot, scale).to(g.dtype)

    return tree_map(leaf, tree)
