"""Meshes for the production topology, and a rank's view of one.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"): "pod"
is a second, slow data-parallel axis (gradients cross it once a step).

The reference's ``launch/mesh.py`` as ``torch.distributed.device_mesh``:
a ``DeviceMesh`` over the process group's ranks, one rank a process.  The
reference's ``set_mesh`` / ``get_abstract_mesh`` / ``shard_map`` are jax
version shims with no counterpart here: the port passes the mesh
explicitly (``ShardingRules.mesh``), and each of the reference's
``shard_map`` bodies is a function of the rank's own shards.

How a dimension is split (``local_range``): a partition-spec entry names
one mesh axis or a tuple of them; over each axis in turn the dimension
(or the part of it the previous axis left) is cut as ``torch.chunk`` cuts
it, ``ceil(n / size)`` a rank, so that the last ranks may hold less or
nothing.  That is ``DTensor``'s ``Shard`` on those mesh dims, and, where
the sizes divide, the reference's ``NamedSharding``.  A tuple must list
its axes in mesh order.

``process_group`` sets the process group up and tears it down: NCCL on the
card, gloo on the CPU, the fake backend for the dry run's traces at 256
and 512 ranks.  It rendezvouses through a ``FileStore`` (or a store the
caller gives), never a fixed port: test files run side by side.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = [
    "make_production_mesh", "make_host_mesh", "batch_axes_of", "process_group", "axes_of", "axis_size",
    "axis_index", "chunk_range", "local_range", "local_shape", "local_shard", "placements",
]


@contextlib.contextmanager
def process_group(rank: int = 0, world_size: int = 1, *, init_file=None, store=None, backend: str | None = None):
    """The default process group of ``world_size`` ranks, this process rank
    ``rank``, for the ``with`` block; destroyed on exit.  Rendezvous through
    ``store``, else a ``FileStore`` at ``init_file`` (a path every rank
    names alike); ``backend`` defaults to NCCL where CUDA is available,
    else gloo; "fake" takes ``FakeStore`` and needs neither."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already set up in this process")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if store is None:
        if backend == "fake":
            from torch.testing._internal.distributed.fake_pg import FakeStore

            store = FakeStore()
        elif init_file is None:
            raise ValueError("process_group needs init_file or store to rendezvous")
        else:
            store = dist.FileStore(str(init_file), world_size)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(multi_pod: bool = False, *, device_type: str | None = None) -> DeviceMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"): the process group must hold 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type or _device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(*, device_type: str | None = None) -> DeviceMesh:
    """(1, n) over ("data", "model") with n the process group's ranks; on
    one card (1, 1): every axis exists, of extent 1."""
    n = dist.get_world_size()
    return init_device_mesh(device_type or _device_type(), (1, n), mesh_dim_names=("data", "model"))


def batch_axes_of(mesh: DeviceMesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axes_of(entry) -> tuple:
    """A partition-spec entry (None, an axis name or a tuple of names) as a
    tuple of names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def axis_size(mesh: DeviceMesh, axes) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes_of(axes))


def axis_index(mesh: DeviceMesh, axes) -> int:
    """This rank's index along ``axes`` taken as one axis, the first the
    most significant: ``off = off * size(a) + index(a)``, the reference's
    rank offset over ``seq_axes``."""
    coord = mesh.get_coordinate()
    off = 0
    for a in axes_of(axes):
        i = mesh.mesh_dim_names.index(a)
        off = off * mesh.size(i) + coord[i]
    return off


def chunk_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """The ``index``-th of ``torch.chunk``'s ``parts`` pieces of range(n) as
    (lo, hi): ``ceil(n / parts)`` each, the last ones short or empty."""
    c = -(-n // parts)
    return min(index * c, n), min((index + 1) * c, n)


def local_range(n: int, mesh: DeviceMesh, entry) -> tuple[int, int]:
    """This rank's (lo, hi) of a dimension of length ``n`` split over the
    axes of ``entry``, axis by axis."""
    names = list(mesh.mesh_dim_names)
    axes = axes_of(entry)
    if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
        raise ValueError(f"partition-spec entry {entry!r} lists its axes out of mesh order {tuple(names)}")
    lo, hi = 0, n
    coord = mesh.get_coordinate()
    for a in axes:
        i = names.index(a)
        a_lo, a_hi = chunk_range(hi - lo, mesh.size(i), coord[i])
        lo, hi = lo + a_lo, lo + a_hi
    return lo, hi


def _entries(pspec, ndim: int) -> tuple:
    pspec = tuple(pspec)
    if len(pspec) > ndim:
        raise ValueError(f"partition spec {pspec} has more entries than the {ndim} dims")
    return pspec + (None,) * (ndim - len(pspec))


def local_shape(shape, mesh: DeviceMesh, pspec) -> tuple:
    """The shape of this rank's shard of a tensor of ``shape``."""
    out = []
    for n, e in zip(shape, _entries(pspec, len(shape))):
        lo, hi = local_range(n, mesh, e)
        out.append(hi - lo)
    return tuple(out)


def local_shard(x: torch.Tensor, mesh: DeviceMesh, pspec) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` (a view of it)."""
    for dim, e in enumerate(_entries(pspec, x.ndim)):
        if e is not None:
            lo, hi = local_range(x.shape[dim], mesh, e)
            x = x.narrow(dim, lo, hi - lo)
    return x


def placements(mesh: DeviceMesh, pspec, ndim: int | None = None) -> tuple:
    """``DTensor`` placements of a partition spec: ``Shard(i)`` on each mesh
    dim that entry ``i`` names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    entries = tuple(pspec) if ndim is None else _entries(pspec, ndim)
    for dim, e in enumerate(entries):
        for a in axes_of(e):
            j = mesh.mesh_dim_names.index(a)
            if out[j] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims in {tuple(pspec)}")
            out[j] = Shard(dim)
    return tuple(out)
