"""The port's meshes (``repro_torch.launch.mesh``), placements
(``distributed.elastic.make_shardings``) and the dry run on the production
meshes, on this CPU.

The production meshes (16 x 16 = 256 ranks, 2 x 16 x 16 = 512) stand on
the fake process group: each trace is one rank, its args that rank's
shards as fake tensors.  Held: placements of the pspec entries None,
"model" and ("data", "model"); ``batch_axes_of``; a dimension's cut
against ``torch.chunk``; and the traces of 2-layer, full-width cells of
phi4-mini (``prefill_32k`` with the flash kernel, ``decode_32k``) and
llama4-scout (``train_4k``): the rank's argument bytes equal a reckoning
from the reference's partition specs with each dimension cut ceil(n /
shards) (rank 0's share: the reference's ``dryrun.py`` floors, GSPMD
pads), and at Hq = 24 over 16 model ranks rank 0 (2 heads) launches the
flash kernel once a layer and the mesh's last rank (model index 15, past
the 12th) holds no head and launches nothing.  The
GraphSAGE and recsys cells on a mesh raise naming ROADMAP Queue 1 #13
part 3.
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.launch import cells as RC
from repro_torch.configs import ALL_CELLS, arch_shapes, get_arch
from repro_torch.launch import cells as PC
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import batch_axes_of, chunk_range, local_range, make_production_mesh, process_group

MESHES = {"single": (256, (16, 16), ("data", "model")), "multi": (512, (2, 16, 16), ("pod", "data", "model"))}
TRACED = (("phi4-mini-3.8b", "prefill_32k"), ("phi4-mini-3.8b", "decode_32k"), ("llama4-scout-17b-a16e", "train_4k"))
OTHER_CELLS = [(a, s) for a, s in ALL_CELLS if get_arch(a)[0] != "lm"]


@pytest.mark.parametrize("name", ["single", "multi"])
def test_production_meshes_and_placements(name):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.elastic import make_shardings

    ranks, shape, axes = MESHES[name]
    with process_group(0, ranks, backend="fake"):
        mesh = make_production_mesh(name == "multi")
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
        assert batch_axes_of(mesh) == axes[:-1]
        R, S = Replicate(), Shard
        lead = (R,) * (len(shape) - 2)
        got = make_shardings(mesh, {"w": (None, "model"), "e": ("model", None), "r": (None,),
                                    "f": (("data", "model"), None), "b": ("data", None, "model")})
        assert got == {"w": lead + (R, S(1)), "e": lead + (R, S(0)), "r": lead + (R, R),
                       "f": lead + (S(0), S(0)), "b": lead + (S(0), S(2))}
    with process_group(0, 8, backend="fake"), pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()


@pytest.mark.parametrize("n,parts", [(24, 16), (28, 16), (40, 16), (200064, 16), (31, 4), (3, 8), (0, 4)])
def test_a_dimension_is_cut_as_torch_chunk_cuts_it(n, parts):
    pieces = [len(c) for c in torch.arange(n).chunk(parts)] if n else []
    pieces += [0] * (parts - len(pieces))
    assert [chunk_range(n, parts, i)[1] - chunk_range(n, parts, i)[0] for i in range(parts)] == pieces


def test_a_tuple_entry_cuts_axis_by_axis_in_mesh_order():
    with process_group(37, 256, backend="fake"):     # coordinate (2, 5)
        mesh = make_production_mesh()
        assert list(mesh.get_coordinate()) == [2, 5]
        # 1000 over data (63 each), then the 63 of data 2 over model (4 each)
        assert local_range(1000, mesh, ("data", "model")) == (126 + 20, 126 + 24)
        with pytest.raises(ValueError, match="out of mesh order"):
            local_range(1000, mesh, ("model", "data"))


def _ceil_bytes(sds_tree, ps_tree, sizes) -> int:
    """A rank's bytes of the reference's abstract args: each dimension cut
    ceil(n / shards) over the axes its pspec entry names."""
    from jax.sharding import PartitionSpec as P

    leaves = jax.tree.leaves(sds_tree)
    specs = jax.tree.leaves(ps_tree, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for leaf, ps in zip(leaves, specs, strict=True):
        n = 1
        for dim, size in enumerate(leaf.shape):
            e = ps[dim] if dim < len(ps) else None
            k = int(np.prod([sizes[a] for a in ((e,) if isinstance(e, str) else (e or ()))]))
            n *= -(-size // k)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _two_layer_cells(arch, shape, axes, *, flash: bool):
    """The port's and the reference's cell of ``arch`` x ``shape`` at full
    width and 2 layers (the port's prefill through the flash kernel)."""
    from repro.configs import get_arch as ref_arch

    sh = dict(arch_shapes(arch)[shape])
    cfg = replace(get_arch(arch)[1], n_layers=2)
    if flash:
        cfg = replace(cfg, attn_impl="flash")
    ref_cfg = replace(ref_arch(arch)[1], n_layers=2)
    return (PC._lm_cell(arch, cfg, shape, sh, PC.make_rules(axes)),
            RC._lm_cell(arch, ref_cfg, shape, sh, RC.make_rules(axes)))


@pytest.mark.parametrize("name", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", TRACED)
def test_mesh_traces_hold_the_ceil_shards(name, arch, shape):
    ranks, shape_, axes = MESHES[name]
    sizes = dict(zip(axes, shape_))
    pc, rc = _two_layer_cells(arch, shape, axes, flash=shape == "prefill_32k")
    recs = {}
    # rank 0 (model index 0) and the mesh's last rank (model index 15)
    for rank in (0, ranks - 1):
        with process_group(rank, ranks, backend="fake"):
            recs[rank] = dryrun.trace_on_mesh(pc, make_production_mesh(name == "multi"))
    assert recs[0]["arg_bytes"] == _ceil_bytes(rc.args, rc.in_pspecs, sizes)
    assert recs[0]["peak_bytes"] >= recs[0]["arg_bytes"] and recs[0]["flops_traced"] > 0
    if shape == "prefill_32k":
        # Hq = 24 over 16: 2 heads on model ranks 0-11, none on 12-15
        assert recs[0]["kernel_calls"] == {"flash_attention": 2}
        assert recs[ranks - 1]["kernel_calls"] == {}
        assert recs[ranks - 1]["flops_traced"] < recs[0]["flops_traced"]
    else:
        assert recs[0]["kernel_calls"] == {}


@pytest.mark.parametrize("arch,shape", OTHER_CELLS)
def test_graph_and_recsys_cells_on_a_mesh_raise(arch, shape):
    cell = PC.build_cell(arch, shape, mesh_axes=("data", "model"))
    with pytest.raises(NotImplementedError, match="Queue 1 #13 part 3"):
        PC.lower_cell(cell, None)


def test_dry_run_on_a_mesh_takes_the_lm_cells_only():
    with pytest.raises(NotImplementedError, match="Queue 1 #13 part 3"):
        dryrun.run_cell_mesh("graphsage-reddit", "full_graph_sm", "single")
    rec = dryrun.run_cell_mesh("phi4-mini-3.8b", "long_500k", "multi", verbose=False)
    assert (rec["mesh"], rec["ranks"], rec["rank"], rec["coordinate"]) == ("2x16x16", 512, 0, [0, 0, 0])
    assert rec["fits_h100"] and rec["kernel_calls"] == {}
