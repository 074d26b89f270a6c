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
the 12th) holds no head and launches nothing.  The 20 GraphSAGE and
recsys cells at full size trace as rank 0 of 256 ranks, and one cell of
each regime (full graph, sampled, batched graphs, recsys train, serve,
retrieval) as rank 0 of 512: the rank's argument bytes by the same
reckoning, its traced peak within the 72 GiB line, one ``distance_topk``
call on a ``retrieval_cand`` rank and no kernel elsewhere.  And
``recsys.merge_topk``: ties to the lower id, pads last.
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
# one cell of each regime on the multi-pod mesh
OTHER_MULTI = [("graphsage-reddit", "ogb_products"), ("graphsage-reddit", "minibatch_lg"),
               ("graphsage-reddit", "molecule"), ("bst", "train_batch"), ("bst", "serve_bulk"),
               ("bst", "retrieval_cand")]


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


def _graph_recsys_trace(arch, shape, name):
    ranks, shape_, axes = MESHES[name]
    pc = PC.build_cell(arch, shape, mesh_axes=axes)
    rc = RC.build_cell(arch, shape, mesh_axes=axes)
    with process_group(0, ranks, backend="fake"):
        rec = dryrun.trace_on_mesh(pc, make_production_mesh(name == "multi"))
    assert rec["arg_bytes"] == _ceil_bytes(rc.args, rc.in_pspecs, dict(zip(axes, shape_)))
    assert rec["arg_bytes"] <= rec["peak_bytes"] <= dryrun.H100_FIT_BYTES and rec["flops_traced"] > 0
    assert rec["kernel_calls"] == ({"distance_topk": 1} if shape == "retrieval_cand" else {}), rec["kernel_calls"]
    return rec


@pytest.mark.parametrize("arch,shape", OTHER_CELLS)
def test_graph_and_recsys_cells_trace_on_the_single_pod_mesh(arch, shape):
    rec = _graph_recsys_trace(arch, shape, "single")
    if shape == "ogb_products":
        # each layer all-gathers h: [2 449 408, 128] float32 (1.25 GB) on every rank
        assert rec["peak_bytes"] > 2_449_408 * 128 * 4


@pytest.mark.parametrize("arch,shape", OTHER_MULTI)
def test_graph_and_recsys_cells_trace_on_the_multi_pod_mesh(arch, shape):
    _graph_recsys_trace(arch, shape, "multi")


def test_merge_topk_breaks_ties_to_the_lower_id_and_puts_pads_last():
    from repro_torch.models.recsys import merge_topk

    inf = float("inf")
    # three ranks' lists, each sorted as the kernel returns them; rank 2 short
    scores = torch.tensor([[5.0, 3.0, 3.0, 4.0, 3.0, 1.0, 5.0, 3.0, -inf]])
    ids = torch.tensor([[7, 2, 9, 40, 33, 41, 80, 81, -1]], dtype=torch.int32)
    s, i = merge_topk(scores, ids, 6)
    assert s.tolist() == [[5.0, 5.0, 4.0, 3.0, 3.0, 3.0]] and i.tolist() == [[7, 80, 40, 2, 9, 33]]
    s, i = merge_topk(scores[:, 6:], ids[:, 6:], 3)       # fewer real entries than k: pads stay last
    assert s.tolist() == [[5.0, 3.0, -inf]] and i.tolist() == [[80, 81, -1]]


def test_dry_run_on_a_mesh_takes_the_lm_cells_only():
    rec = dryrun.run_cell_mesh("phi4-mini-3.8b", "long_500k", "multi", verbose=False)
    assert (rec["mesh"], rec["ranks"], rec["rank"], rec["coordinate"]) == ("2x16x16", 512, 0, [0, 0, 0])
    assert rec["fits_h100"] and rec["kernel_calls"] == {}
