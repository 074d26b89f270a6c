"""The port's GraphSAGE and recsys cells against the reference's: the 20
reduced cells run one step on the CPU from the reference's inputs,
``example_inputs`` bit for bit, and the 20 full-size cells' dry run.

Tolerances as ``tests/test_torch_cells_lm.py`` states them (the same
helpers): a train step's loss, ``mu`` and parameters (2 lr where a
gradient is below 1e-6: lr 3e-3 for GraphSAGE, 1e-3 for recsys); serve
probabilities 2e-5; the retrieval cell's 100 scores 2e-5 and its ids
equal.

The dry run's counts as ``tests/test_torch_dryrun.py`` holds them; its
FLOPs against ``benchmarks/analytic.cell_flops``, which counts a train
step as four passes of the forward's products:
  * recsys retrieval: the 2·N·d scores (the custom op's formula) and the
    user tower's products: relative 1e-3.
  * recsys serve: the forward's products, at least the analytic count and
    at most 1.3 of it (the analytic count leaves out autoint's later blocks'
    H·da-wide inputs and dien's second GRU, the AUGRU).
  * recsys train: forward and a backward of two, no remat: 3/4 of four
    passes of what serve traces, within 1e-2 (no input gradient below the
    embedding lookups).
  * GraphSAGE train: between 0.45 and 0.8 of the analytic four passes: no
    remat, the first layer's input takes no gradient (two passes there),
    and the segment sums the analytic count includes are not products.
"""
import numpy as np
import pytest
import torch

from benchmarks import analytic
from repro.launch import cells as RC
from repro_torch.configs import ALL_CELLS, arch_shapes
from repro_torch.kernels.distance_topk import ops as topk_ops
from repro_torch.launch import cells as PC
from repro_torch.launch import dryrun
from repro_torch.tree import tree_leaves
from test_torch_cells_lm import OUT_ATOL, _close, check_train, twin
from test_torch_dryrun import SAME, held_counts, ref_record

CELLS = [(a, s) for a, s in ALL_CELLS if a in ("graphsage-reddit", "bst", "dien", "autoint", "dcn-v2")]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_reduced_cell_matches_the_reference(arch, shape):
    topk_ops.reset_launches()
    rc, pc, ro, po, pa = twin(arch, shape)
    if pc.kind == "train":
        check_train(pc, ro, po)
    elif pc.kind == "serve":
        assert po.shape == (pa[1]["cat"].shape[0],) and torch.isfinite(po).all()
        _close("probabilities", po, ro, OUT_ATOL)
    else:
        scores, ids = po
        assert scores.shape == ids.shape == (1, 100) and ids.dtype == torch.int32
        _close("scores", scores, ro[0], OUT_ATOL)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ro[1]))
        assert pc.meta["n_candidates"] == rc.meta["n_candidates"] == 1000
    assert topk_ops.launches["distance_topk"] == 0   # the CPU runs the plain version


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_example_inputs_equal_the_reference_s(arch, shape):
    rc = RC.build_cell(arch, shape, mesh_axes=None, reduced=True)
    pc = PC.build_cell(arch, shape, mesh_axes=None, reduced=True)
    mine = PC.example_inputs(pc, seed=5, device="cpu")
    ref = PC.args_from_jax(pc, RC.example_inputs(rc, seed=5), device="cpu")
    for a, b in zip(PC.arg_leaves(mine[1:]), PC.arg_leaves(ref[1:]), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [(p.shape, p.dtype) for p in tree_leaves(mine[0])] == [
        (a.shape, a.dtype) for a in tree_leaves(pc.args[0])]


def _ratio(arch, shape):
    ref = ref_record(arch, shape)
    rec = dryrun.run_cell(arch, shape, verbose=False)
    held_counts(rec, ref)
    assert rec["fits_h100"] and rec["peak_bytes"] >= rec["arg_bytes"] and "fit_batch" not in rec
    return rec["flops_traced"] / analytic.cell_flops(ref["meta"], ref["sh"]["kind"], ref["sh"])


@pytest.mark.parametrize("arch", ["graphsage-reddit", "bst", "dien", "autoint", "dcn-v2"])
def test_full_size_cells_trace_as_the_reference_counts(arch):
    ratios = {shape: _ratio(arch, shape) for shape in arch_shapes(arch)}
    if arch == "graphsage-reddit":
        assert all(0.45 <= r <= 0.8 for r in ratios.values()), ratios
        return
    assert abs(ratios["retrieval_cand"] - 1) <= SAME, ratios
    for shape in ("serve_p99", "serve_bulk"):
        assert 1 - SAME <= ratios[shape] <= 1.3, ratios
    assert abs(ratios["train_batch"] / (0.75 * ratios["serve_bulk"]) - 1) <= 1e-2, ratios
