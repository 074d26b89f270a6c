"""The port's cells (``repro_torch.launch.cells``) against the reference's
``repro.launch.cells``: the registry of 40 cells, the LM family's 20
reduced cells run one step on the CPU, their inputs, and the partition
specs of every arch on both production meshes' axis names.

Each reduced cell runs the reference's ``cell.fn`` (jitted) and the
port's on the same inputs: the reference's ``example_inputs``, carried
across by ``args_from_jax``.  Tolerances (float32 throughout, the reduced
configs' dtype): logits and caches 2e-5 absolute (observed <= 3e-6: sums
in another order); a train step's loss 1e-5 relative and its first AdamW
moment ``mu`` = 0.1 g within 1e-6 + 1e-4 relative.  Parameters after the
step within 1e-6 + 1e-5 |p|, except where the gradient is below 1e-6:
AdamW's first update is about lr · sign(g), and a gradient that small may
take the other sign in another summation order, moving the entry by up to
2 lr (lr = 1.5e-6 at step 1 of the LM schedule).
"""
from dataclasses import fields

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_CELLS as REF_CELLS
from repro.launch import cells as RC
from repro.models import transformer as RT
from repro_torch.configs import ALL_ARCHS, ALL_CELLS, arch_shapes
from repro_torch.launch import cells as PC
from repro_torch.models import transformer as T
from repro_torch.models.base import params_from_jax
from repro_torch.models.retrieval_attention import ClusteredKVCache
from repro_torch.tree import tree_leaves
from test_torch_dryrun import analytic_band, held_counts, ref_record

LM_CELLS = [(a, s) for a, s in ALL_CELLS if a in ("phi4-mini-3.8b", "mistral-large-123b", "qwen2-7b",
                                                   "llama4-maverick-400b-a17b", "llama4-scout-17b-a16e")]
OUT_ATOL = 2e-5
LOSS_RTOL = 1e-5
MU_ATOL, MU_RTOL = 1e-6, 1e-4
P_ATOL, P_RTOL = 1e-6, 1e-5
TINY_GRAD = 1e-6


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(what, a, b, atol, rtol=0.0):
    np.testing.assert_allclose(_np(a).astype(np.float64), _np(b).astype(np.float64), atol=atol, rtol=rtol,
                               err_msg=what)


def _lr1(pc) -> float:
    """The learning rate of the cell's first step."""
    if pc.meta["family"] == "lm":
        return 3e-4 / 200
    return 3e-3 if pc.meta["family"] == "gnn" else 1e-3


def twin(arch, shape):
    """(reference cell, port cell, the reference's outputs, the port's,
    the port's inputs) of one reduced cell run once on the CPU."""
    rc = RC.build_cell(arch, shape, mesh_axes=None, reduced=True)
    pc = PC.build_cell(arch, shape, mesh_axes=None, reduced=True)
    ra = RC.example_inputs(rc)
    pa = PC.args_from_jax(pc, ra, device="cpu")
    ro = jax.jit(rc.fn)(*ra)
    with torch.no_grad():
        po = pc.fn(*pa)
    return rc, pc, ro, po, pa


def check_train(pc, ro, po):
    cfg = pc.meta["cfg"]
    (rp, rs, rm), (pp, ps, pm) = ro, po
    assert int(rs["step"]) == int(ps["step"]) == 1
    assert float(pm["loss"]) > 0
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
    dtype = tree_leaves(pp)[0].dtype
    conv = lambda t: tree_leaves(params_from_jax(t, cfg, device="cpu", dtype=dtype))
    mu = tree_leaves(ps["mu"])
    for i, (r, p) in enumerate(zip(conv(rs["mu"]), mu)):
        _close(f"mu leaf {i}", p, r, MU_ATOL, MU_RTOL)
    lr = _lr1(pc)
    for i, (r, p, m) in enumerate(zip(conv(rp), tree_leaves(pp), mu)):
        tol = P_ATOL + P_RTOL * r.abs() + torch.where(m.abs() / 0.1 < TINY_GRAD, 2 * lr, 0.0)
        assert bool(((p - r).abs() <= tol).all()), f"parameter leaf {i}: {float((p - r).abs().max())}"


def check_cache(rcache, pcache):
    assert isinstance(pcache.pos, int) and pcache.pos == int(rcache.pos)
    for f in fields(pcache):
        if f.name != "pos":
            _close(f.name, getattr(pcache, f.name), getattr(rcache, f.name), OUT_ATOL)


def test_the_registry_is_the_reference_s_40_cells():
    assert ALL_CELLS == REF_CELLS and len(ALL_CELLS) == 40 and len(ALL_ARCHS) == 10
    for arch, shape in ALL_CELLS:
        pc = PC.build_cell(arch, shape, mesh_axes=None, reduced=True)
        rc = RC.build_cell(arch, shape, mesh_axes=None, reduced=True)
        assert (pc.arch, pc.shape, pc.kind, pc.donate) == (rc.arch, rc.shape, rc.kind, rc.donate)
        assert pc.meta["n_params"] == rc.meta["n_params"]
        assert pc.meta.get("tokens") == rc.meta.get("tokens")


@pytest.mark.parametrize("arch,shape", LM_CELLS, ids=[f"{a}-{s}" for a, s in LM_CELLS])
def test_reduced_lm_cell_matches_the_reference(arch, shape):
    rc, pc, ro, po, pa = twin(arch, shape)
    assert all(p.is_meta for p in tree_leaves(pc.args[0]))
    if pc.kind == "train":
        check_train(pc, ro, po)
        return
    logits, cache = po
    assert torch.isfinite(logits).all()
    _close("logits", logits, ro[0], OUT_ATOL)
    check_cache(ro[1], cache)
    if pc.kind != "prefill":   # decode steps write their caches in place
        assert cache.k is pa[1].k and cache.pos == pa[1].pos + 1


@pytest.mark.parametrize("arch,shape", LM_CELLS, ids=[f"{a}-{s}" for a, s in LM_CELLS])
def test_example_inputs_equal_the_reference_s(arch, shape):
    """The non-parameter leaves bit for bit (the draws in the reference's
    leaf order; a cache's ``pos`` is drawn, as the reference's is); the
    parameters of the abstract shapes and dtypes."""
    rc = RC.build_cell(arch, shape, mesh_axes=None, reduced=True)
    pc = PC.build_cell(arch, shape, mesh_axes=None, reduced=True)
    mine = PC.example_inputs(pc, seed=3, device="cpu")
    ref = PC.args_from_jax(pc, RC.example_inputs(rc, seed=3), device="cpu")
    for a, b in zip(PC.arg_leaves(mine[1:]), PC.arg_leaves(ref[1:]), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for c, r in zip(mine[1:], ref[1:]):
        if isinstance(c, T.KVCache | ClusteredKVCache):
            assert c.pos == r.pos
    assert [(p.shape, p.dtype) for p in tree_leaves(mine[0])] == [
        (a.shape, a.dtype) for a in tree_leaves(pc.args[0])]


def _ref_layout(tree, cfg):
    """A reference pspec tree in the port's structure: ``PartitionSpec`` ->
    tuple, caches -> the port's, stacked LM layers -> per-layer dicts
    without the layer axis (with ``moe_every=2`` each block's dense layer,
    then its MoE layer)."""
    P = jax.sharding.PartitionSpec
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, RT.KVCache):
        return T.KVCache(k=tuple(tree.k), v=tuple(tree.v), pos=tuple(tree.pos))
    if isinstance(tree, RC.ClusteredKVCache):
        return ClusteredKVCache(k=tuple(tree.k), v=tuple(tree.v), centroids=tuple(tree.centroids),
                                   pos=tuple(tree.pos))
    if isinstance(tree, dict):
        out = {k: _ref_layout(v, cfg) for k, v in tree.items() if k != "layers"}
        if "layers" in tree:
            layers = tree["layers"]
            if isinstance(layers, dict):  # the LM's stacked layers
                one = lambda st: {k: tuple(v)[1:] for k, v in st.items()}
                if "dense" in layers:
                    out["layers"] = [one(layers["dense"] if i % 2 == 0 else layers["moe"])
                                     for i in range(cfg.n_layers)]
                else:
                    out["layers"] = [one(layers)] * cfg.n_layers
            else:
                out["layers"] = _ref_layout(layers, cfg)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_ref_layout(v, cfg) for v in tree)
    return tree


@pytest.mark.parametrize("mesh_axes", [("data", "model"), ("pod", "data", "model")], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_pspecs_equal_the_reference_s(arch, mesh_axes):
    """``param_pspecs`` and every cell's ``in_pspecs`` and ``out_pspecs``
    as the reference's, the train cells' pure-FSDP switch included."""
    from repro.models import param_pspecs as ref_param_pspecs
    from repro_torch.models.base import param_pspecs

    for shape in arch_shapes(arch):
        rc = RC.build_cell(arch, shape, mesh_axes=mesh_axes)
        pc = PC.build_cell(arch, shape, mesh_axes=mesh_axes)
        cfg = pc.meta["cfg"]
        if pc.meta["family"] == "lm":
            assert (cfg.fsdp_axis, cfg.pure_fsdp, cfg.microbatches) == (
                rc.meta["cfg"].fsdp_axis, rc.meta["cfg"].pure_fsdp, rc.meta["cfg"].microbatches)
        specs = PC._param_specs(pc)
        ref_specs = {"lm": RT.param_specs, "gnn": RC.gnn.param_specs,
                     "recsys": RC.recsys.param_specs}[pc.meta["family"]](rc.meta["cfg"])
        assert param_pspecs(specs) == _ref_layout(ref_param_pspecs(ref_specs), cfg)
        assert pc.in_pspecs == _ref_layout(rc.in_pspecs, cfg)
        assert pc.out_pspecs == _ref_layout(rc.out_pspecs, cfg)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_a_cell_on_a_mesh_raises_until_the_distribution_layer(shape, tmp_path):
    """A cell built with mesh axes raises until ``lower_cell`` binds its step
    to a mesh; bound to the host mesh (one gloo rank, (1, 1)) it gives the
    one-device cell's outputs, laid out by its ``out_pspecs``."""
    from repro_torch.distributed.elastic import map_specs
    from repro_torch.launch.mesh import make_host_mesh, process_group

    pc = PC.build_cell("qwen2-7b", shape, mesh_axes=("data", "model"), reduced=True)
    with pytest.raises(ValueError, match="carry no mesh"):
        pc.fn(*PC.example_inputs(pc, device="cpu"))
    one = PC.build_cell("qwen2-7b", shape, mesh_axes=None, reduced=True)
    want = one.fn(*PC.example_inputs(one, device="cpu"))
    with process_group(0, 1, init_file=tmp_path / "store", backend="gloo"):
        got = PC.lower_cell(pc, make_host_mesh())(*PC.example_inputs(pc, device="cpu"))
        got = map_specs(lambda t, ps: t.full_tensor(), got, pc.out_pspecs)
    for a, b in zip(PC.arg_leaves(got), PC.arg_leaves(want), strict=True):
        _close(shape, a, b, OUT_ATOL)


def test_full_size_train_cell_traces_as_the_reference_counts():
    """qwen2-7b's train_4k at its batch of 256 on fake tensors (the bands:
    ``tests/test_torch_dryrun.py``)."""
    from repro_torch.launch import dryrun

    ref = ref_record("qwen2-7b", "train_4k")
    rec = dryrun.run_cell("qwen2-7b", "train_4k", batch=256, verbose=False)
    held_counts(rec, ref)
    lo, hi = analytic_band(ref)
    assert lo <= rec["flops_traced"] <= hi, (rec["flops_traced"], lo, hi)
    assert not rec["fits_h100"] and rec["peak_bytes"] > rec["arg_bytes"]
