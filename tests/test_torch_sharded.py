"""The port's distribution layer on 8 CPU ranks, against the port on one
device and against the reference's sharded functions.

One ``torch.multiprocessing`` start of 8 gloo ranks (one thread each, a
``FileStore`` under the test's temporary directory) on a (2, 4) ("data",
"model") mesh runs the reference's four sharded checks
(``tests/test_sharded_equivalence.py``, its sizes and seeds) and more:

* sequence-parallel ``lm_loss`` and its gradients; the expert-parallel
  MoE loss at capacity factor 16 (no token dropped);
  ``retrieval_decode_attention_sharded`` at pos 5, 37, 128; the fused
  cache write and attend at pos 0, 36, 99;
* uneven heads: Hq = 6 over 4 ranks (2, 2, 2 and none: the last rank runs
  no attention), a vocabulary and a sequence that do not split evenly,
  the weights also sharded over "data" (``fsdp_axis``), QKV bias: loss and
  gradients, prefill and three decode steps;
* ``tree_psum``, ``psum_compressed`` against ``compress_decompress``,
  ``reshard_tree`` round trips (2, 4) -> (4, 2) -> (1, 8) -> (2, 4) bit
  for bit, ``ShardingRules.shard`` on a ``DTensor``;
* cells through ``lower_cell``: the pure-FSDP train cell (phi4-mini,
  reduced, batch 256), llama4-scout's train cell (sequence parallel,
  expert parallel), qwen2-7b's prefill, decode and long_500k cells, each
  against the same cell's step on one device;
* the 20 reduced GraphSAGE and recsys cells through ``lower_cell`` (the
  sharded gather-scatter, the row-sharded table, the candidate top-k over
  sharded candidates) from the reference's parameters and a live batch
  (``cells.live_inputs``), against the same cell's step on one device and
  against the reference's ``lower_cell`` (GSPMD) on the same inputs: a
  train cell's loss, updated parameters and AdamW state, a serve cell's
  probabilities, ``retrieval_cand``'s scores and ids (ids equal);
* the sharded candidate top-k at its edges: shards with fewer valid rows
  than k or none, k above every shard's rows, and ties across shards.

Each check is held against the port's single-device functions on the
same inputs; the reference's four and the 20 GraphSAGE and recsys cells
also against the reference's sharded outputs, which a JAX subprocess
computes meanwhile on 8 host devices with an Auto-axis mesh (``jax.make_mesh`` builds Explicit axes by default, on
which the reference's sharded ``lm_loss`` does not trace).  Tolerances are
the reference's: 1e-5 (loss, gradients, outputs) and 1e-6 (caches,
centroids); the cells' as ``tests/test_torch_cells_lm.py``'s.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import ALL_CELLS, get_arch

ROOT = Path(__file__).resolve().parents[1]
WORLD, MESH, AXES = 8, (2, 4), ("data", "model")
TOL, CACHE_TOL = 1e-5, 1e-6
RETR_POS, FUSED_POS = (5, 37, 128), (0, 36, 99)
CELL_TOL = 2e-5
SPAWN_TIMEOUT_S = 600
GR_CELLS = [(a, s) for a, s in ALL_CELLS if get_arch(a)[0] != "lm"]

_ORACLE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.launch.mesh import set_mesh
from repro.models import transformer as T
from repro.models.base import param_pspecs
from repro.models.moe import MoEConfig
from repro.models.retrieval_attention import (
    clustered_cache_update, retrieval_decode_attention, retrieval_decode_attention_sharded,
    retrieval_update_and_attend_sharded)

inp = pickle.load(open(os.path.join(sys.argv[2], "inputs.pkl"), "rb"))
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
put = lambda params, pspecs: jax.device_put(params, jax.tree.map(
    lambda ps: NamedSharding(mesh, ps), pspecs, is_leaf=lambda x: isinstance(x, P)))
out = {}
rules = T.ShardingRules(batch=("data",), model="model", seq="model")
toks = jnp.asarray(inp["tokens"])
for name, moe in (("dense", None), ("moe", MoEConfig(n_experts=8, d_ff=64, capacity_factor=16.0))):
    cfg = T.LMConfig(name="t", n_layers=2, d_model=32, n_heads=8, n_kv_heads=2, d_ff=64, vocab=64, d_head=8,
                     max_seq=32, dtype=jnp.float32, attn_chunk=16, moe=moe)
    specs = T.param_specs(cfg)
    params = jax.tree.map(jnp.asarray, inp[name])
    with set_mesh(mesh):
        pp = put(params, param_pspecs(specs))
        tt = jax.device_put(toks, NamedSharding(mesh, P("data", None)))
        sp = jax.jit(lambda p, b: T.lm_loss(p, b, cfg, rules)[0])(pp, {"tokens": tt})
        g_sp = jax.jit(jax.grad(lambda p: T.lm_loss(p, {"tokens": tt}, cfg, rules)[0]))(pp)
    out[name] = {"loss": np.asarray(sp), "grads": jax.tree.map(np.asarray, g_sp)}
r = inp["retrieval"]
q, kc, vc, cent, kn, vn = (jnp.asarray(r[k]) for k in ("q", "kc", "vc", "cent", "kn", "vn"))
sh = lambda *a: NamedSharding(mesh, P(*a))
seq = ("data", "model")
out["retrieval"] = {}
for pos in (5, 37, 128):
    with set_mesh(mesh):
        o = jax.jit(lambda q, k, v, c, p: retrieval_decode_attention_sharded(
            q, k, v, c, p, cs=8, top_b=4, seq_axes=seq))(
            q, jax.device_put(kc, sh(None, None, seq, None, None)), jax.device_put(vc, sh(None, None, seq, None, None)),
            jax.device_put(cent, sh(None, None, seq, None)), jnp.asarray(pos))
    out["retrieval"][pos] = np.asarray(o)
out["fused"] = {}
for pos in (0, 36, 99):
    with set_mesh(mesh):
        o, ks, vs, cs_o = jax.jit(lambda *a: retrieval_update_and_attend_sharded(
            *a, cs=8, top_b=4, seq_axes=seq))(
            q, jax.device_put(kc, sh(None, None, seq, None, None)), jax.device_put(vc, sh(None, None, seq, None, None)),
            jax.device_put(cent, sh(None, None, seq, None)), kn, vn, jnp.asarray(pos))
    out["fused"][pos] = tuple(np.asarray(a) for a in (o, ks, vs, cs_o))
from repro.launch import cells as RC
is_ps = lambda x: isinstance(x, P)
out["cells_gr"] = {}
for (arch, shape), args in inp["cells_gr"].items():
    try:
        cell = RC.build_cell(arch, shape, mesh_axes=("data", "model"), reduced=True)
        compiled = RC.lower_cell(cell, mesh).compile()
        placed = jax.tree.map(lambda ps, x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, ps)),
                              cell.in_pspecs, args, is_leaf=is_ps)
        with set_mesh(mesh):
            res = compiled(*placed)
        out["cells_gr"][(arch, shape)] = jax.tree.map(np.asarray, res)
    except Exception as e:      # kept for the test to report: where GSPMD does not take the cell
        out["cells_gr"][(arch, shape)] = f"{type(e).__name__}: {str(e)[:500]}"
pickle.dump(out, open(os.path.join(sys.argv[2], "reference.pkl"), "wb"))
print("ORACLE_OK")
"""


def _make_inputs(tmp: Path) -> None:
    """The reference test's inputs, from its seeds: parameters from
    ``jax.random.key(0)``, tokens from ``key(1)``, the clustered cache from
    ``numpy.random.default_rng(0)``."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as RT
    from repro.models.base import init_params as ref_init
    from repro.models.moe import MoEConfig as RMoE

    inp = {"tokens": np.asarray(jax.random.randint(jax.random.key(1), (4, 32), 0, 64))}
    for name, moe in (("dense", None), ("moe", RMoE(n_experts=8, d_ff=64, capacity_factor=16.0))):
        cfg = RT.LMConfig(name="t", n_layers=2, d_model=32, n_heads=8, n_kv_heads=2, d_ff=64, vocab=64, d_head=8,
                          max_seq=32, dtype=jnp.float32, attn_chunk=16, moe=moe)
        inp[name] = jax.tree.map(np.asarray, ref_init(RT.param_specs(cfg), jax.random.key(0)))
    rng = np.random.default_rng(0)
    B, Hq, Hkv, nC, cs, d = 1, 8, 2, 16, 8, 32
    r = {"q": rng.normal(size=(B, Hq, d)), "kc": rng.normal(size=(B, Hkv, nC, cs, d)),
         "vc": rng.normal(size=(B, Hkv, nC, cs, d))}
    r = {k: v.astype(np.float32) for k, v in r.items()}
    r["cent"] = r["kc"].mean(3).astype(np.float32)
    r["kn"] = rng.normal(size=(B, Hkv, d)).astype(np.float32)
    r["vn"] = rng.normal(size=(B, Hkv, d)).astype(np.float32)
    inp["retrieval"] = r
    inp["cells_gr"] = _graph_recsys_inputs()
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inp))


def _graph_recsys_inputs() -> dict:
    """Each reduced GraphSAGE and recsys cell's inputs as numpy: the
    reference's parameters (``example_inputs``, ``jax.random.key(0)``) and
    AdamW state, and the port's live batch and candidates
    (``live_inputs``, seed 0)."""
    import jax

    from repro.launch import cells as RC
    from repro_torch.launch import cells as PC
    from repro_torch.tree import tree_map

    out = {}
    for arch, shape in GR_CELLS:
        rc = RC.build_cell(arch, shape, mesh_axes=AXES, reduced=True)
        pc = PC.build_cell(arch, shape, mesh_axes=AXES, reduced=True)
        ref = jax.tree.map(np.asarray, RC.example_inputs(rc, 0))
        live = PC.live_inputs(pc, 0, device="cpu")
        n = 2 if pc.kind == "train" else 1
        out[(arch, shape)] = tuple(ref[:n]) + tuple(tree_map(lambda t: t.numpy(), a) for a in live[n:])
    return out


# ----------------------------------------------------------------- the ranks
def _lm_cfg(moe=None, **kw):
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.transformer import LMConfig

    base = dict(name="t", n_layers=2, d_model=32, n_heads=8, n_kv_heads=2, d_ff=64, vocab=64, d_head=8, max_seq=32,
                dtype=torch.float32, attn_chunk=16,
                moe=MoEConfig(n_experts=8, d_ff=64, capacity_factor=16.0) if moe else None)
    return LMConfig(**{**base, **kw})


def _np(t):
    return t.detach().cpu().numpy().copy()


def _whole(tree, mesh, pspecs):
    """Shards -> whole numpy arrays (a collective: every rank calls it)."""
    from repro_torch.distributed.elastic import map_specs
    from repro_torch.launch.cells import _as_dtensor

    return map_specs(lambda t, ps: _np(_as_dtensor(t, mesh, ps).full_tensor()), tree, pspecs)


def _loss_and_grads(params, toks, cfg, rules, mesh):
    """(loss, grads) of ``lm_loss`` on one device (``rules`` None) or on the
    mesh (the gradients summed over replicas and made whole)."""
    from repro_torch.launch.cells import _sum_replicas, value_and_grad
    from repro_torch.launch.mesh import local_shard
    from repro_torch.models import transformer as T
    from repro_torch.models.base import param_pspecs, shard_params

    specs = T.param_specs(cfg)
    if rules is None:
        (loss, _), g = value_and_grad(lambda p, b: T.lm_loss(p, b, cfg), params, {"tokens": toks})
        return float(loss), [_np(x) for x in _leaves(g)]
    pl = shard_params(params, specs, mesh)
    tl = local_shard(toks, mesh, ("data", None))
    (loss, _), g = value_and_grad(lambda p, b: T.lm_loss(p, b, cfg, rules), pl, {"tokens": tl})
    g, _ = _sum_replicas(g, mesh, param_pspecs(specs))
    return float(loss), _leaves(_whole(g, mesh, param_pspecs(specs)))


def _leaves(tree):
    """The leaves of a tree of dicts, lists, tuples and caches, in order."""
    import dataclasses

    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _reference_checks(inp, mesh, out):
    from repro_torch.models import transformer as T
    from repro_torch.models.base import params_from_jax

    rules = T.ShardingRules(batch=("data",), model="model", seq="model", mesh=mesh)
    toks = torch.from_numpy(inp["tokens"]).to(torch.int64)
    for name in ("dense", "moe"):
        cfg = _lm_cfg(moe=name == "moe")
        params = params_from_jax(inp[name], cfg, device="cpu", dtype=torch.float32)
        out[name] = {"one": _loss_and_grads(params, toks, cfg, None, mesh),
                     "mesh": _loss_and_grads(params, toks, cfg, rules, mesh)}


def _retrieval_checks(inp, mesh, out):
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import local_shard
    from repro_torch.models import retrieval_attention as R

    r = {k: torch.from_numpy(v) for k, v in inp["retrieval"].items()}
    seq = ("data", "model")
    kv_ps, c_ps = (None, None, seq, None, None), (None, None, seq, None)
    loc = lambda t, ps: local_shard(t, mesh, ps).clone()
    out["retrieval"] = {}
    for pos in RETR_POS:
        one = R.retrieval_decode_attention(r["q"], r["kc"], r["vc"], r["cent"], pos, cs=8, top_b=4)
        sh = R.retrieval_decode_attention_sharded(r["q"], loc(r["kc"], kv_ps), loc(r["vc"], kv_ps),
                                                  loc(r["cent"], c_ps), pos, cs=8, top_b=4, mesh=mesh, seq_axes=seq)
        out["retrieval"][pos] = (_np(one), _np(sh))
    out["fused"] = {}
    for pos in FUSED_POS:
        k1, v1, c1 = r["kc"].clone(), r["vc"].clone(), r["cent"].clone()
        R.clustered_cache_update(k1, v1, c1, r["kn"], r["vn"], pos, 8)
        one = R.retrieval_decode_attention(r["q"], k1, v1, c1, pos + 1, cs=8, top_b=4)
        o, ks, vs, cs_ = R.retrieval_update_and_attend_sharded(
            r["q"], loc(r["kc"], kv_ps), loc(r["vc"], kv_ps), loc(r["cent"], c_ps), r["kn"], r["vn"], pos,
            cs=8, top_b=4, mesh=mesh, seq_axes=seq)
        whole = [_np(C.gather(t, mesh, seq, 2, 16)) for t in (ks, vs, cs_)]
        out["fused"][pos] = ((_np(one), _np(k1), _np(v1), _np(c1)), (_np(o), *whole))


def _uneven_checks(mesh, out):
    """Hq = 6 over 4 ranks (the last holds no head), vocabulary 62 and a
    sequence of 30 that do not split evenly, weights sharded over "data"
    too, QKV bias: loss and gradients, prefill, three decode steps."""
    from repro_torch.launch.mesh import local_shard
    from repro_torch.models import transformer as T
    from repro_torch.models.base import init_params, shard_params

    cfg = _lm_cfg(n_heads=6, vocab=62, max_seq=40, qkv_bias=True, fsdp_axis="data")
    specs = T.param_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(3), device="cpu", dtype=torch.float32)
    for lp in params["layers"]:     # biases away from their zero init
        for b in ("bq", "bk", "bv"):
            lp[b] += 0.1 * torch.randn(lp[b].shape, generator=torch.Generator().manual_seed(len(b)))
    toks = torch.randint(0, 62, (4, 31), generator=torch.Generator().manual_seed(4))
    sp = T.ShardingRules(batch=("data",), model="model", seq="model", mesh=mesh)
    res = {"one": _loss_and_grads(params, toks, cfg, None, mesh),
           "mesh": _loss_and_grads(params, toks, cfg, sp, mesh)}
    # serving: prefill then decode, on one device and on the mesh
    pl = shard_params(params, specs, mesh)
    serve = T.ShardingRules(batch=("data",), model="model", mesh=mesh)
    l1, c1 = T.prefill(params, toks[:, :30], cfg, max_seq=40)
    calls, real = [], T.attention

    def counted(q, *a, **k):
        calls.append(q.shape[1])
        return real(q, *a, **k)

    T.attention = counted       # the mesh prefill's attention calls, heads each
    try:
        lm, cm = T.prefill(pl, local_shard(toks[:, :30], mesh, ("data", None)), cfg, sp, max_seq=40)
    finally:
        T.attention = real
    res["prefill"] = (_np(l1), _np(c1.k), _np(c1.v))
    cache_ps = (None, "data", None, "model", None)
    res["prefill_mesh"] = tuple(_whole([t], mesh, [ps])[0] for t, ps in
                                ((lm, ("data", None)), (cm.k, cache_ps), (cm.v, cache_ps)))
    res["attention_heads"] = calls
    steps_one, steps_mesh = [], []
    for t in range(3):
        tok = toks[:, 30 - 2 + t] if t < 2 else toks[:, 0]
        l1, c1 = T.decode_step(params, c1, tok, cfg)
        lm, cm = T.decode_step(pl, cm, local_shard(tok, mesh, ("data",)), cfg, serve)
        steps_one.append(_np(l1))
        steps_mesh.append(_whole([lm], mesh, [("data", None)])[0])
    res["decode"] = (steps_one, steps_mesh, _np(c1.k), _whole([cm.k], mesh, [cache_ps])[0])
    out["uneven"] = res


def _collective_checks(mesh, out):
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import axis_index
    from repro_torch.optim.compress import compress_decompress, quantize_int8

    d = axis_index(mesh, "data")
    mine = lambda r: torch.randn((5, 7), generator=torch.Generator().manual_seed(100 + r))
    group = [d * 4 + m for m in range(4)]
    g = mine(torch.distributed.get_rank())
    tree = {"a": g, "b": [2 * g]}
    got = C.tree_psum(tree, mesh, "model")
    want = sum(mine(r) for r in group)
    res = {"tree_psum": max(float((got["a"] - want).abs().max()), float((got["b"][0] - 2 * want).abs().max()))}
    all_sum = C.tree_psum({"a": g}, mesh, AXES)["a"]
    res["tree_psum_all"] = float((all_sum - sum(mine(r) for r in range(WORLD))).abs().max())
    # int8 codes summed, the largest scale shared
    qs = [quantize_int8(mine(r)) for r in group]
    want = sum(q.to(torch.int32) for q, _ in qs).to(torch.float32) * max(s for _, s in qs)
    res["psum_compressed"] = bool(torch.equal(C.psum_compressed({"g": g}, mesh, "model")["g"], want))
    same = mine(0)
    cd, _ = compress_decompress({"g": same}, {"g": torch.zeros_like(same)})
    res["psum_compressed_same"] = bool(torch.equal(C.psum_compressed({"g": same}, mesh, "model")["g"], 4 * cd["g"]))
    out["collectives"] = res


def _reshard_checks(mesh, out):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.elastic import make_shardings, map_specs, reshard_tree
    from repro_torch.launch.mesh import local_shape
    from repro_torch.models import transformer as T
    from repro_torch.models.base import init_params, param_pspecs

    cfg = _lm_cfg(n_heads=6, vocab=62, fsdp_axis="data")
    specs = T.param_specs(cfg)
    ps = param_pspecs(specs)
    whole = init_params(specs, torch.Generator().manual_seed(5), device="cpu", dtype=torch.float32)
    host = {k: (v if k == "layers" else v.numpy()) for k, v in whole.items()}
    meshes = [mesh, init_device_mesh("cpu", (4, 2), mesh_dim_names=AXES),
              init_device_mesh("cpu", (1, 8), mesh_dim_names=AXES), mesh]
    exact, shapes = True, True
    tree = host
    for m in meshes:
        tree = reshard_tree(tree, m, ps)
        got, want = [], []
        map_specs(lambda dt, p: got.append((dt, p)), tree, ps)
        map_specs(lambda w, p: want.append(w), whole, ps)
        for (dt, p), w in zip(got, want, strict=True):
            exact &= bool(torch.equal(dt.full_tensor(), w))
            shapes &= tuple(dt.to_local().shape) == local_shape(w.shape, m, p)
    pl = make_shardings(mesh, ps)
    rules = T.ShardingRules(batch=("data",), model="model", mesh=mesh)
    x = DTensor.from_local(torch.ones(4, 6), mesh, (Replicate(), Replicate()))
    y = rules.shard(x, "B", "M")
    out["reshard"] = {"exact": exact, "shapes": shapes,
                      "placements": (pl["embed"], pl["layers"][0]["wq"], pl["final_norm"]),
                      "shard": (tuple(y.placements), tuple(y.to_local().shape), float(y.full_tensor().sum()))}


CELLS = (("phi4-mini-3.8b", "train_4k", 256), ("llama4-scout-17b-a16e", "train_4k", None),
         ("qwen2-7b", "prefill_32k", None), ("qwen2-7b", "decode_32k", None), ("qwen2-7b", "long_500k", None))


def _cell_checks(mesh, out):
    """Each cell's step on one device and, bound by ``lower_cell``, on the
    mesh, from the same ``example_inputs``, with no token dropped: the
    mesh's expert-parallel capacity counts a data shard's tokens (as the
    reference's), one device's the whole batch's."""
    from repro_torch.distributed.elastic import map_specs
    from repro_torch.launch import cells as PC
    from repro_torch.models import moe

    res = {}
    real_capacity, moe.capacity = moe.capacity, lambda cfg, T: T
    try:
        for arch, shape, batch in CELLS:
            one = PC.build_cell(arch, shape, mesh_axes=None, reduced=True, batch=batch)
            cell = PC.build_cell(arch, shape, mesh_axes=AXES, reduced=True, batch=batch)
            o1 = one.fn(*PC.example_inputs(one, 0, device="cpu"))
            om = PC.lower_cell(cell, mesh)(*PC.example_inputs(cell, 0, device="cpu"))
            res[(arch, shape)] = {"one": map_specs(lambda t, ps: _np(t), o1, cell.out_pspecs),
                                  "mesh": map_specs(lambda t, ps: _np(t.full_tensor()), om, cell.out_pspecs),
                                  "pure_fsdp": cell.meta["cfg"].pure_fsdp}
    finally:
        moe.capacity = real_capacity
    out["cells"] = res


def _graph_recsys_checks(inp, mesh, out):
    """The 20 GraphSAGE and recsys cells: each one-device step and, bound by
    ``lower_cell``, its step on the mesh, each from its own copy of the
    same inputs (the train steps update them in place); the outputs laid
    out by ``Lowered.out_pspecs``, made whole."""
    from repro_torch.distributed.elastic import map_specs
    from repro_torch.launch import cells as PC

    res = {}
    for (arch, shape), args in inp["cells_gr"].items():
        one = PC.build_cell(arch, shape, mesh_axes=None, reduced=True)
        cell = PC.build_cell(arch, shape, mesh_axes=AXES, reduced=True)
        low = PC.lower_cell(cell, mesh)
        o1 = one.fn(*PC.args_from_jax(one, args, device="cpu"))
        om = low(*PC.args_from_jax(cell, args, device="cpu"))
        res[(arch, shape)] = {"one": map_specs(lambda t, ps: _np(t), o1, low.out_pspecs),
                              "mesh": map_specs(lambda t, ps: _np(t.full_tensor()), om, low.out_pspecs),
                              "kind": cell.kind}
    out["cells_gr"] = res


TOPK_EDGES = {  # name: (candidate rows, valid rows, k, distinct rows tiled)
    "short_shards": (1024, 850, 100, None),      # ranks 6 and 7: 82 valid rows and none
    "k_past_every_shard": (128, 128, 100, None),  # 16 rows a rank, k = 100
    "ties_across_shards": (1024, 1000, 100, 40),  # 40 distinct rows, each on many shards
}


def _topk_edge_checks(mesh, out):
    """``candidate_scores_sharded`` over candidates cut over ("data",
    "model") against ``candidate_scores`` over the valid rows on one
    device (the plain version: ties to the lower index)."""
    from repro_torch.launch.mesh import local_shard
    from repro_torch.models import recsys

    res = {}
    for name, (n, nv, k, distinct) in TOPK_EDGES.items():
        g = torch.Generator().manual_seed(n + nv)
        cand = torch.randn((distinct or n, 8), generator=g)
        if distinct:
            cand = cand.repeat(-(-n // distinct), 1)[:n]
        q = torch.randn((1, 8), generator=g)
        one = recsys.candidate_scores(q, cand[:nv], k)
        got = recsys.candidate_scores_sharded(q, local_shard(cand, mesh, (AXES, None)), k, mesh=mesh, axes=AXES,
                                              n_rows=n, n_valid=nv)
        res[name] = {"one": tuple(map(_np, one)), "mesh": tuple(map(_np, got))}
    out["topk_edges"] = res


def _rank(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import process_group

    tmp = Path(tmp)
    inp = pickle.loads((tmp / "inputs.pkl").read_bytes())
    out = {"seconds": {}}
    with process_group(rank, WORLD, init_file=tmp / "store", backend="gloo"):
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=AXES)
        for name, check in (("reference", lambda: _reference_checks(inp, mesh, out)),
                            ("retrieval", lambda: _retrieval_checks(inp, mesh, out)),
                            ("uneven", lambda: _uneven_checks(mesh, out)),
                            ("collectives", lambda: _collective_checks(mesh, out)),
                            ("reshard", lambda: _reshard_checks(mesh, out)),
                            ("cells", lambda: _cell_checks(mesh, out)),
                            ("graph_recsys", lambda: _graph_recsys_checks(inp, mesh, out)),
                            ("topk_edges", lambda: _topk_edge_checks(mesh, out))):
            t0 = time.perf_counter()
            check()
            out["seconds"][name] = time.perf_counter() - t0
        (tmp / f"port{rank}.pkl").write_bytes(pickle.dumps(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    _make_inputs(tmp)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    log = open(tmp / "oracle.log", "w")
    oracle = subprocess.Popen([sys.executable, "-c", _ORACLE, str(ROOT / "src"), str(tmp)], stdout=log,
                              stderr=subprocess.STDOUT, env=env)
    try:
        ctx = mp.start_processes(_rank, args=(str(tmp),), nprocs=WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the {WORLD} ranks did not finish in {SPAWN_TIMEOUT_S} s")
        rc = oracle.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.wait()
        log.close()
    assert rc == 0, (tmp / "oracle.log").read_text()[-3000:]
    port = [pickle.loads((tmp / f"port{r}.pkl").read_bytes()) for r in range(WORLD)]
    return port, pickle.loads((tmp / "reference.pkl").read_bytes())


# ------------------------------------------------------------------ checks
def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))) if np.size(a) else 0.0


def _ref_grads(tree, moe: bool):
    """The reference's gradient tree in the port's layout."""
    from repro_torch.models.base import params_from_jax

    return [_np(t) for t in _leaves(params_from_jax(tree, _lm_cfg(moe=moe), device="cpu", dtype=torch.float32))]


def _held(what, got, want, tol):
    errs = [_err(a, b) for a, b in zip(got, want, strict=True)]
    assert max(errs) < tol, (what, max(errs))


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_sequence_parallel_loss_and_grads(runs, name):
    """Megatron sequence parallelism (dense) and expert parallelism (MoE,
    capacity factor 16): the loss and every gradient on the (2, 4) mesh
    against the port on one device and against the reference's sharded
    run; every rank reports the same loss."""
    port, ref = runs
    r = port[0][name]
    (l1, g1), (lm, gm) = r["one"], r["mesh"]
    assert abs(lm - l1) < TOL, (name, l1, lm)
    assert abs(lm - float(ref[name]["loss"])) < TOL, (name, float(ref[name]["loss"]), lm)
    assert all(p[name]["mesh"][0] == lm for p in port)
    _held(f"{name} grads vs one device", gm, g1, TOL)
    _held(f"{name} grads vs the reference's sharded", gm, _ref_grads(ref[name]["grads"], name == "moe"), TOL)


@pytest.mark.parametrize("pos", RETR_POS)
def test_retrieval_attention_sharded(runs, pos):
    port, ref = runs
    one, sh = port[0]["retrieval"][pos]
    assert _err(sh, one) < TOL, (pos, _err(sh, one))
    assert _err(sh, ref["retrieval"][pos]) < TOL, (pos, _err(sh, ref["retrieval"][pos]))
    assert all(_err(p["retrieval"][pos][1], sh) == 0.0 for p in port)


@pytest.mark.parametrize("pos", FUSED_POS)
def test_fused_cache_write_and_attend(runs, pos):
    """Only the owning shard writes; the output, both caches and the
    centroids against the one-device write and attend and against the
    reference's sharded run."""
    port, ref = runs
    one, sh = port[0]["fused"][pos]
    for i, (what, tol) in enumerate((("out", TOL), ("k", CACHE_TOL), ("v", CACHE_TOL), ("centroids", CACHE_TOL))):
        assert _err(sh[i], one[i]) < tol, (pos, what, _err(sh[i], one[i]))
        assert _err(sh[i], ref["fused"][pos][i]) < tol, (pos, what, _err(sh[i], ref["fused"][pos][i]))


def test_uneven_heads_vocab_and_sequence(runs):
    port, _ = runs
    r = port[0]["uneven"]
    (l1, g1), (lm, gm) = r["one"], r["mesh"]
    assert abs(lm - l1) < TOL, (l1, lm)
    _held("uneven grads", gm, g1, TOL)
    for what, a, b in zip(("logits", "k", "v"), r["prefill_mesh"], r["prefill"]):
        assert _err(a, b) < TOL, (what, _err(a, b))
    steps_one, steps_mesh, k1, km = r["decode"]
    for t, (a, b) in enumerate(zip(steps_mesh, steps_one)):
        assert _err(a, b) < TOL, ("decode", t, _err(a, b))
    assert _err(km, k1) < TOL      # the model's keys after its layers: an output, not a copy
    # Hq = 6 over 4 model ranks: 2, 2, 2 heads a layer, the last rank none
    # and no attention call (ranks are data * 4 + model)
    assert [p["uneven"]["attention_heads"] for p in port[:4]] == [[2, 2], [2, 2], [2, 2], []]


def test_collectives(runs):
    port, _ = runs
    for p in port:
        c = p["collectives"]
        assert c["tree_psum"] < 1e-5 and c["tree_psum_all"] < 1e-5, c
        assert c["psum_compressed"], "psum_compressed != the int8 codes summed times the largest scale"
        assert c["psum_compressed_same"], "psum_compressed of equal leaves != 4 x compress_decompress"


def test_reshard_round_trips_and_placements(runs):
    from torch.distributed.tensor import Replicate, Shard

    port, _ = runs
    for p in port:
        r = p["reshard"]
        assert r["exact"] and r["shapes"], r
        # embed ("model", "data"), wq ("data", "model"), final_norm (None,)
        assert r["placements"] == ((Shard(1), Shard(0)), (Shard(0), Shard(1)), (Replicate(), Replicate()))
        assert r["shard"][0] == (Shard(0), Shard(1)) and r["shard"][2] == 24.0, r["shard"]
    # [4, 6] over ("data", "model"): 6 columns cut 2, 2, 2, 0
    assert [p["reshard"]["shard"][1] for p in port[:4]] == [(2, 2), (2, 2), (2, 2), (2, 0)]


@pytest.mark.parametrize("arch,shape,batch", CELLS)
def test_lowered_cells_match_one_device(runs, arch, shape, batch):
    port, _ = runs
    r = port[0]["cells"][(arch, shape)]
    assert r["pure_fsdp"] == (shape == "train_4k" and arch == "phi4-mini-3.8b")
    one, mesh = _leaves(r["one"]), _leaves(r["mesh"])
    for i, (a, b) in enumerate(zip(mesh, one, strict=True)):
        assert np.shape(a) == np.shape(b), (i, np.shape(a), np.shape(b))
        assert _err(a, b) <= CELL_TOL * max(1.0, float(np.max(np.abs(b))) if np.size(b) else 1.0), (i, _err(a, b))


TINY_GRAD = 1e-6


def _held_cell(what, got, want, lr=None):
    """Every leaf within CELL_TOL of the largest, integers equal.  ``lr``: a
    train step's outputs (params, mu, nu, step, loss); a parameter entry
    whose gradient is below TINY_GRAD (``mu`` = 0.1 g) may also be 2 lr
    off: AdamW's first update is about lr · sign(g), and so small a
    gradient may take the other sign in another summation order
    (``tests/test_torch_cells_lm.py`` holds the reference's steps alike)."""
    n_par = (len(want) - 2) // 3 if lr else 0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert np.shape(a) == np.shape(b), (what, i, np.shape(a), np.shape(b))
        if np.issubdtype(np.asarray(b).dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")
            continue
        tol = CELL_TOL * max(1.0, float(np.max(np.abs(b))) if np.size(b) else 1.0)
        if i < n_par:
            tiny = np.abs(np.asarray(want[n_par + i], np.float64)) / 0.1 < TINY_GRAD
            tol = tol + np.where(tiny, 2 * lr, 0.0)
        err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        assert (err <= tol).all(), (what, i, float(err.max()))


@pytest.mark.parametrize("arch,shape", GR_CELLS, ids=[f"{a}-{s}" for a, s in GR_CELLS])
def test_graph_and_recsys_cells_on_the_mesh(runs, arch, shape):
    """The cell through ``lower_cell`` on the (2, 4) mesh against its step on
    one device and against the reference's GSPMD lowering of the same
    inputs: a train cell's loss, parameters and AdamW state after the step
    (the replicated-rows trap: a batch-sharded cell's "model" replicas
    counted 4 times would move every one), a serve cell's probabilities,
    ``retrieval_cand``'s scores (and its ids equal).  Every rank holds the
    same whole outputs."""
    port, ref = runs
    r = port[0]["cells_gr"][(arch, shape)]
    mesh, one = _leaves(r["mesh"]), _leaves(r["one"])
    lr = (3e-3 if arch.startswith("graphsage") else 1e-3) if r["kind"] == "train" else None
    _held_cell("mesh vs one device", mesh, one, lr)
    for p in port[1:]:
        _held_cell("rank vs rank 0", _leaves(p["cells_gr"][(arch, shape)]["mesh"]), mesh)
    gspmd = ref["cells_gr"][(arch, shape)]
    assert not isinstance(gspmd, str), f"the reference's lower_cell on the Auto-axis mesh: {gspmd}"
    _held_cell("mesh vs the reference's GSPMD", mesh, _leaves(gspmd), lr)
    if r["kind"] == "train":
        assert float(r["mesh"][2]["loss"]) > 0 and int(r["mesh"][1]["step"]) == 1


@pytest.mark.parametrize("name", list(TOPK_EDGES))
def test_sharded_candidate_topk_edges(runs, name):
    """Shards with fewer valid rows than k (their (-inf, -1) pads dropped)
    or none, k above every shard's rows, and ties across shards (to the
    lower global id): ids equal to one device's, scores within 1e-6."""
    port, _ = runs
    r = port[0]["topk_edges"][name]
    (s1, i1), (sm, im) = r["one"], r["mesh"]
    np.testing.assert_array_equal(im, i1)
    assert _err(sm, s1) <= 1e-6 and (im >= 0).all()
    if name == "ties_across_shards":
        n, nv, k, distinct = TOPK_EDGES[name]
        s = np.asarray(s1[0], np.float64)
        # each score repeated over its tiles, lower ids first
        assert len(set(s.tolist())) <= -(-k // (nv // distinct)) + 1 and all(
            i1[0][j] < i1[0][j + 1] for j in range(k - 1) if s[j] == s[j + 1])
    for p in port[1:]:
        np.testing.assert_array_equal(p["topk_edges"][name]["mesh"][1], im)
