"""The port's GraphSAGE, its configs and the graph data on the CPU against
the JAX package's.

The same weights (the reference's ``init_params``, carried across by
``params_from_jax``) and the same inputs (the data generators of both
packages, which must agree bit for bit) go through the three regimes:
full batch, sampled and batched small graphs; forward, loss and gradients
(autograd against ``jax.grad``).  Tolerance 1e-5 relative (+1e-6
absolute): float32 sums in another order (``index_add`` against
``segment_sum``).  The twins of the GNN tests of ``tests/test_models.py``
and ``tests/test_data.py`` run on the port.
"""
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro.models import gnn as JG
from repro.models.base import init_params as jax_init_params
from repro_torch import configs
from repro_torch import data as tdata
from repro_torch.launch.cells import value_and_grad
from repro_torch.models import gnn as G
from repro_torch.models.base import params_from_jax

RTOL, ATOL = 1e-5, 1e-6
KEY = jax.random.key(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol, atol=atol)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _pair(cfg_kw, seed=0):
    jcfg = JG.GraphSAGEConfig(**cfg_kw)
    cfg = G.GraphSAGEConfig(**cfg_kw)
    jp = jax_init_params(JG.param_specs(jcfg), jax.random.key(seed))
    return jcfg, cfg, jp, params_from_jax(jp, cfg, device="cpu")


# --------------------------------------------------------- configs and data
@pytest.mark.parametrize("reduced", [False, True])
def test_gnn_configs_are_the_reference_values(reduced):
    from repro.configs import gnn_archs as jarchs

    c, j = configs.gnn_archs.get("graphsage-reddit", reduced=reduced), jarchs.get("graphsage-reddit", reduced=reduced)
    for f in fields(c):
        a, b = getattr(c, f.name), getattr(j, f.name)
        assert (a == torch.float32 and b == jnp.float32) if f.name == "dtype" else a == b, f.name
    assert [s.shape for s in _leaves(G.param_specs(c))] == [s.shape for s in _leaves(JG.param_specs(j))]


def test_shapes_and_registry_are_the_reference_values():
    from repro.configs import shapes as jshapes

    assert configs.GNN_SHAPES == jshapes.GNN_SHAPES
    assert configs.FAMILY_SHAPES == jshapes.FAMILY_SHAPES
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS and configs.ALL_CELLS == jconfigs.ALL_CELLS
    for arch in configs.ALL_ARCHS:
        assert configs.get_arch(arch)[0] == jconfigs.get_arch(arch)[0]
        assert configs.arch_shapes(arch) == jconfigs.arch_shapes(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("nope")


def test_synthetic_data_bit_for_bit():
    kw = dict(n_nodes=300, n_edges=2000, d_feat=12, n_classes=5)
    for a, b in ((tdata.random_graph(4, **kw), jdata.random_graph(4, **kw)),
                 (tdata.batched_molecules(1, 3, batch=8, n_nodes=30, n_edges=64, d_feat=16, n_classes=2),
                  jdata.batched_molecules(1, 3, batch=8, n_nodes=30, n_edges=64, d_feat=16, n_classes=2)),
                 (tdata.lm_batch(2, 5, batch=3, seq=17, vocab=1000, shard=1),
                  jdata.lm_batch(2, 5, batch=3, seq=17, vocab=1000, shard=1))):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_csr_and_sample_hops_bit_for_bit():
    g = tdata.random_graph(0, n_nodes=500, n_edges=4000, d_feat=8, n_classes=4)
    t, j = tdata.CSRGraph(500, g["edge_src"], g["edge_dst"]), jdata.CSRGraph(500, g["edge_src"], g["edge_dst"])
    np.testing.assert_array_equal(t.ptr, j.ptr)
    np.testing.assert_array_equal(t.nbr, j.nbr)
    seeds = np.arange(0, 500, 7)
    ht = tdata.sample_hops(t, g["feats"], seeds, (5, 3), np.random.default_rng(9))
    hj = jdata.sample_hops(j, g["feats"], seeds, (5, 3), np.random.default_rng(9))
    assert len(ht) == len(hj) == 3
    for a, b in zip(ht, hj):
        assert a.tobytes() == b.tobytes() and a.shape == b.shape


# ------------------------------------------------------- twins (test_data.py)
def test_csr_and_sampler():
    g = tdata.random_graph(0, n_nodes=100, n_edges=500, d_feat=8, n_classes=4)
    csr = tdata.CSRGraph(100, g["edge_src"], g["edge_dst"])
    assert csr.ptr[-1] == 500
    v = int(g["edge_dst"][0])
    assert sorted(csr.neighbors(v).tolist()) == sorted(g["edge_src"][g["edge_dst"] == v].tolist())
    hops = tdata.sample_hops(csr, g["feats"], np.arange(10), (4, 3), np.random.default_rng(0))
    assert [h.shape for h in hops] == [(10, 4, 3, 8), (10, 4, 8), (10, 8)]
    np.testing.assert_array_equal(hops[2], g["feats"][np.arange(10)])


def test_sampled_neighbors_are_real_neighbors():
    from repro_torch.data.graph import _sample_neighbors

    g = tdata.random_graph(1, n_nodes=50, n_edges=300, d_feat=4, n_classes=2)
    csr = tdata.CSRGraph(50, g["edge_src"], g["edge_dst"])
    seeds = np.asarray([int(g["edge_dst"][0])])
    nbrs = _sample_neighbors(csr, seeds, 8, np.random.default_rng(1))
    assert set(nbrs[0].tolist()) <= set(csr.neighbors(seeds[0]).tolist()) | {seeds[0]}


# ----------------------------------------------------- twins (test_models.py)
def test_gnn_full_batch_equals_manual():
    cfg = G.GraphSAGEConfig(name="t", d_in=4, n_classes=3, n_layers=1, d_hidden=8)
    p = G.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    feats = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32))
    out = G.full_batch_forward(p, feats, torch.tensor([0, 1, 2]), torch.tensor([1, 1, 3]), cfg)
    agg = torch.zeros((5, 4))
    agg[1] = (feats[0] + feats[1]) / 2
    agg[3] = feats[2]
    lp = p["layers"][0]
    h = torch.relu(feats @ lp["w_self"] + agg @ lp["w_neigh"] + lp["b"])
    _close(out, h @ p["w_out"] + p["b_out"])


def test_gnn_edge_weight_padding_is_neutral():
    cfg = G.GraphSAGEConfig(name="t", d_in=4, n_classes=3, n_layers=2, d_hidden=8)
    p = G.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    feats = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32))
    src, dst = torch.tensor([0, 1, 2, 4], dtype=torch.int32), torch.tensor([1, 2, 3, 5], dtype=torch.int32)
    out1 = G.full_batch_forward(p, feats, src, dst, cfg)
    pad = torch.zeros(4, dtype=torch.int32)
    w = torch.cat([torch.ones(4), torch.zeros(4)])
    out2 = G.full_batch_forward(p, feats, torch.cat([src, pad]), torch.cat([dst, pad]), cfg, edge_weight=w)
    _close(out1, out2)
    out3 = G.full_batch_forward(p, feats, src, dst, cfg, edge_weight=torch.ones(4))
    assert torch.equal(out1, out3)   # the ones the reference multiplies by change no bit


def test_gnn_sampled_shapes():
    cfg = G.GraphSAGEConfig(name="t", d_in=8, n_classes=4, d_hidden=16, fanouts=(3, 2))
    p = G.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    hops = tuple(torch.randn(s) for s in ((5, 3, 2, 8), (5, 3, 8), (5, 8)))
    assert G.sampled_forward(p, hops, cfg).shape == (5, 4)


def test_gather_scatter_in_chunks_and_its_gradient():
    """The chunked gather-scatter op equals one index_select + index_add, at
    chunks that do and do not divide the edges, and its backward (the same
    op over the reversed edges) passes gradcheck in float64."""
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(7, 3)))
    src, dst = torch.from_numpy(rng.integers(0, 7, 20)), torch.from_numpy(rng.integers(0, 5, 20))
    w = torch.from_numpy(rng.random(20))
    whole = torch.zeros((5, 3), dtype=torch.float64).index_add(0, dst, h[src] * w[:, None])
    for chunk in (1, 3, 20, 64):
        np.testing.assert_allclose(G.gather_scatter(h, src, dst, 5, edge_weight=w, chunk=chunk).numpy(),
                                   whole.numpy(), rtol=1e-12, atol=1e-12)
        for ew in (None, w):
            f = lambda x: G.gather_scatter(x, src, dst, 5, edge_weight=ew, chunk=chunk)
            assert torch.autograd.gradcheck(f, (h.clone().requires_grad_(),))


# ------------------------------------------------- the three regimes, vs JAX
def _full_batch(seed=0):
    g = tdata.random_graph(seed, n_nodes=200, n_edges=1500, d_feat=16, n_classes=5)
    mask = (np.random.default_rng(seed).random(200) < 0.6).astype(np.float32)
    w = np.ones(1500, np.float32)
    w[-300:] = 0.0   # the last 300 edges are padding
    return {**g, "label_mask": mask, "edge_weight": w}


def _sampled(seed=0):
    g = tdata.random_graph(seed, n_nodes=300, n_edges=3000, d_feat=16, n_classes=5)
    csr = tdata.CSRGraph(300, g["edge_src"], g["edge_dst"])
    seeds = np.random.default_rng(seed).choice(300, 32, replace=False)
    return {"hops": tdata.sample_hops(csr, g["feats"], seeds, (3, 2), np.random.default_rng(seed)),
            "labels": g["labels"][seeds]}


def _graphs(seed=0):
    return tdata.batched_molecules(seed, 0, batch=8, n_nodes=30, n_edges=64, d_feat=16, n_classes=5)


REGIMES = {
    "full": (JG.gnn_loss_full, G.gnn_loss_full, _full_batch),
    "sampled": (JG.gnn_loss_sampled, G.gnn_loss_sampled, _sampled),
    "graphs": (JG.gnn_loss_graphs, G.gnn_loss_graphs, _graphs),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_regime_forward_loss_and_grads_match_the_reference(regime):
    jloss, tloss, make = REGIMES[regime]
    jcfg, cfg, jp, tp = _pair(dict(name="t", d_in=16, n_classes=5, n_layers=2, d_hidden=32, fanouts=(3, 2)))
    batch = make()
    jb = jax.tree.map(jnp.asarray, batch)
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(jp, jb, jcfg)
    tb = jax.tree.map(_t, batch)
    (tl, _), tg = value_and_grad(lambda p, b: tloss(p, b, cfg), tp, tb)
    _close(tl, jl)
    jgl, tgl = _leaves(jg), _leaves(tg)
    assert len(jgl) == len(tgl) == 8
    for a, b in zip(tgl, jgl):
        scale = float(np.max(np.abs(np.asarray(b))))
        _close(a, b, atol=RTOL * scale + ATOL)
    if regime == "full":   # the logits themselves, with and without padding edges
        for w in (None, batch["edge_weight"]):
            kw = {} if w is None else {"edge_weight": w}
            _close(G.full_batch_forward(tp, tb["feats"], tb["edge_src"], tb["edge_dst"], cfg,
                                        **{k: _t(v) for k, v in kw.items()}),
                   JG.full_batch_forward(jp, jb["feats"], jb["edge_src"], jb["edge_dst"], jcfg,
                                         **{k: jnp.asarray(v) for k, v in kw.items()}))
