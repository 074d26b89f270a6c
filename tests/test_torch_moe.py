"""The port's MoE FFN and the llama4 configs on the CPU against the JAX package.

``moe_ffn`` on the same numpy inputs in both packages: the same expert for
every token, the same tokens dropped past capacity (a skewed router that
overflows it), outputs and the Switch aux loss within 2e-4 in float32.
Then ``forward`` (logits and aux), ``prefill`` and ``decode_step`` of the
reduced llama4-scout (MoE every layer) and llama4-maverick (dense/MoE
blocks) configs on the reference's weights, carried across by
``params_from_jax``; and the twins of the reference's MoE tests
(``tests/test_models.py``).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.base import init_params as jax_init_params
from repro_torch.configs import lm_archs
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.base import params_from_jax

MOE_ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"]
TOL = 2e-4


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _moe_inputs(seed, T_, D, E, F, *, skew=0.0):
    """x, router, expert weights; ``skew`` adds a bias towards expert 0
    through a column of the router aligned with the tokens' mean."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T_, D)).astype(np.float32) + skew
    router = rng.normal(size=(D, E)).astype(np.float32)
    router[:, 0] += skew
    wg = (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32)
    wu = (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32)
    wd = (rng.normal(size=(E, F, D)) * 0.1).astype(np.float32)
    return x, router, wg, wu, wd


CASES = [  # (seed, T, D, E, F, capacity_factor, skew)
    (0, 64, 16, 8, 32, 2.0, 0.0),
    (1, 64, 16, 8, 32, 1.0, 0.0),
    (2, 96, 24, 4, 16, 1.25, 0.5),     # skewed: expert 0 overflows
    (3, 33, 16, 16, 8, 0.5, 0.0),      # capacity 1
    (4, 1, 16, 4, 8, 1.25, 0.0),       # one token (a decode step at batch 1)
]


@pytest.mark.parametrize("seed,T_,D,E,F,cf,skew", CASES)
def test_moe_ffn_matches_the_reference(seed, T_, D, E, F, cf, skew):
    x, router, wg, wu, wd = _moe_inputs(seed, T_, D, E, F, skew=skew)
    cfg, jcfg = M.MoEConfig(n_experts=E, d_ff=F, capacity_factor=cf), JM.MoEConfig(n_experts=E, d_ff=F, capacity_factor=cf)
    y, aux = M.moe_ffn(_t(x), _t(router), _t(wg), _t(wu), _t(wd), cfg)
    jy, jaux = jax.jit(JM.moe_ffn, static_argnums=5)(jnp.asarray(x), jnp.asarray(router), jnp.asarray(wg),
                                                     jnp.asarray(wu), jnp.asarray(wd), jcfg)
    _, _, eidx = M.route(_t(x), _t(router))
    jeidx = np.asarray(jnp.argmax(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1), axis=-1))
    np.testing.assert_array_equal(eidx.numpy(), jeidx)
    dropped, jdropped = (y == 0).all(dim=1).numpy(), np.all(np.asarray(jy) == 0, axis=1)
    np.testing.assert_array_equal(dropped, jdropped)
    C = M.capacity(cfg, T_)
    counts = np.bincount(jeidx, minlength=E)
    assert dropped.sum() == np.maximum(counts - C, 0).sum()
    if skew:
        assert counts[0] > C and dropped.sum() > 0
    _close(y, jy)
    _close(aux, jaux)


def test_moe_keeps_each_experts_first_tokens():
    """Capacity keeps an expert's first C tokens in token order (a stable
    sort), and each kept token's output is gate * swiglu(x; W_e)."""
    x, router, wg, wu, wd = _moe_inputs(5, 80, 16, 4, 8, skew=0.7)
    cfg = M.MoEConfig(n_experts=4, d_ff=8, capacity_factor=1.0)
    y, _ = M.moe_ffn(_t(x), _t(router), _t(wg), _t(wu), _t(wd), cfg)
    _, gate, eidx = M.route(_t(x), _t(router))
    C = M.capacity(cfg, 80)
    for e in range(4):
        toks = np.flatnonzero(eidx.numpy() == e)
        for rank, t in enumerate(toks):
            if rank >= C:
                assert (y[t] == 0).all()
                continue
            xt = _t(x[t])
            ref = gate[t] * ((torch.nn.functional.silu(xt @ _t(wg[e])) * (xt @ _t(wu[e]))) @ _t(wd[e]))
            _close(y[t], ref, 1e-5)


# twins of the reference's tests/test_models.py MoE tests
def test_moe_top1_routes_and_balances():
    rng = np.random.default_rng(0)
    cfg = M.MoEConfig(n_experts=8, d_ff=32, capacity_factor=2.0)
    x = _t(rng.normal(size=(64, 16)))
    router = _t(rng.normal(size=(16, 8)))
    wg, wu = _t(rng.normal(size=(8, 16, 32)) * 0.1), _t(rng.normal(size=(8, 16, 32)) * 0.1)
    wd = _t(rng.normal(size=(8, 32, 16)) * 0.1)
    y, aux = M.moe_ffn(x, router, wg, wu, wd, cfg)
    assert y.shape == x.shape and np.isfinite(float(aux))
    assert float(y.abs().mean()) > 0


def test_moe_dropped_tokens_zeroed():
    cfg = M.MoEConfig(n_experts=2, d_ff=8, capacity_factor=0.01)  # capacity 1
    x = _t(np.random.default_rng(0).normal(size=(32, 8)))
    router = torch.zeros((8, 2))  # all tokens to expert 0 (argmax tie: the first index)
    w = torch.ones((2, 8, 8))
    y, _ = M.moe_ffn(x, router, w, w, w, cfg)
    assert int((y != 0).any(dim=1).sum()) <= 2
    assert (y[1:] == 0).all() and (y[0] != 0).all()    # the first token in order is the one kept


# ------------------------------------------------------------ llama4 models
def _both(arch, seed=0):
    c, j = lm_archs.get(arch, reduced=True), jarchs.get(arch, reduced=True)
    jp = jax_init_params(JT.param_specs(j), jax.random.key(seed))
    return c, j, params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu"), jp


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_jax_carries_moe_trees(arch):
    c, j, p, jp = _both(arch)
    assert len(p["layers"]) == c.n_layers
    if c.moe_every == 2:   # each block's dense layer, then its MoE layer
        stacks = [(jp["layers"]["dense"], i // 2) if i % 2 == 0 else (jp["layers"]["moe"], i // 2)
                  for i in range(c.n_layers)]
    else:
        stacks = [(jp["layers"], i) for i in range(c.n_layers)]
    for lp, (stack, i), specs in zip(p["layers"], stacks, T.param_specs(c)["layers"]):
        assert set(lp) == set(stack) == set(specs)
        for name, w in lp.items():
            assert tuple(w.shape) == specs[name].shape
            np.testing.assert_array_equal(w.numpy(), np.asarray(stack[name][i]))
    assert ["router" in lp for lp in p["layers"]] == (
        [i % 2 == 1 for i in range(c.n_layers)] if c.moe_every == 2 else [True] * c.n_layers)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_the_reference(arch):
    c, j, p, jp = _both(arch)
    toks = _tokens(c, 2, 32)
    lg, aux = T.forward(p, torch.from_numpy(toks).long(), c)
    jl, jaux = jax.jit(lambda pp, tt: JT.forward(pp, tt, j))(jp, jnp.asarray(toks))
    assert lg.shape == (2, 32, c.vocab) and aux.dtype == torch.float32 and float(aux) > 0
    _close(lg, jl)
    _close(aux, jaux)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_the_reference(arch, impl):
    c, j, p, jp = _both(arch)
    c = replace(c, attn_impl=impl)
    j = replace(j, attn_impl="flash_interpret" if impl == "flash" else impl)
    toks = _tokens(c, 2, 36, seed=3)
    lg, cache = T.prefill(p, torch.from_numpy(toks[:, :32]).long(), c, max_seq=36)
    jl, jc = jax.jit(lambda pp, tt: JT.prefill(pp, tt, j, max_seq=36))(jp, jnp.asarray(toks[:, :32]))
    jdecode = jax.jit(lambda pp, cc, tt: JT.decode_step(pp, cc, tt, j))
    _close(lg, jl)
    _close(cache.k, jc.k)
    _close(cache.v, jc.v)
    for t in range(32, 36):
        lg, cache = T.decode_step(p, cache, torch.from_numpy(toks[:, t]).long(), c)
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, t]))
        _close(lg, jl)
    _close(cache.k, jc.k)
    _close(cache.v, jc.v)
    assert cache.pos == int(jc.pos) == 36


def test_moe_every_must_be_one_or_two_over_whole_blocks():
    c = lm_archs.get("llama4-maverick-400b-a17b", reduced=True)
    with pytest.raises(ValueError, match="moe_every must be 1 or 2"):
        T.param_specs(replace(c, moe_every=3))
    with pytest.raises(ValueError, match="even layer count"):
        T.param_specs(replace(c, n_layers=3))
