"""The port's LM serving path on the CPU against the JAX package.

Same inputs (numpy, seeded) and the same weights (the reference's
``init_params``, carried across by ``params_from_jax``) go through both
packages: layers, ``attention`` (full, chunked, flash — JAX's flash in
Pallas interpret mode), ``forward``, ``prefill`` and ``decode_step`` of the
reduced phi4-mini and qwen2 configs.  Tolerances: 2e-4 in float32 (sums in
another order, over two layers), 2e-2 in bfloat16 (the two frameworks
round at other places).  The Hopper kernel itself runs only on the card
(``chip_smoke.py``).
"""
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.attention import attention as jax_attention
from repro.models.base import init_params as jax_init_params
from repro.models.base import param_count as jax_param_count
from repro_torch.configs import lm_archs, shapes
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import attention
from repro_torch.models.base import init_params, param_count, params_from_jax

ARCHS = ["phi4-mini-3.8b", "qwen2-7b"]
ALL_ARCHS = ["phi4-mini-3.8b", "mistral-large-123b", "qwen2-7b", "llama4-maverick-400b-a17b",
             "llama4-scout-17b-a16e"]
TORCH_OF = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=tol, atol=tol)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ------------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_are_the_reference_values(arch, reduced):
    c, j = lm_archs.get(arch, reduced=reduced), jarchs.get(arch, reduced=reduced)
    for f in fields(c):
        a, b = getattr(c, f.name), getattr(j, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert a == TORCH_OF[b], f.name
        elif f.name == "retrieval":
            assert (a.cluster_size, a.top_clusters) == (b.cluster_size, b.top_clusters)
        elif f.name == "moe" and b is not None:
            assert {g.name: getattr(a, g.name) for g in fields(a)} == {g.name: getattr(b, g.name) for g in fields(b)}
        else:
            assert a == b, f.name
    assert param_count(T.param_specs(c)) == jax_param_count(JT.param_specs(j))
    # the reference's two single-device training fields
    assert {"remat", "microbatches"} <= {f.name for f in fields(c)}
    assert (c.remat, c.microbatches) == (j.remat, j.microbatches)


def test_shapes_are_the_reference_values():
    from repro.configs.shapes import LM_SHAPES

    assert shapes.LM_SHAPES == LM_SHAPES


def test_unported_configs_and_paths_raise():
    from repro_torch.models import moe as M
    from repro_torch.models import retrieval_attention as R

    cfg = lm_archs.get("phi4-mini-3.8b", reduced=True)
    p = init_params(T.param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    rules = T.ShardingRules(model="model")
    for call in (lambda: T.prefill(p, toks, cfg, rules), lambda: T.forward(p, toks, cfg, rules),
                 lambda: T.decode_step(p, None, toks[:, 0], cfg, rules),
                 lambda: T.retrieval_decode_step(p, None, toks[:, 0], cfg, rules)):
        with pytest.raises(NotImplementedError, match="Queue 1 #13"):
            call()
    for fn in (M.moe_ffn_ep, R.retrieval_update_and_attend_sharded, R.retrieval_decode_attention_sharded,
               R._local_retrieval_attend):
        with pytest.raises(NotImplementedError, match=f"{fn.__name__}.*Queue 1 #13"):
            fn()
    # the empty rules are the single-device path
    T.prefill(p, toks, cfg, T.ShardingRules())


# -------------------------------------------------------------------- layers
def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    g, b = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    _close(L.rms_norm(_t(x), _t(g)), JL.rms_norm(x, g), 1e-5)
    _close(L.layer_norm(_t(x), _t(g), _t(b)), JL.layer_norm(x, g, b), 1e-5)
    pos = np.broadcast_to(np.arange(5)[None] * 7, (2, 5)).astype(np.int32)
    _close(L.rope(_t(x), torch.from_numpy(pos.copy())), JL.rope(x, pos), 1e-5)
    _close(L.rope(_t(x), torch.from_numpy(pos.copy()), 500000.0), JL.rope(x, pos, 500000.0), 1e-5)
    h = rng.normal(size=(4, 16)).astype(np.float32)
    wg, wu, wd = (rng.normal(size=s).astype(np.float32) for s in ((16, 24), (16, 24), (24, 16)))
    _close(L.swiglu(_t(h), _t(wg), _t(wu), _t(wd)), JL.swiglu(h, wg, wu, wd), 1e-4)
    b1, b2 = rng.normal(size=24).astype(np.float32), rng.normal(size=16).astype(np.float32)
    _close(L.gelu_mlp(_t(h), _t(wg), _t(b1), _t(wd), _t(b2)), JL.gelu_mlp(h, wg, b1, wd, b2), 1e-4)
    _close(L.dense(_t(h), _t(wg), _t(b1)), JL.dense(h, wg, b1), 1e-5)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 7))
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    _close(L.softmax_xent(_t(logits), torch.from_numpy(labels)), JL.softmax_xent(logits, labels), 1e-5)
    _close(L.softmax_xent(_t(logits), torch.from_numpy(labels), mask=_t(mask)),
           JL.softmax_xent(logits, labels, mask=mask), 1e-5)
    y = rng.integers(0, 2, size=9)
    _close(L.bce_logits(_t(logits[0, :, 0]), torch.from_numpy(y[:7])),
           JL.bce_logits(logits[0, :, 0], y[:7]), 1e-5)


def test_rms_norm_casts_where_the_reference_does():
    """bf16 in, bf16 out, normalized in float32 and cast before the gain."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 64)).astype(np.float32) * 5
    g = rng.normal(size=64).astype(np.float32)
    o = L.rms_norm(_t(x, torch.bfloat16), _t(g, torch.bfloat16))
    j = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16))
    assert o.dtype == torch.bfloat16
    np.testing.assert_array_equal(o.float().numpy(), np.asarray(j, np.float32))


# ----------------------------------------------------------------- attention
ATT_CASES = [
    (2, 4, 2, 40, 40, 16, True, None),
    (2, 4, 4, 33, 33, 32, False, None),
    (1, 6, 2, 24, 70, 16, True, None),        # chunked prefill, Sq < Skv
    (2, 4, 2, 1, 50, 16, True, (20, 50)),     # ragged decode
    (2, 4, 2, 5, 50, 16, True, (30, 50)),
]


@pytest.mark.parametrize("impl", ["full", "chunked", "flash"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d,causal,lens", ATT_CASES)
def test_attention_matches_the_reference(impl, B, Hq, Hkv, Sq, Skv, d, causal, lens):
    rng = np.random.default_rng(Sq * 131 + Skv)
    q = rng.normal(size=(B, Hq, Sq, d)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Skv, d)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Skv, d)).astype(np.float32)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    o = attention(_t(q), _t(k), _t(v), causal=causal, kv_lens=kv, impl=impl, chunk=16)
    j = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                      kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32),
                      impl="flash_interpret" if impl == "flash" else impl, chunk=16)
    assert o.dtype == torch.float32
    _close(o, j, 2e-5)


def test_chunked_attention_bf16_matches_the_reference():
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((1, 4, 48, 32), (1, 2, 48, 32), (1, 2, 48, 32)))
    o = attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16), impl="chunked", chunk=16)
    j = jax_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                      impl="chunked", chunk=16)
    _close(o, j, 2e-2)


def test_attention_rejects_an_unknown_impl():
    x = torch.zeros(1, 1, 2, 16)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(x, x, x, impl="flash_interpret")


# ---------------------------------------------------------------- the model
def _both(arch, dtype=None, seed=0):
    """(port cfg, JAX cfg, port params, JAX params): the JAX package's
    weights, with random QKV biases where the config has them."""
    c, j = lm_archs.get(arch, reduced=True), jarchs.get(arch, reduced=True)
    if dtype is not None:
        c, j = replace(c, dtype=TORCH_OF[dtype]), replace(j, dtype=dtype)
    jp = jax_init_params(JT.param_specs(j), jax.random.key(seed))
    if j.qkv_bias:
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            jp["layers"][name] = jnp.asarray(rng.normal(size=jp["layers"][name].shape) * 0.5, jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return c, j, params_from_jax(tree, c, device="cpu"), jp


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    c, j, p, jp = _both(arch)
    toks = _tokens(c, 2, 32)
    lg, aux = T.forward(p, torch.from_numpy(toks).long(), c)
    jl, _ = JT.forward(jp, jnp.asarray(toks), j)
    assert lg.shape == (2, 32, c.vocab) and lg.dtype == torch.float32 and float(aux) == 0.0
    _close(lg, jl, 2e-4)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, impl):
    c, j, p, jp = _both(arch)
    c = replace(c, attn_impl=impl)
    j = replace(j, attn_impl="flash_interpret" if impl == "flash" else impl)
    toks = _tokens(c, 2, 36)
    flash_ops.reset_launches()
    lg, cache = T.prefill(p, torch.from_numpy(toks[:, :32]).long(), c, max_seq=36)
    jl, jc = JT.prefill(jp, jnp.asarray(toks[:, :32]), j, max_seq=36)
    assert flash_ops.launches["flash_attention"] == 0    # CPU tensors: the plain version
    _close(lg, jl, 2e-4)
    _close(cache.k, jc.k, 2e-4)
    _close(cache.v, jc.v, 2e-4)
    assert cache.pos == int(jc.pos) == 32
    for t in range(32, 36):
        lg, cache = T.decode_step(p, cache, torch.from_numpy(toks[:, t]).long(), c)
        jl, jc = JT.decode_step(jp, jc, jnp.asarray(toks[:, t]), j)
        _close(lg, jl, 2e-4)
    _close(cache.k, jc.k, 2e-4)
    assert cache.pos == int(jc.pos) == 36


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_the_reference(arch):
    """In bfloat16 the logits are held by their relative L2 error, within
    2e-2: they are rounded to bf16 (2^-8) before the float32 cast, and the
    frameworks round at other places inside an op (XLA rounds each step of
    its bf16 logistic), so single logits may differ by a few bf16 ulps
    (measured: 0.6-1.3e-2 over seeds 0-3)."""
    c, j, p, jp = _both(arch, dtype=jnp.bfloat16)
    assert p["layers"][0]["wq"].dtype == torch.bfloat16
    toks = _tokens(c, 2, 20, seed=2)
    lg, cache = T.prefill(p, torch.from_numpy(toks[:, :16]).long(), c, max_seq=20)
    jl, jc = JT.prefill(jp, jnp.asarray(toks[:, :16]), j, max_seq=20)
    assert lg.dtype == torch.float32 and cache.k.dtype == torch.bfloat16
    assert _rel(lg, jl) < 2e-2
    for t in range(16, 20):
        lg, cache = T.decode_step(p, cache, torch.from_numpy(toks[:, t]).long(), c)
        jl, jc = JT.decode_step(jp, jc, jnp.asarray(toks[:, t]), j)
        assert _rel(lg, jl) < 2e-2


def test_decode_matches_forward():
    """The port alone, as the reference's test_lm_decode_matches_forward:
    after consuming tokens 0..19 the decode logits are forward's last row."""
    cfg = T.LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                     vocab=256, d_head=16, max_seq=64, dtype=torch.float32, attn_chunk=32, qkv_bias=True)
    g = torch.Generator().manual_seed(0)
    p = T.init_params(cfg, g, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=g)
    for impl in ("chunked", "flash", "full"):
        c = replace(cfg, attn_impl=impl)
        _, cache = T.prefill(p, toks[:, :16], c, max_seq=40)
        for t in range(16, 20):
            lg, cache = T.decode_step(p, cache, toks[:, t], c)
        full, _ = T.forward(p, toks[:, :20], c)
        _close(lg, full[:, -1], 2e-4)


def test_decode_refuses_a_full_cache():
    cfg = lm_archs.get("phi4-mini-3.8b", reduced=True)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, cache = T.prefill(p, torch.zeros((1, 4), dtype=torch.int64), cfg, max_seq=4)
    with pytest.raises(ValueError, match="all written"):
        T.decode_step(p, cache, torch.zeros(1, dtype=torch.int64), cfg)


# ----------------------------------------------------------- initialisation
def test_init_params_follow_the_specs():
    cfg = replace(lm_archs.get("qwen2-7b", reduced=True), d_model=256, d_ff=512, vocab=2048)
    specs = T.param_specs(cfg)
    p = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert len(p["layers"]) == cfg.n_layers
    for name, spec in specs["layers"][0].items():
        w = p["layers"][0][name]
        assert tuple(w.shape) == spec.shape and w.dtype == cfg.dtype, name
    lp = p["layers"][1]
    assert torch.all(lp["attn_norm"] == 1) and torch.all(lp["bq"] == 0)
    assert abs(float(lp["w_gate"].std()) - 1 / 16) < 3e-3           # fan_in 256
    assert abs(float(lp["w_down"].std()) - 1 / 512**0.5) < 2e-3     # fan_in 512
    assert abs(float(p["embed"].std()) - 0.02) < 1e-3
    assert not torch.equal(p["layers"][0]["wq"], p["layers"][1]["wq"])
    again = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again["lm_head"], p["lm_head"])
    jcfg = replace(jarchs.get("qwen2-7b", reduced=True), d_model=256, d_ff=512, vocab=2048)
    assert param_count(specs) == jax_param_count(JT.param_specs(jcfg))


def test_cuda_is_asked_for_by_default():
    cfg = lm_archs.get("phi4-mini-3.8b", reduced=True)
    if torch.cuda.is_available():
        assert T.init_cache(cfg, 1).k.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_cache(cfg, 1)
