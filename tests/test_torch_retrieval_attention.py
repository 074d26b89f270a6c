"""The port's eCP retrieval attention on the CPU against the JAX package.

Same numpy inputs through both packages, at the reduced configs (float32,
clusters of 16 tokens, top_b = 2; a 128-token cache holds 8 clusters):
``clustered_cache_update`` bit for bit (the port writes in place, the
reference returns new arrays), ``retrieval_decode_attention`` within 2e-4
around cluster boundaries and with ``top_b`` past the cluster count, and
``retrieval_decode_step`` of the reduced phi4-mini, qwen2 (QKV bias),
llama4-scout (MoE) and llama4-maverick (dense/MoE blocks) over 40 steps,
which cross two cluster boundaries, on the reference's weights.  Then the
twins of the reference's retrieval tests (``tests/test_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.models import retrieval_attention as JR
from repro.models import transformer as JT
from repro.models.base import init_params as jax_init_params
from repro_torch.configs import lm_archs
from repro_torch.models import retrieval_attention as R
from repro_torch.models import transformer as T
from repro_torch.models.base import params_from_jax

TOL = 2e-4
CS, NC, D, HKV, HQ = 16, 8, 16, 2, 4


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _filled_cache(seed, pos, B=2):
    """A layer's clustered cache [B, Hkv, nC, cs, d] holding ``pos`` random
    tokens (zeros past them) and its centroids, the mean of each cluster's
    written keys."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, HKV, NC, CS, D)).astype(np.float32)
    v = rng.normal(size=(B, HKV, NC, CS, D)).astype(np.float32)
    written = (np.arange(NC * CS) < pos).reshape(NC, CS)
    k, v = k * written[..., None], v * written[..., None]
    n = np.maximum(written.sum(1), 1)[:, None]
    cent = (k.sum(3) / n).astype(np.float32)
    return k, v, cent


@pytest.mark.parametrize("pos", [0, 1, 15, 16, 17, 31, 32, 100, 127])
def test_cache_update_is_bit_identical(pos):
    """One token written at ``pos``: the slot (pos // cs, pos % cs) and the
    running-mean centroid bit for bit, at the first slot of a cluster
    (pos % cs == 0), at its last and in between."""
    k, v, cent = _filled_cache(pos, pos)
    rng = np.random.default_rng(1000 + pos)
    kn, vn = rng.normal(size=(2, HKV, D)).astype(np.float32), rng.normal(size=(2, HKV, D)).astype(np.float32)
    tk, tv, tc = _t(k), _t(v), _t(cent)
    assert R.clustered_cache_update(tk, tv, tc, _t(kn), _t(vn), pos, CS) is None   # in place
    jk, jv, jc = JR.clustered_cache_update(jnp.asarray(k), jnp.asarray(v), jnp.asarray(cent), jnp.asarray(kn),
                                           jnp.asarray(vn), jnp.asarray(pos, jnp.int32), CS)
    for a, b in ((tk, jk), (tv, jv), (tc, jc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tk[:, :, pos // CS, pos % CS].numpy(), kn)


def test_cache_updates_in_sequence_are_bit_identical():
    """40 tokens into an empty layer cache one by one (crossing two cluster
    boundaries): the same arrays bit for bit after every write."""
    rng = np.random.default_rng(7)
    z = np.zeros((1, HKV, NC, CS, D), np.float32)
    tk, tv, tc = _t(z), _t(z), _t(z[:, :, :, 0])
    jk, jv, jc = jnp.asarray(z), jnp.asarray(z), jnp.asarray(z[:, :, :, 0])
    upd = jax.jit(JR.clustered_cache_update, static_argnums=6)
    for pos in range(40):
        kn, vn = rng.normal(size=(1, HKV, D)).astype(np.float32), rng.normal(size=(1, HKV, D)).astype(np.float32)
        R.clustered_cache_update(tk, tv, tc, _t(kn), _t(vn), pos, CS)
        jk, jv, jc = upd(jk, jv, jc, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos, jnp.int32), CS)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("pos,top_b", [(1, 2), (16, 2), (17, 2), (31, 2), (32, 2), (100, 2), (100, 1), (100, 12)])
def test_decode_attention_matches_the_reference(pos, top_b):
    """``pos`` 1: no complete cluster; 16: the current cluster is full, none
    before it complete; 17, 32: one / two complete; 12 > nC."""
    k, v, cent = _filled_cache(pos + 50, pos)
    q = np.random.default_rng(pos).normal(size=(2, HQ, D)).astype(np.float32)
    o = R.retrieval_decode_attention(_t(q), _t(k), _t(v), _t(cent), pos, cs=CS, top_b=top_b)
    attend = jax.jit(JR.retrieval_decode_attention, static_argnames=("cs", "top_b"))
    j = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cent), jnp.asarray(pos, jnp.int32),
               cs=CS, top_b=top_b)
    assert o.shape == (2, HQ, D) and o.dtype == torch.float32
    _close(o, j)


def test_decode_attention_over_every_cluster_is_exact_attention():
    """top_b at or past the complete clusters: exact attention over the
    ``pos`` valid tokens (the port's chunked attention)."""
    from repro_torch.models.attention import attention

    pos = 101
    k, v, cent = _filled_cache(3, pos)
    q = np.random.default_rng(4).normal(size=(2, HQ, D)).astype(np.float32)
    o = R.retrieval_decode_attention(_t(q), _t(k), _t(v), _t(cent), pos, cs=CS, top_b=NC)
    flat = lambda a: _t(a).reshape(2, HKV, NC * CS, D)
    e = attention(_t(q)[:, :, None], flat(k), flat(v), causal=True, kv_lens=torch.full((2,), pos), impl="chunked")
    _close(o, e[:, :, 0])


# ---------------------------------------------------------- the decode step
STEP_ARCHS = ["phi4-mini-3.8b", "qwen2-7b", "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"]


def _both(arch, seed=0):
    c, j = lm_archs.get(arch, reduced=True), jarchs.get(arch, reduced=True)
    jp = jax_init_params(JT.param_specs(j), jax.random.key(seed))
    if j.qkv_bias:
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            jp["layers"][name] = jnp.asarray(rng.normal(size=jp["layers"][name].shape) * 0.5, jnp.float32)
    return c, j, params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu"), jp


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_retrieval_decode_step_matches_the_reference(arch):
    c, j, p, jp = _both(arch)
    toks = np.random.default_rng(5).integers(0, c.vocab, size=(2, 40)).astype(np.int32)
    cache = R.init_clustered_cache(c.n_layers, 2, c.n_kv_heads, c.max_seq, CS, c.d_head, c.dtype, device="cpu")
    jc = JR.init_clustered_cache(j.n_layers, 2, j.n_kv_heads, j.max_seq, CS, j.d_head, j.dtype)
    step = jax.jit(lambda pp, cc, tt: JT.retrieval_decode_step(pp, cc, tt, j))
    for t in range(40):
        lg, cache2 = T.retrieval_decode_step(p, cache, torch.from_numpy(toks[:, t]).long(), c)
        assert cache2.k is cache.k and cache2.pos == cache.pos + 1     # in place
        cache = cache2
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t]))
        _close(lg, jl)
    assert cache.pos == int(jc.pos) == 40
    _close(cache.k, jc.k)
    _close(cache.v, jc.v)
    _close(cache.centroids, jc.centroids)


def test_retrieval_decode_step_refuses_a_full_cache():
    c = lm_archs.get("phi4-mini-3.8b", reduced=True)
    p = T.init_params(c, torch.Generator().manual_seed(0), device="cpu")
    cache = R.init_clustered_cache(c.n_layers, 1, c.n_kv_heads, CS, CS, c.d_head, c.dtype, device="cpu")
    cache.pos = CS
    with pytest.raises(ValueError, match="all written"):
        T.retrieval_decode_step(p, cache, torch.zeros(1, dtype=torch.int64), c)


# twins of the reference's tests/test_models.py retrieval tests
def _tiny(top_b):
    return T.LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      d_head=16, max_seq=64, dtype=torch.float32, attn_chunk=32,
                      retrieval=R.RetrievalAttnConfig(cluster_size=8, top_clusters=top_b))


def test_retrieval_decode_approximates_full_attention():
    """With top_b covering ALL clusters, retrieval decode == exact decode."""
    cfg = _tiny(8)
    g = torch.Generator().manual_seed(0)
    p = T.init_params(cfg, g, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=g)
    cc = R.init_clustered_cache(cfg.n_layers, 2, cfg.n_kv_heads, 64, 8, cfg.d_head, torch.float32, device="cpu")
    kc = T.init_cache(cfg, 2, 64, device="cpu")
    for t in range(33):
        lg_r, cc = T.retrieval_decode_step(p, cc, toks[:, t], cfg)
        lg_f, kc = T.decode_step(p, kc, toks[:, t], cfg)
    _close(lg_r, lg_f, 5e-3)


def test_retrieval_decode_subquadratic_selects_fewer():
    cfg = _tiny(1)
    g = torch.Generator().manual_seed(1)
    p = T.init_params(cfg, g, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 50), generator=g)
    cc = R.init_clustered_cache(cfg.n_layers, 1, cfg.n_kv_heads, 64, 8, cfg.d_head, torch.float32, device="cpu")
    for t in range(45):
        lg, cc = T.retrieval_decode_step(p, cc, toks[:, t], cfg)
    assert torch.isfinite(lg).all()
