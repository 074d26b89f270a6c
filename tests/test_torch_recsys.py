"""The port's recsys models on the CPU against the JAX package.

The same weights (the reference's ``init_params``, carried across by
``params_from_jax``) and the same batches (both packages' ``ctr_batch``,
bit for bit) go through both: ``forward``, ``recsys_loss`` and its
gradients (``torch.autograd`` against ``jax.grad``), ``user_tower``, the
embedding bags, and ``candidate_scores`` against the reference's Pallas
kernel in interpret mode and its plain version.  Tolerance: |a - b| <=
1e-4 * max(1, |b|) (float32 sums in another order); ids equal except where
two scores lie within that tolerance of each other.  The CUDA kernel that
``candidate_scores`` launches on the card runs in ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recsys_archs as jarchs
from repro.configs import shapes as jshapes
from repro.data.synthetic import ctr_batch as jax_ctr_batch
from repro.models import layers as JL
from repro.models import recsys as JR
from repro.models.base import init_params as jax_init_params
from repro.models.base import param_count as jax_param_count
from repro_torch.configs import recsys_archs, shapes
from repro_torch.data.synthetic import ctr_batch
from repro_torch.kernels.distance_topk import ops
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models.base import param_count, params_from_jax

ARCHS = ["bst", "dien", "autoint", "dcn-v2"]
TOL = 1e-4


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b)
    lim = tol * np.maximum(1.0, np.abs(b))
    assert (err <= lim).all(), f"off by up to {err.max()} (limit {lim[err > lim].min()})"


def _batch_kw(cfg, batch):
    return dict(batch=batch, field_vocabs=cfg.field_vocabs, n_dense=cfg.n_dense,
                seq_len=cfg.seq_len, seq_fields=cfg.seq_fields)


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, port config, reference config, reference params, port params
    on the CPU, a batch of 8) for one reduced architecture."""
    name = request.param
    cfg, jcfg = recsys_archs.get(name, reduced=True), jarchs.get(name, reduced=True)
    jp = jax_init_params(JR.param_specs(jcfg), jax.random.key(3))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg, device="cpu")
    return name, cfg, jcfg, jp, tp, ctr_batch(5, 1, **_batch_kw(cfg, 8))


# ------------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_the_reference_values(name, reduced):
    c, j = recsys_archs.get(name, reduced=reduced), jarchs.get(name, reduced=reduced)
    for f in fields(c):
        a, b = getattr(c, f.name), getattr(j, f.name)
        if f.name == "dtype":
            assert a == torch.float32 and b == jnp.float32
        else:
            assert a == b, f.name
    assert (c.total_vocab, c.field_offsets) == (j.total_vocab, j.field_offsets)
    specs, jspecs = R.param_specs(c), JR.param_specs(j)
    assert list(specs) == list(jspecs)
    for k in specs:
        assert specs[k].shape == jspecs[k].shape and specs[k].init == jspecs[k].init, k
    assert param_count(specs) == jax_param_count(jspecs)
    assert recsys_archs.FAMILY == jarchs.FAMILY and list(recsys_archs.ARCHS) == list(jarchs.ARCHS)


def test_recsys_shapes_are_the_reference_values():
    assert shapes.RECSYS_SHAPES == jshapes.RECSYS_SHAPES
    assert shapes.LM_SHAPES == jshapes.LM_SHAPES


def test_table_rows_pad_to_a_multiple_of_512():
    full = recsys_archs.get("bst")
    rows = R.param_specs(full)["table"].shape[0]
    assert rows % 512 == 0 and 0 <= rows - full.total_vocab < 512
    small = recsys_archs.get("dien", reduced=True)
    assert R.param_specs(small)["table"].shape[0] == small.total_vocab  # 400 rows: no pad


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_ctr_batch_is_the_reference_bit_for_bit(name, reduced):
    cfg = recsys_archs.get(name, reduced=reduced)
    for seed, step, shard in ((0, 0, 0), (7, 3, 1)):
        kw = _batch_kw(cfg, 33)
        a, b = ctr_batch(seed, step, shard=shard, **kw), jax_ctr_batch(seed, step, shard=shard, **kw)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------------ layers
def test_layer_norm_and_bce_are_the_reference():
    r = np.random.default_rng(1)
    x, g, b = r.normal(size=(5, 16)), r.normal(size=16), r.normal(size=16)
    x, g, b = (a.astype(np.float32) for a in (x, g, b))
    _close(L.layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)), 1e-5)
    logits = (r.normal(size=64) * 30).astype(np.float32)
    labels = r.integers(0, 2, 64).astype(np.float32)
    _close(L.bce_logits(torch.from_numpy(logits), torch.from_numpy(labels)),
           JL.bce_logits(jnp.asarray(logits), jnp.asarray(labels)), 1e-6)


# ---------------------------------------------------------------- embedding
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_jax(mode):
    r = np.random.default_rng(2)
    table = r.normal(size=(20, 4)).astype(np.float32)
    ids = r.integers(0, 20, size=(6, 5)).astype(np.int32)
    mask = (r.random((6, 5)) < 0.6).astype(np.float32)
    mask[:, 0] = 1.0
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(mask), mode=mode)
    want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask), mode=mode)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_modes_match_ragged(mode):
    """The masked fixed-shape bag equals the ragged bag over the unmasked
    ids (and the reference's ragged bag); an empty bag is 0."""
    r = np.random.default_rng(3)
    table = torch.from_numpy(r.normal(size=(30, 6)).astype(np.float32))
    ids = torch.from_numpy(r.integers(0, 30, size=(5, 7)).astype(np.int32))
    mask = torch.from_numpy((r.random((5, 7)) < 0.5).astype(np.float32))
    mask[3] = 0.0                                        # an empty bag
    dense = R.embedding_bag(table, ids, mask, mode=mode)
    keep = mask.bool()
    flat, seg = ids[keep], torch.nonzero(keep)[:, 0].to(torch.int32)
    ragged = R.embedding_bag_ragged(table, flat, seg, 5, mode=mode)
    _close(ragged, dense, 1e-6)
    assert (ragged[3] == 0).all()
    jr = JR.embedding_bag_ragged(jnp.asarray(table.numpy()), jnp.asarray(flat.numpy()),
                                 jnp.asarray(seg.numpy()), 5, mode=mode)
    _close(ragged, jr, 1e-6)


# ------------------------------------------------------------------- model
def test_forward_matches_jax(arch):
    _, cfg, jcfg, jp, tp, batch = arch
    got = R.forward(tp, batch, cfg)
    assert got.shape == (8,) and got.dtype == torch.float32
    _close(got, JR.forward(jp, _jax_batch(batch), jcfg))


def test_forward_takes_tensors_as_numpy(arch):
    _, cfg, _, _, tp, batch = arch
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert torch.equal(R.forward(tp, tb, cfg), R.forward(tp, batch, cfg))


def test_loss_and_gradients_match_jax(arch):
    _, cfg, jcfg, jp, tp, batch = arch
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, aux = R.recsys_loss(tp, batch, cfg)
    assert aux == {} and loss.shape == ()
    loss.backward()
    jloss, jgrads = jax.value_and_grad(lambda p: JR.recsys_loss(p, _jax_batch(batch), jcfg)[0])(jp)
    _close(loss.detach(), jloss)
    assert set(jgrads) == set(tp)
    for k, v in tp.items():
        # a weight the loss does not reach (the retrieval projection) has
        # no torch gradient and a zero JAX one
        g = v.grad if v.grad is not None else torch.zeros_like(v)
        _close(g, jgrads[k])
    assert tp["w_ret"].grad is None and tp["mlp_w0"].grad is not None


def test_user_tower_matches_jax(arch):
    _, cfg, jcfg, jp, tp, batch = arch
    got = R.user_tower(tp, batch, cfg)
    assert got.shape == (8, cfg.embed_dim)
    _close(got, JR.user_tower(jp, _jax_batch(batch), jcfg))


def test_init_params_draws_the_specs_from_the_generator():
    cfg = recsys_archs.get("dcn-v2", reduced=True)
    a = R.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = R.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    specs = R.param_specs(cfg)
    assert list(a) == list(specs)
    for k, s in specs.items():
        assert a[k].shape == s.shape and a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k
    assert (a["b_head"] == 0).all() and (a["cross_b"] == 0).all()
    assert 0.01 < float(a["table"].std()) < 0.03                      # "embed": std 0.02


# -------------------------------------------------------- candidate scoring
def _same_topk(s, i, js, ji):
    """Scores (descending) within the tolerance; ids equal except where the
    reference holds a score within the tolerance of the one moved."""
    s, i, js, ji = (np.asarray(a) for a in (s, i, js, ji))
    _close(s, js)
    for r, j in zip(*np.nonzero(i != ji)):
        hit = np.flatnonzero(ji[r] == i[r, j])
        ref = js[r, hit[0]] if len(hit) else js[r, -1]
        assert abs(s[r, j] - ref) <= 2 * TOL * max(1.0, abs(ref)), (r, j)


def test_candidate_scores_match_the_reference_kernel_in_interpret_mode():
    r = np.random.default_rng(6)
    q = r.normal(size=(2, 18)).astype(np.float32)
    cand = r.normal(size=(1000, 18)).astype(np.float32)
    s, i = R.candidate_scores(torch.from_numpy(q), torch.from_numpy(cand), 16)
    assert s.shape == i.shape == (2, 16) and i.dtype == torch.int32
    assert (torch.diff(s, dim=1) <= 0).all()
    js, ji = JR.candidate_scores(jnp.asarray(q), jnp.asarray(cand), 16, impl="pallas_interpret")
    _same_topk(s, i, js, ji)


def test_candidate_scores_match_the_reference_at_k_100():
    r = np.random.default_rng(7)
    q = r.normal(size=(1, 32)).astype(np.float32)
    cand = r.normal(size=(20000, 32)).astype(np.float32)
    ops.reset_launches()
    s, i = R.candidate_scores(torch.from_numpy(q), torch.from_numpy(cand), 100)
    assert ops.launches["distance_topk"] == 0  # CPU tensors: the plain version
    js, ji = JR.candidate_scores(jnp.asarray(q), jnp.asarray(cand), 100, impl="ref")
    _same_topk(s, i, js, ji)


def test_retrieval_cand_matches_jax(arch):
    """The slice as a whole: user tower, then the top 100 of the candidate
    embeddings, on the reference's weights and batch."""
    _, cfg, jcfg, jp, tp, _ = arch
    batch = ctr_batch(9, 0, **_batch_kw(cfg, 1))
    cand = np.random.default_rng(8).normal(size=(3000, cfg.embed_dim)).astype(np.float32)
    q = R.user_tower(tp, batch, cfg)
    s, i = R.candidate_scores(q, torch.from_numpy(cand), 100)
    jq = JR.user_tower(jp, _jax_batch(batch), jcfg)
    js, ji = JR.candidate_scores(jq, jnp.asarray(cand), 100, impl="ref")
    _same_topk(s, i, js, ji)
