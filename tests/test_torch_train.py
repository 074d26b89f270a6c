"""The port's LM training on the CPU against the JAX package's.

The same weights (the reference's ``init_params``, carried across as
float32 master weights by ``params_from_jax(..., dtype=float32)``) and the
same batches (``lm_batch``) go through both packages: ``lm_loss`` and its
gradients (torch autograd against ``jax.value_and_grad``) for the reduced
phi4-mini, qwen2-7b (QKV bias), llama4-scout (MoE every layer, aux loss)
and llama4-maverick (``moe_every=2`` blocks); chunked attention's
gradient with and without remat; three ``make_lm_trainer`` steps,
``make_train_step(microbatches=2)``, ``compress=True``; and a checkpoint
the reference wrote after 3 steps, resumed in the port for 3 more.

Tolerances.  Float32: 2e-5 relative on losses, and on gradients
``|a - b| <= 2e-5 * max|b|`` leaf by leaf (sums in another order, over two
to four layers and two query blocks).  Parameters after AdamW steps: every
entry within ``1e-6 + 1e-2 * lr`` and each leaf's relative L2 error within
2e-5: an update is about ``lr * sign(g)``, so rounding moves it only where
a gradient is near zero (measured here: at most 3.1e-3 lr).  bfloat16
(phi4): loss within 1e-2 relative, every gradient leaf's cosine >= 0.99
and its relative L2 error <= 6e-2 (the frameworks round bf16 products at
other places).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_tree as jax_save_tree
from repro.configs import lm_archs as jarchs
from repro.data import lm_batch
from repro.launch import cells as jcells
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.models.attention import attention as jax_attention
from repro.models.base import init_params as jax_init_params
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import load_tree
from repro_torch.configs import lm_archs
from repro_torch.launch.cells import make_train_step, value_and_grad
from repro_torch.launch.train import make_lm_trainer
from repro_torch.models import transformer as T
from repro_torch.models.attention import attention
from repro_torch.models.base import params_from_jax
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

ARCHS = ["phi4-mini-3.8b", "qwen2-7b", "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"]
LOSS_RTOL, GRAD_RTOL = 2e-5, 2e-5
SEQ = 97   # 96 positions after the shift: two query blocks of the reduced attn_chunk (64), the second short


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32), np.float32)


def _setup(arch, seed=0, dtype=None):
    jcfg, cfg = jarchs.get(arch, reduced=True), lm_archs.get(arch, reduced=True)
    if dtype is not None:
        jcfg, cfg = replace(jcfg, dtype=jnp.bfloat16), replace(cfg, dtype=torch.bfloat16)
    jp = jax_init_params(JT.param_specs(jcfg), jax.random.key(seed))
    return jcfg, cfg, jp, params_from_jax(jp, cfg, device="cpu", dtype=torch.float32)


def _tokens(cfg, seed=0, batch=2):
    return lm_batch(seed, 0, batch=batch, seq=SEQ, vocab=cfg.vocab)["tokens"]


def _grads_close(tg, jg, cfg, rtol=GRAD_RTOL):
    """The port's gradient tree against the reference's (carried to the
    port's layout), leaf by leaf relative to each leaf's largest entry."""
    jg = params_from_jax(jax.tree.map(np.asarray, jg), cfg, device="cpu", dtype=torch.float32)
    a, b = _leaves(tg), _leaves(jg)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = _f32(x), _f32(y)
        assert np.abs(x - y).max() <= rtol * np.abs(y).max() + 1e-12, (np.abs(x - y).max(), np.abs(y).max())


def _params_close(tp, jp, cfg, lr):
    a = _leaves(tp)
    b = _leaves(params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu", dtype=torch.float32))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = _f32(x), _f32(y)
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6 + 1e-2 * lr)
        assert np.linalg.norm(x - y) <= 2e-5 * np.linalg.norm(y)


# -------------------------------------------------------------- lm_loss + grads
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_the_reference(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    toks = _tokens(cfg)
    (jl, jm), jg = jax.value_and_grad(JT.lm_loss, has_aux=True)(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    (tl, tm), tg = value_and_grad(lambda p, b: T.lm_loss(p, b, cfg), tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=1e-9)
    if cfg.moe is not None:
        assert float(tm["aux"]) > 0
    _grads_close(tg, jg, cfg)


def test_lm_loss_and_grads_bf16_phi4():
    jcfg, cfg, jp, tp = _setup("phi4-mini-3.8b", dtype=torch.bfloat16)
    toks = _tokens(cfg)
    (jl, _), jg = jax.value_and_grad(JT.lm_loss, has_aux=True)(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    (tl, _), tg = value_and_grad(lambda p, b: T.lm_loss(p, b, cfg), tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    jg = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jg), cfg, device="cpu",
                         dtype=torch.float32)
    for x, y in zip(_leaves(tg), _leaves(jg)):
        assert x.dtype == torch.float32   # master weights' grads
        x, y = _f32(x).ravel(), _f32(y).ravel()
        cos = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y) + 1e-30))
        rel = float(np.linalg.norm(x - y) / (np.linalg.norm(y) + 1e-30))
        assert cos >= 0.99 and rel <= 6e-2, (cos, rel)


def test_master_weights_cast_inside_the_graph():
    """float32 master weights give the serving weights' (cfg.dtype) logits
    exactly, and their gradients are float32."""
    cfg = replace(lm_archs.get("phi4-mini-3.8b", reduced=True), dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    master = T.init_params(cfg, g, device="cpu", dtype=torch.float32)
    serving = tree_map(lambda x: x.to(torch.bfloat16), master)
    toks = torch.from_numpy(_tokens(cfg)[:, :40])
    with torch.no_grad():
        a, _ = T.forward(master, toks, cfg)
        b, _ = T.forward(serving, toks, cfg)
    assert torch.equal(a, b)
    (_, _), grads = value_and_grad(lambda p, bt: T.lm_loss(p, bt, cfg), master, {"tokens": toks})
    assert all(x.dtype == torch.float32 and torch.isfinite(x).all() for x in _leaves(grads))


# ------------------------------------------------------------ chunked + remat
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_gradient_with_and_without_remat(dtype):
    """_chunked's gradients with remat equal those without it bit for bit,
    and both the reference's (float32, 2e-5 of the largest entry; causal,
    GQA group 3, a short last block)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((2, 6, 40, 16), (2, 2, 40, 16), (2, 2, 40, 16)))
    do = rng.normal(size=(2, 6, 40, 16)).astype(np.float32)
    out = {}
    for remat in (True, False):
        ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
        o = attention(*ts, causal=True, impl="chunked", chunk=16, remat=remat)
        (o * torch.from_numpy(do)).sum().backward()
        out[remat] = [o.detach()] + [t.grad for t in ts]
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    if dtype == torch.float32:
        f = lambda q, k, v: jnp.sum(jax_attention(q, k, v, causal=True, impl="chunked", chunk=16) * do)
        jg = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
        for a, b in zip(out[True][1:], jg):
            b = np.asarray(b)
            assert np.abs(_f32(a) - b).max() <= GRAD_RTOL * np.abs(b).max()


def test_layer_remat_bit_for_bit_and_serving_unchanged():
    """cfg.remat changes no bit of the loss or the gradients; without grad
    (serving) the forward is the same either way."""
    cfg = lm_archs.get("qwen2-7b", reduced=True)
    p = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu", dtype=torch.float32)
    toks = {"tokens": torch.from_numpy(_tokens(cfg))}
    res = {}
    for remat in (True, False):
        c = replace(cfg, remat=remat)
        (l, _), g = value_and_grad(lambda pp, b: T.lm_loss(pp, b, c), p, toks)
        with torch.no_grad():
            logits, _ = T.forward(p, toks["tokens"], c)
        res[remat] = [l, logits] + _leaves(g)
    for a, b in zip(res[True], res[False]):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- the trainer
def _jax_state(jcfg, seed):
    jp = jax_init_params(JT.param_specs(jcfg), jax.random.key(seed))
    return jp


def _port_state(jp, cfg, *, compress=False):
    from repro_torch.optim import init_ef_state

    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu", dtype=torch.float32)
    return (tp, adamw(1.0).init(tp), init_ef_state(tp) if compress else None)


def test_three_trainer_steps_match_the_reference():
    arch = "phi4-mini-3.8b"
    jcfg, cfg = jarchs.get(arch, reduced=True), lm_archs.get(arch, reduced=True)
    lr = 3e-3
    jstep, _ = jtrain.make_lm_trainer(jcfg, lr=lr, total_steps=30)
    tstep, tinit = make_lm_trainer(cfg, lr=lr, total_steps=30, device="cpu")
    jp = _jax_state(jcfg, 3)
    js = (jp, jax_adamw(1.0).init(jp), None)
    ts = _port_state(jp, cfg)
    marks = []
    for i in range(3):
        b = lm_batch(0, i, batch=2, seq=SEQ, vocab=cfg.vocab)
        js, jm = jstep(js, {"tokens": jnp.asarray(b["tokens"])})
        ts, tm = tstep(ts, b, mark=marks.append)
        for k in ("loss", "xent", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=1e-9)
    assert marks == ["grads", "update"] * 3
    assert int(ts[1]["step"]) == int(js[1]["step"]) == 3
    _params_close(ts[0], js[0], cfg, lr)
    # the port's own init draws float32 master weights on the device asked for
    params, opt_state, ef = tinit(torch.Generator().manual_seed(0))
    assert all(x.dtype == torch.float32 and x.device.type == "cpu" for x in _leaves(params))
    assert ef is None and int(opt_state["step"]) == 0


def test_trainer_with_compression_tracks_the_reference():
    """compress=True (int8 with error feedback before AdamW; each weight's
    per-layer leaves share the scale of the reference's stacked leaf; the
    round trip equals the reference's bit for bit on the same input,
    tests/test_torch_optim.py).  A gradient within rounding of a half code
    step can take the other code in either package, and AdamW turns that
    entry's gradient into an update of up to lr: held are the losses
    (2e-5), and per leaf at most 1% of the entries (measured 0.15%) off by
    more than ``1e-6 + 1e-2 * lr``, none by more than lr (measured 0.47 lr),
    after 3 steps; and of the error feedback (a rounding remainder: a
    flipped code moves it a whole step) per leaf at most 2% of the entries
    (measured 1.6%, one of a 64-entry leaf) off by more than 2e-2 of the
    leaf's largest."""
    arch = "llama4-scout-17b-a16e"
    jcfg, cfg = jarchs.get(arch, reduced=True), lm_archs.get(arch, reduced=True)
    lr = 3e-3
    jstep, _ = jtrain.make_lm_trainer(jcfg, lr=lr, total_steps=30, compress=True)
    tstep, _ = make_lm_trainer(cfg, lr=lr, total_steps=30, compress=True, device="cpu")
    from repro.optim import init_ef_state as jinit_ef

    jp = _jax_state(jcfg, 3)
    js = (jp, jax_adamw(1.0).init(jp), jinit_ef(jp))
    ts = _port_state(jp, cfg, compress=True)
    for i in range(3):
        b = lm_batch(0, i, batch=2, seq=SEQ, vocab=cfg.vocab)
        js, jm = jstep(js, {"tokens": jnp.asarray(b["tokens"])})
        ts, tm = tstep(ts, b)
        for k in ("loss", "xent", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=1e-9)
    conv = lambda t: _leaves(params_from_jax(jax.tree.map(np.asarray, t), cfg, device="cpu", dtype=torch.float32))
    for x, y in zip(_leaves(ts[0]), conv(js[0])):
        d = np.abs(_f32(x) - _f32(y))
        assert (d > 1e-6 + 1e-2 * lr).mean() <= 0.01 and d.max() <= lr, ((d > 1e-6 + 1e-2 * lr).mean(), d.max())
    for e, ej in zip(_leaves(ts[2]), conv(js[2])):
        d = np.abs(_f32(e) - _f32(ej))
        assert e.dtype == torch.float32 and (d > 2e-2 * np.abs(_f32(ej)).max()).mean() <= 0.02


def test_make_train_step_microbatches_match_the_reference():
    jcfg, cfg = jarchs.get("qwen2-7b", reduced=True), lm_archs.get("qwen2-7b", reduced=True)
    lr = 1e-2
    jraw = jax.jit(jcells.make_train_step(lambda p, b: JT.lm_loss(p, b, jcfg), jax_adamw(lr), microbatches=2))
    # the reference decays its stacked [L, D] norm gains and [L, F] biases: the port's
    # per-layer leaves are 1-D, so its adamw is told which leaves to decay
    tstep = make_train_step(lambda p, b: T.lm_loss(p, b, cfg), adamw(lr, decay_mask=T.decay_mask(cfg)),
                            microbatches=2)
    jp = _jax_state(jcfg, 5)
    jo = jax_adamw(lr).init(jp)
    tp, to, _ = _port_state(jp, cfg)
    for i in range(2):
        b = lm_batch(1, i, batch=4, seq=SEQ, vocab=cfg.vocab)
        jp, jo, jm = jraw(jp, jo, {"tokens": jnp.asarray(b["tokens"])})
        tp, to, tm = tstep(tp, to, b)
        for k in ("loss", "xent", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=1e-9)
    _params_close(tp, jp, cfg, lr)
    for m in ("mu", "nu"):
        b = params_from_jax(jax.tree.map(np.asarray, jo[m]), cfg, device="cpu", dtype=torch.float32)
        for x, y in zip(_leaves(to[m]), _leaves(b)):
            assert np.abs(_f32(x) - _f32(y)).max() <= 1e-4 * np.abs(_f32(y)).max() + 1e-12


def test_resume_from_a_reference_checkpoint(tmp_path):
    """The reference trains 6 steps and saves its state after the third; the
    port loads that checkpoint (its own load_tree; the moments carried
    across like the weights) and trains 3 more: the same parameters."""
    arch = "llama4-maverick-400b-a17b"
    jcfg, cfg = jarchs.get(arch, reduced=True), lm_archs.get(arch, reduced=True)
    lr = 3e-3
    jstep, _ = jtrain.make_lm_trainer(jcfg, lr=lr, total_steps=30)
    tstep, _ = make_lm_trainer(cfg, lr=lr, total_steps=30, device="cpu")
    jp = _jax_state(jcfg, 9)
    js = (jp, jax_adamw(1.0).init(jp), None)
    batches = [lm_batch(2, i, batch=2, seq=SEQ, vocab=cfg.vocab) for i in range(6)]
    for i, b in enumerate(batches):
        js, _ = jstep(js, {"tokens": jnp.asarray(b["tokens"])})
        if i == 2:
            jax_save_tree(str(tmp_path / "step_00000003"), js, attrs={"step": 3})
    tree, meta = load_tree(str(tmp_path / "step_00000003"))
    assert meta["step"] == 3 and tree[2] is None and isinstance(tree, tuple)
    conv = lambda t: params_from_jax(t, cfg, device="cpu", dtype=torch.float32)
    ts = (conv(tree[0]), {"mu": conv(tree[1]["mu"]), "nu": conv(tree[1]["nu"]),
                          "step": torch.from_numpy(np.array(tree[1]["step"]))}, None)
    assert ts[1]["step"].dtype == torch.int32 and int(ts[1]["step"]) == 3
    for b in batches[3:]:
        ts, _ = tstep(ts, b)
    _params_close(ts[0], js[0], cfg, lr)
