"""The port's optimizers, schedules and gradient compression on the CPU
against the JAX package's (``repro.optim``).

The twins of ``tests/test_optim.py`` run on the port; then the same trees
(numpy, seeded) go through both packages: AdamW and SGD with momentum for 5
steps (clipping on and off, float32 and bfloat16 moments), the schedules
at steps 0-300, and the int8 round trip with error feedback.  Tolerances:
1e-6 relative (+1e-9 absolute) for the float32 updates and schedules (the
same float32 operations in the same order; XLA's transcendental functions
and sums may round the last bit elsewhere), one bfloat16 ulp (2^-8
relative) for bf16 moments, and the int8 codes bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import optim as J
from repro_torch.optim import (
    adamw,
    apply_updates,
    compress_decompress,
    constant,
    dequantize_int8,
    global_norm,
    init_ef_state,
    quantize_int8,
    sgd_momentum,
    warmup_cosine,
    warmup_linear_decay,
)

RTOL, ATOL = 1e-6, 1e-9


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32), np.float32)


def _grad(loss, params):
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss(p).backward()
    return {k: v.grad for k, v in p.items()}


# ------------------------------------------------- twins of tests/test_optim.py
def test_adamw_converges_quadratic():
    opt = adamw(0.1, wd=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    target = torch.tensor([1.0, 2.0])
    loss = lambda p: torch.sum((p["w"] - target) ** 2)
    for _ in range(200):
        upd, state = opt.update(_grad(loss, params), state, params)
        params = apply_updates(params, upd)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_adamw_weight_decay_skips_1d():
    opt = adamw(0.1, wd=0.5)
    params = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    state = opt.init(params)
    upd, _ = opt.update({k: torch.zeros_like(v) for k, v in params.items()}, state, params)
    assert float(torch.max(torch.abs(upd["b"]))) == 0.0
    assert float(torch.max(torch.abs(upd["w"]))) > 0.0


def test_clipping_bounds_update():
    opt = adamw(1.0, clip=1.0, wd=0.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    upd, _ = opt.update({"w": torch.tensor([1e6, -1e6, 1e6])}, state, params)
    assert torch.isfinite(upd["w"]).all()


def test_bf16_moments_still_converge():
    opt = adamw(0.1, wd=0.0, moment_dtype=torch.bfloat16)
    params = {"w": torch.tensor([4.0])}
    state = opt.init(params)
    assert state["mu"]["w"].dtype == torch.bfloat16
    loss = lambda p: torch.sum(p["w"] ** 2)
    for _ in range(100):
        upd, state = opt.update(_grad(loss, params), state, params)
        params = apply_updates(params, upd)
    assert abs(float(params["w"][0])) < 0.1


def test_schedule_shapes():
    f = warmup_cosine(1.0, 10, 100)
    assert float(f(torch.tensor(0))) == 0.0
    assert abs(float(f(torch.tensor(10))) - 1.0) < 1e-6
    assert float(f(torch.tensor(100))) < float(f(torch.tensor(50)))
    assert float(constant(0.5)(torch.tensor(7))) == 0.5


def test_compression_error_feedback_unbiased_over_steps():
    rng = np.random.default_rng(0)
    g_true = [{"w": _t(rng.normal(size=64))} for _ in range(50)]
    ef = init_ef_state(g_true[0])
    total_c = torch.zeros(64)
    total_t = torch.zeros(64)
    for g in g_true:
        dec, ef = compress_decompress(g, ef)
        total_c = total_c + dec["w"]
        total_t = total_t + g["w"]
    resid = float(torch.max(torch.abs(total_c - total_t)))
    assert resid < 0.2, resid


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31))
def test_quantize_roundtrip_bounded(seed):
    r = np.random.default_rng(seed)
    x = _t(r.normal(size=32) * r.uniform(0.01, 100))
    q, s = quantize_int8(x)
    err = torch.max(torch.abs(dequantize_int8(q, s) - x))
    assert float(err) <= float(s) / 2 + 1e-6


# ------------------------------------------------------- against the reference
def _tree(rng):
    """A parameter-like tree: 2-D weights (decayed), a 1-D gain (not), a list."""
    return {
        "w": rng.normal(size=(6, 5)).astype(np.float32),
        "g": (1 + 0.1 * rng.normal(size=5)).astype(np.float32),
        "layers": [{"a": rng.normal(size=(3, 4)).astype(np.float32)},
                   {"a": rng.normal(size=(3, 4)).astype(np.float32)}],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _same_trees(a, b, rtol=RTOL, atol=ATOL):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_np(x), _np(y), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["adamw", "adamw_noclip", "adamw_bf16", "adamw_schedule", "sgd", "sgd_clip"])
def test_updates_match_the_reference_for_5_steps(kind):
    """The same parameters and gradients (each step's drawn anew, the first
    large enough that clipping binds) through both packages' optimizers:
    updates, parameters and state at every step."""
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    grads = [_map(lambda a: (a * 0 + rng.normal(size=a.shape) * (3.0 if i == 0 else 0.3)).astype(np.float32), p0)
             for i in range(5)]
    bf16 = kind == "adamw_bf16"
    if kind.startswith("adamw"):
        lr_j = J.warmup_cosine(1e-2, 2, 5) if kind == "adamw_schedule" else 1e-2
        lr_t = warmup_cosine(1e-2, 2, 5) if kind == "adamw_schedule" else 1e-2
        clip = None if kind == "adamw_noclip" else 1.0
        jopt = J.adamw(lr_j, clip=clip, wd=0.1, moment_dtype=jnp.bfloat16 if bf16 else jnp.float32)
        topt = adamw(lr_t, clip=clip, wd=0.1, moment_dtype=torch.bfloat16 if bf16 else torch.float32)
    else:
        clip = 1.0 if kind == "sgd_clip" else None
        jopt, topt = J.sgd_momentum(1e-2, clip=clip), sgd_momentum(1e-2, clip=clip)
    jp = _map(jnp.asarray, p0)
    tp = _map(_t, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(_map(jnp.asarray, g), js, jp)
        jp = J.apply_updates(jp, ju)
        tu, ts = topt.update(_map(_t, g), ts, tp)
        _same_trees(tu, ju)
        tp = apply_updates(tp, tu)
        _same_trees(tp, jp)
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
        moments = ("mu", "nu") if kind.startswith("adamw") else ("mom",)
        for m in moments:
            assert all(x.dtype == (torch.bfloat16 if bf16 else torch.float32) for x in _leaves(ts[m]))
            _same_trees(ts[m], js[m], rtol=2**-8 if bf16 else RTOL)


def test_global_norm_matches_the_reference():
    t = _tree(np.random.default_rng(3))
    np.testing.assert_allclose(float(global_norm(_map(_t, t))), float(J.global_norm(_map(jnp.asarray, t))),
                               rtol=RTOL)


@pytest.mark.parametrize("name", ["constant", "warmup_cosine", "warmup_linear_decay"])
def test_schedules_match_the_reference_at_steps_0_to_300(name):
    make = {"constant": lambda m: m.constant(3e-4),
            "warmup_cosine": lambda m: m.warmup_cosine(3e-4, 37, 250, floor=0.2),
            "warmup_linear_decay": lambda m: m.warmup_linear_decay(3e-4, 37, 250)}[name]
    import repro_torch.optim as T

    tf, jf = make(T), make(J)
    for step in range(301):
        a = tf(torch.tensor(step, dtype=torch.int32))
        assert a.dtype == torch.float32 and a.shape == ()
        np.testing.assert_allclose(float(a), float(jf(jnp.asarray(step, jnp.int32))), rtol=RTOL, atol=1e-12)


def test_int8_codes_and_error_feedback_bit_for_bit():
    """quantize_int8's codes and scale, and compress_decompress's outputs
    and error-feedback state over 10 steps, equal the reference's bit for
    bit, including values that land on a half step (rounded to even)."""
    from repro.optim.compress import quantize_int8 as jq

    rng = np.random.default_rng(11)
    x = (rng.normal(size=257) * 3).astype(np.float32)
    x[:8] = np.array([127, -127, 63.5, -63.5, 0.5, 1.5, -2.5, 0], np.float32)  # absmax 127: halves exact
    for v in (x, x[8:], np.zeros(5, np.float32)):
        qt, st_ = quantize_int8(_t(v))
        qj, sj = jq(jnp.asarray(v))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert np.float32(st_) == np.float32(sj)
    p = _tree(rng)
    tef, jef = init_ef_state(_map(_t, p)), J.init_ef_state(_map(jnp.asarray, p))
    for _ in range(10):
        g = _map(lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32), p)
        td, tef = compress_decompress(_map(_t, g), tef)
        jd, jef = J.compress_decompress(_map(jnp.asarray, g), jef)
        for a, b in zip(_leaves(td) + _leaves(tef), _leaves(jd) + _leaves(jef)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
