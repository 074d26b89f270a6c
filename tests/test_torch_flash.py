"""The port's flash attention on the CPU: the plain PyTorch version (what the
wrapper runs for CPU tensors, and what ``chip_smoke.py`` holds the Hopper
kernel against on the card) against the JAX package's Pallas kernel in
interpret mode, on the cases of ``test_kernels.py``.

Tolerances are the reference's own for its kernel against its oracle: 2e-5
in float32 (the two sum in another order), 2e-2 in bfloat16.  A row with
no live key is exactly 0 in both.  The CUDA kernel itself runs only on the
card (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention import mha_ref as jax_mha_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref, mha_ref, ops

CASES = [
    (2, 4, 2, 128, 128, 64, True, None),
    (2, 4, 4, 128, 128, 64, False, None),
    (1, 8, 2, 64, 256, 32, True, None),      # chunked prefill
    (2, 4, 2, 1, 192, 64, True, (100, 192)),  # ragged decode
    (2, 2, 1, 100, 100, 64, True, None),      # non-divisible seq
    (1, 2, 2, 256, 256, 128, True, None),     # d = 128
]


def _qkv(seed, B, Hq, Hkv, Sq, Skv, d):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(B, Hq, Sq, d)).astype(np.float32),
        rng.normal(size=(B, Hkv, Skv, d)).astype(np.float32),
        rng.normal(size=(B, Hkv, Skv, d)).astype(np.float32),
    )


def _jax_flash(q, k, v, lens, causal, dtype=jnp.float32, bq=64, bk=64):
    kv_lens = None if lens is None else jnp.asarray(lens, jnp.int32)
    return np.asarray(flash_attention_pallas(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        kv_lens=kv_lens, causal=causal, bq=bq, bk=bk, interpret=True,
    ))


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d,causal,lens", CASES)
def test_plain_version_matches_pallas(B, Hq, Hkv, Sq, Skv, d, causal, lens):
    q, k, v = _qkv(Sq + Skv + d, B, Hq, Hkv, Sq, Skv, d)
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    o = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        kv_lens=kv_lens, causal=causal)
    assert o.dtype == torch.float32 and o.shape == (B, Hq, Sq, d)
    np.testing.assert_allclose(o.numpy(), _jax_flash(q, k, v, lens, causal), rtol=2e-5, atol=2e-5)


def test_plain_version_bf16():
    q, k, v = _qkv(1, 1, 4, 2, 128, 128, 64)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    o = flash_attention(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(o.numpy(), _jax_flash(q, k, v, None, True, jnp.bfloat16),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_row_with_no_live_key_is_zero(causal):
    """kv_len = 0 for one batch row: the kernel's guards give 0 where the
    oracle gives NaN; the other row is unaffected."""
    q, k, v = _qkv(2, 2, 4, 2, 3, 96, 32)
    lens = (0, 70)
    o = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        kv_lens=torch.tensor(lens, dtype=torch.int32), causal=causal).numpy()
    j = _jax_flash(q, k, v, lens, causal)
    assert np.all(o[0] == 0.0) and np.all(j[0] == 0.0)
    np.testing.assert_allclose(o, j, rtol=2e-5, atol=2e-5)
    assert np.all(np.isnan(mha_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   kv_lens=torch.tensor(lens), causal=causal)[0].numpy()))


def test_extreme_logits_stay_finite():
    q = torch.full((1, 1, 64, 32), 30.0)
    k = torch.full((1, 1, 64, 32), 30.0)
    v = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 1, 64, 32)).astype(np.float32))
    o = flash_attention(q, k, v, causal=True)
    assert torch.isfinite(o).all()
    j = _jax_flash(q.numpy(), k.numpy(), v.numpy(), None, True, bq=32, bk=32)
    np.testing.assert_allclose(o.numpy(), j, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lens", [None, (5, 7)])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_ref_is_the_reference_oracle(lens, causal):
    q, k, v = _qkv(4, 2, 6, 3, 7, 9, 16)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    o = mha_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal, kv_lens=kv)
    j = jax_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                    kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("i0", [0, 37, 192])
def test_causal_row_block_equals_the_whole_call(i0):
    """chip_smoke.py holds rows [i0, i0 + n) of a long causal call against the
    plain version of those queries on the first i0 + n keys: the causal mask
    aligns the last query with the last key, so the two are the same rows."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 4, 2, 256, 256, 32))
    whole = flash_attention_ref(q, k, v, causal=True)
    e = i0 + 64
    block = flash_attention_ref(q[:, :, i0:e], k[:, :, :e], v[:, :, :e], causal=True)
    np.testing.assert_allclose(block.numpy(), whole[:, :, i0:e].numpy(), rtol=1e-6, atol=1e-6)


def test_planted_faults_match_the_kernel_source():
    """Each fault chip_smoke.py plants is one change at one place of a
    kernel's source; an edit of the source that moves it fails here."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    csrc = root / "src/repro_torch/csrc"
    flash = [f for f in smoke.FAULTS.values() if f[0].startswith("flash")]
    assert flash and all(f[0] == "flash_attention_wgmma" for f in flash)  # the kernel the prefill runs
    for library, changed, old, new in smoke.FAULTS.values():
        assert (csrc / f"{library}.cu").is_file()
        assert (csrc / changed).read_text().count(old) == 1 and old != new


def test_cpu_dispatch_takes_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4, 2, 40, 40, 16))
    ops.reset_launches()
    # a strided q (heads and sequence swapped in memory), as the model passes it
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    o = flash_attention(qs, k, v, causal=True, scale=0.3)
    assert torch.equal(o, flash_attention_ref(q, k, v, causal=True, scale=0.3))
    assert ops.launches == {"flash_attention": 0, "flash_attention_wgmma": 0}


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(q, k, v)
    q4 = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="kv_lens"):
        flash_attention(q4, k, v, kv_lens=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="expects"):
        flash_attention(q4[0], k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q4.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("dtype,d,kind", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "mma"), (torch.bfloat16, 16, "mma"), (torch.bfloat16, 112, "mma"),
    (torch.float32, 128, "fma"), (torch.float32, 32, "fma"),
])
def test_route_sends_bf16_at_d128_to_the_wgmma_kernel(dtype, d, kind):
    assert ops.route(dtype, d) == kind


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_tma_rule_takes_the_models_strided_views_without_a_copy():
    """q, k, v as the model hands them over: [B, S, H, d] projections viewed
    as [B, H, S, d], a sequence stride of H * d * 2 bytes."""
    for H in (24, 8):
        t = _bf16(2, 40, H, 128).transpose(1, 2)
        assert not t.is_contiguous() and ops.loadable(t)
        assert ops.as_loadable(t) is t
    c = _bf16(1, 4, 40, 128)
    assert ops.loadable(c) and ops.as_loadable(c) is c


@pytest.mark.parametrize("make", [
    lambda: _bf16(4 * 40 * 128 + 1)[1:].view(1, 4, 40, 128),        # base 2 bytes past 16-byte alignment
    lambda: _bf16(1, 4, 40, 132)[..., :128],                         # sequence stride 264 bytes
    lambda: _bf16(1, 4, 40, 128).transpose(2, 3),                    # last dimension not contiguous
    lambda: _bf16(1, 1, 40, 128).expand(1, 4, 40, 128),              # head stride 0
], ids=["base", "seq_stride", "last_dim", "broadcast"])
def test_tma_rule_copies_what_it_cannot_load(make):
    t = make()
    assert not ops.loadable(t)
    c = ops.as_loadable(t)
    assert c.is_contiguous() and ops.loadable(c) and torch.equal(c, t)


def test_tma_rule_ignores_strides_of_length_one_dimensions():
    """A stride of 3 elements (6 bytes) breaks TMA's rule, except on a
    dimension of length 1, whose stride is never used."""
    buf = _bf16(8 * 40 * 128)
    assert ops.loadable(buf.as_strided((1, 1, 40, 128), (40 * 128, 3, 128, 1)))   # one head
    assert not ops.loadable(buf.as_strided((1, 2, 40, 128), (40 * 128, 3, 128, 1)))
    assert ops.loadable(buf.as_strided((2, 4, 1, 128), (4 * 128, 128, 3, 1)))     # Sq = 1
    assert not ops.loadable(buf.as_strided((2, 4, 2, 128), (8 * 128, 256, 3, 1)))
    f32 = torch.zeros(1, 4, 40, 130)[..., :128]  # float32: the FMA kernel reads any row stride
    assert ops.loadable(f32)


def test_mma_yardstick_runs_only_on_the_card():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 2, 2, 8, 8, 128))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.flash_attention_mma(q, k, v)
