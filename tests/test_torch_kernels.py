"""The port's distance kernels on the CPU: the plain PyTorch versions (what
the wrappers run for CPU tensors) against the JAX package's oracles and its
Pallas kernels in interpret mode, on the cases of ``test_kernels.py``.

Distances agree within rtol/atol 1e-4 (1e-3 in the property case, as the
JAX tests hold their own kernel): the port's cosine normalizes with
``rsqrt(sum(x*x) + 1e-12)`` like the TPU kernels, the oracles with
``max(norm, 1e-12)``, and float32 sums are taken in another order.  Ids are
exact.  The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.quant import encode_node as ref_encode_node
from repro.core.quant import qdtype
from repro.kernels.distance_topk import (
    distance_topk_pallas,
    distance_topk_ref,
    grouped_distance_topk_pallas,
    grouped_distance_topk_ref,
)
from repro_torch.kernels import _build
from repro_torch.kernels.distance_topk import ops
from repro_torch.kernels.distance_topk import ref as tref

RNG = np.random.default_rng(0)


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


# ------------------------------------------------------------ distance_topk
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize(
    "B,N,D,k,bq,bn",
    [
        (4, 256, 64, 8, 64, 128),
        (130, 1000, 128, 16, 128, 128),   # non-divisible B and N
        (1, 64, 32, 64, 8, 64),           # k == N: the full-selection path
        (16, 512, 256, 32, 64, 256),
    ],
)
def test_distance_topk_matches_jax(metric, B, N, D, k, bq, bn):
    q = RNG.normal(size=(B, D)).astype(np.float32)
    c = RNG.normal(size=(N, D)).astype(np.float32)
    d, i = ops.distance_topk(torch.from_numpy(q), torch.from_numpy(c), k, metric)
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and d.shape == (B, k)
    d0, i0 = distance_topk_ref(jnp.asarray(q), jnp.asarray(c), k, metric)
    _close(d, d0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i0))
    d1, i1 = distance_topk_pallas(jnp.asarray(q), jnp.asarray(c), k, metric, bq=bq, bn=bn, interpret=True)
    _close(d, d1)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_distance_topk_dtypes(dtype):
    """Low-precision inputs widen to float32: the result is the float32
    oracle's on the rounded inputs."""
    q = torch.from_numpy(RNG.normal(size=(8, 64)).astype(np.float32)).to(dtype)
    c = torch.from_numpy(RNG.normal(size=(300, 64)).astype(np.float32)).to(dtype)
    d, i = ops.distance_topk(q, c, 10, "l2")
    d0, i0 = distance_topk_ref(jnp.asarray(q.float().numpy()), jnp.asarray(c.float().numpy()), 10, "l2")
    _close(d, d0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i0))


@settings(max_examples=15, deadline=None)
@given(
    B=st.integers(1, 17),
    N=st.integers(8, 300),
    D=st.integers(4, 96),
    metric=st.sampled_from(["l2", "ip"]),
    data=st.data(),
)
def test_distance_topk_property(B, N, D, metric, data):
    k = data.draw(st.integers(1, min(N, 32)))
    seed = data.draw(st.integers(0, 2**31))
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, D)).astype(np.float32)
    c = r.normal(size=(N, D)).astype(np.float32)
    d, i = ops.distance_topk(torch.from_numpy(q), torch.from_numpy(c), k, metric)
    d0, i0 = distance_topk_ref(jnp.asarray(q), jnp.asarray(c), k, metric)
    _close(d, d0, 1e-3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i0))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_distance_topk_pads_past_n_with_inf_minus_one(metric):
    """k > N: the first N entries are the full selection, the rest (inf, -1)
    (the TPU kernel leaves a stale id there; the port does not)."""
    q = RNG.normal(size=(3, 16)).astype(np.float32)
    c = RNG.normal(size=(20, 16)).astype(np.float32)
    d, i = ops.distance_topk(q, c, 32, metric)           # numpy in: CPU tensors
    d0, i0 = distance_topk_ref(jnp.asarray(q), jnp.asarray(c), 20, metric)
    _close(d[:, :20], d0)
    np.testing.assert_array_equal(i[:, :20].numpy(), np.asarray(i0))
    assert torch.isinf(d[:, 20:]).all() and (i[:, 20:] == -1).all()


def test_distance_topk_ties_go_to_the_lower_index():
    c = np.zeros((10, 4), np.float32)
    c[[2, 5, 7]] = 1.0                                   # three equal rows
    q = np.ones((1, 4), np.float32)
    d, i = ops.distance_topk(q, c, 10, "l2")
    assert i[0, :3].tolist() == [2, 5, 7]
    assert i[0, 3:].tolist() == [0, 1, 3, 4, 6, 8, 9]    # the zero rows, tied
    assert (torch.diff(d[0]) >= 0).all()


# -------------------------------------------------- grouped quantized top-k
def _make_groups(G, N, D, qformat, seed=0, short=False):
    r = np.random.default_rng(seed)
    codes = np.zeros((G, N, D), qdtype(qformat))
    scales = np.zeros(G, np.float32)
    offsets = np.zeros(G, np.float32)
    n_rows = r.integers(1, N + 1, size=G) if short else np.full(G, N)
    for g in range(G):
        emb = r.normal(size=(int(n_rows[g]), D)).astype(np.float32)
        qn = ref_encode_node(emb, qformat)
        codes[g, : qn.n_rows] = qn.codes
        scales[g], offsets[g] = qn.scale, qn.offset
    q = r.normal(size=(G, D)).astype(np.float32)
    return q, codes, scales, offsets, n_rows.astype(np.int32)


def _port_grouped(args, k, metric, qformat="int8"):
    return ops.grouped_distance_topk(*args, k, metric, qformat)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("qformat", ["int8", "float16"])
def test_grouped_topk_matches_jax(metric, qformat):
    args = _make_groups(7, 96, 24, qformat, seed=5)
    k = 16
    d, i = _port_grouped(args, k, metric, qformat)
    assert isinstance(d, np.ndarray) and d.dtype == np.float32 and i.dtype == np.int32
    d0, i0 = grouped_distance_topk_ref(*args, k, metric, qformat)
    _close(d, d0)
    np.testing.assert_array_equal(i, i0)
    d1, i1 = grouped_distance_topk_pallas(*args, k, metric, qformat, bn=32, interpret=True)
    _close(d, d1)
    np.testing.assert_array_equal(i, np.asarray(i1))


def test_grouped_topk_short_groups_pad_with_inf_minus_one():
    # ragged valid counts, k larger than some groups, N not a tile multiple
    args = _make_groups(9, 70, 16, "int8", seed=6, short=True)
    nr = args[4]
    d, i = _port_grouped(args, 48, "l2")
    d0, i0 = grouped_distance_topk_ref(*args, 48, "l2")
    _close(d, d0)
    np.testing.assert_array_equal(i, i0)
    d1, i1 = grouped_distance_topk_pallas(*args, 48, "l2", bn=32, interpret=True)
    np.testing.assert_array_equal(i, np.asarray(i1))
    for g in range(len(nr)):
        assert np.all(i[g, int(nr[g]) :] == -1)
        assert np.all(np.isinf(d[g, int(nr[g]) :]))


def test_grouped_topk_empty_and_zero_rows():
    d, i = _port_grouped(
        (
            np.zeros((0, 8), np.float32), np.zeros((0, 16, 8), np.int8),
            np.zeros(0, np.float32), np.zeros(0, np.float32), np.zeros(0, np.int32),
        ),
        4, "l2",
    )
    assert d.shape == (0, 4) and i.shape == (0, 4)
    q, codes, scales, offsets, nr = _make_groups(3, 32, 8, "int8", seed=7)
    nr = nr.copy()
    nr[1] = 0
    d, i = _port_grouped((q, codes, scales, offsets, nr), 8, "l2")
    assert np.all(i[1] == -1) and np.all(np.isinf(d[1]))
    d0, i0 = grouped_distance_topk_ref(q, codes, scales, offsets, nr, 8, "l2")
    np.testing.assert_array_equal(i, i0)
    _close(d, d0)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_grouped_topk_k_at_and_past_the_leaf_width(metric):
    """k = N (full selection of every group) and k > N (the quantized
    round's kop can exceed the padded width): (inf, -1) past each group."""
    args = _make_groups(5, 40, 12, "int8", seed=8, short=True)
    for k in (40, 64):
        d, i = _port_grouped(args, k, metric)
        d0, i0 = grouped_distance_topk_ref(*args, k, metric)
        _close(d, d0)
        np.testing.assert_array_equal(i, i0)
        assert (i[:, 40:] == -1).all() and np.isinf(d[:, 40:]).all()


# ------------------------------------------------------------------ wrappers
def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launches()
    q = RNG.normal(size=(2, 8)).astype(np.float32)
    c = RNG.normal(size=(30, 8)).astype(np.float32)
    d, i = ops.distance_topk(q, c, 5, "ip")
    d0, i0 = tref.distance_topk_ref(torch.from_numpy(q), torch.from_numpy(c), 5, "ip")
    assert torch.equal(d, d0) and torch.equal(i, i0)
    _port_grouped(_make_groups(2, 8, 8, "int8"), 4, "l2")
    assert ops.launches == {"distance_topk": 0, "grouped_distance_topk": 0}


def test_wrappers_reject_bad_arguments():
    q = np.zeros((2, 8), np.float32)
    with pytest.raises(ValueError, match="metric"):
        ops.distance_topk(q, q, 1, "hamming")
    with pytest.raises(ValueError, match="k must be"):
        ops.distance_topk(q, q, 0, "l2")
    with pytest.raises(ValueError, match="expects"):
        ops.distance_topk(q, np.zeros((3, 4), np.float32), 1, "l2")
    with pytest.raises(ValueError, match="quant format"):
        _port_grouped(_make_groups(2, 8, 8, "int8"), 4, "l2", "int4")


def test_kernel_build_is_lazy_and_keyed_by_source(tmp_path, monkeypatch):
    """Importing the wrappers compiles nothing; the library name follows
    the source hash, so an edited source gets a new library."""
    assert _build._libs == {}
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    t = _build._target("grouped_distance_topk")
    assert t.parent == tmp_path and t.name.startswith("grouped_distance_topk-") and t.suffix == ".so"
    assert t != _build._target("distance_topk")
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
