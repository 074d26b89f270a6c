"""The port's packed device search (``core/packed.py``, ``core/batched.py``)
against the JAX package's, on indexes the reference built: ``load_packed``
gives the reference's arrays, and ``BatchedSearcher(device="cpu")`` gives
the reference ``BatchedSearcher``'s ids exactly, its distances within
1e-5 relative (1e-6 absolute) and its ``leaves_opened``, through
``next(k)``; ``open_index``'s "auto" mode picks packed mode on a GPU."""
import functools

import numpy as np
import pytest
import torch

from repro.core import ECPBuildConfig as RefCfg
from repro.core import build_index as ref_build
from repro.core import open_store as ref_open_store
from repro.core.batched import BatchedSearcher as RefBatched
from repro.core.packed import load_packed as ref_load_packed
from repro_torch.core import ECPIndex, open_index
from repro_torch.core import api as port_api
from repro_torch.core import batched as port_batched
from repro_torch.core.batched import BatchedSearcher
from repro_torch.core.packed import load_packed
from repro_torch.kernels.leaf_distances import ops as leaf_distances_ops
from repro_torch.kernels.leaf_distances.ref import leaf_distances_ref

D, K = 16, 10
RTOL, ATOL = 1e-5, 1e-6


def _build(tmp, name, data, **cfg):
    path = str(tmp / name)
    ref_build(data, path, RefCfg(**cfg))
    return path


@pytest.fixture(scope="module", params=["l2", "ip", "cosine"])
def built(request, tmp_path_factory):
    metric = request.param
    tmp = tmp_path_factory.mktemp(f"packed_{metric}")
    rng = np.random.default_rng(5)
    data = rng.standard_normal((1200, D)).astype(np.float32)
    path = _build(tmp, "fs", data, levels=2, metric=metric, cluster_cap=40)
    Q = rng.standard_normal((6, D)).astype(np.float32)
    return metric, data, path, Q


def _close(ref_rs, rs):
    assert np.array_equal(np.asarray(ref_rs.ids, np.int64), rs.ids)
    np.testing.assert_allclose(rs.dists, np.asarray(ref_rs.dists), rtol=RTOL, atol=ATOL)
    ref_st = ref_rs.stats if isinstance(ref_rs.stats, list) else [ref_rs.stats]
    st = rs.stats if isinstance(rs.stats, list) else [rs.stats]
    assert [s.leaves_opened for s in st] == [s.leaves_opened for s in ref_st]


def test_load_packed_is_the_reference_arrays(built):
    _, _, path, _ = built
    ref = ref_load_packed(ref_open_store(path))
    ours = load_packed(path)
    assert ours.info.to_attrs() == ref.info.to_attrs()
    assert np.array_equal(ours.root_emb, ref.root_emb)
    assert len(ours.levels) == len(ref.levels)
    for a, b in zip(ours.levels, ref.levels):
        for f in ("emb", "ids", "mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("bi", ["below_root", "root"])
def test_batched_search_and_next_match_the_reference(built, bi):
    _, _, path, Q = built
    packed = load_packed(path)
    w = packed.info.nodes_per_level[0]
    b_internal = max(1, w // 2) if bi == "below_root" else w
    ref = RefBatched(ref_load_packed(ref_open_store(path)))
    ours = BatchedSearcher(packed, device="cpu")
    rr = ref.search(Q, K, b=3, b_internal=b_internal)
    rs = ours.search(Q, K, b=3, b_internal=b_internal)
    _close(rr, rs)
    for _ in range(2):
        _close(rr.query.next(K), rs.query.next(K))
    # a single query: [k] results, one SearchStats
    r1 = ref.search(Q[0], K, b=2, b_internal=b_internal)
    o1 = ours.search(Q[0], K, b=2, b_internal=b_internal)
    assert o1.ids.shape == (K,)
    _close(r1, o1)
    _close(r1.query.next(K), o1.query.next(K))


def test_a_cpu_searcher_captures_no_graphs_and_replays_nothing(built):
    """On the CPU every search of a shape runs eagerly, the third as the
    first: no graph is captured, no replay or capture is counted, and each
    search and its ``next`` give the reference's results."""
    from repro_torch import tracing

    _, _, path, Q = built
    ref = RefBatched(ref_load_packed(ref_open_store(path)))
    ours = BatchedSearcher(load_packed(path), device="cpu")
    tracing.reset()
    try:
        with tracing.on():
            for _ in range(3):
                rr, rs = ref.search(Q, K, b=2), ours.search(Q, K, b=2)
                _close(rr, rs)
                _close(rr.query.next(K), rs.query.next(K))
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.reset()
    assert ours._graphs == {} and ours._last is None
    assert "ecpfs.packed.graph_replays" not in counters and "ecpfs.packed.graph_captures" not in counters


def test_scan_in_leaf_blocks_is_the_same_function(built, monkeypatch):
    """A scan budget of a few leaves (many blocks a chunk) and the default
    (one block) give the same results."""
    _, _, path, Q = built
    packed = load_packed(path)
    bs = BatchedSearcher(packed, device="cpu")
    a = bs.search(Q, K, b=8)
    a_next = a.query.next(K)
    cap = packed.leaf.max_children
    monkeypatch.setattr(leaf_distances_ops, "leaf_distances_ref",
                        functools.partial(leaf_distances_ref, budget_bytes=3 * cap * (D + len(Q)) * 4))
    b = bs.search(Q, K, b=8)
    assert np.array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.dists, b.dists, rtol=RTOL, atol=ATOL)
    assert np.array_equal(a_next.ids, b.query.next(K).ids)


def test_ties_keep_index_order_on_repeated_rows(tmp_path):
    """Every vector stored four times under four ids: equal distances
    everywhere, which both packages order by position."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((150, D)).astype(np.float32)
    data = np.repeat(base, 4, axis=0)
    path = _build(tmp_path, "rep", data, levels=2, metric="l2", cluster_cap=40)
    Q = base[:5] + 0.5 * rng.standard_normal((5, D)).astype(np.float32)
    ref = RefBatched(ref_load_packed(ref_open_store(path))).search(Q, 24, b=4)
    ours = BatchedSearcher(load_packed(path), device="cpu").search(Q, 24, b=4)
    # the rows really tie: each id group of 4 holds one distance
    assert (np.diff(ours.dists.reshape(5, 6, 4), axis=-1) == 0).all()
    _close(ref, ours)
    _close(ref.query.next(24), ours.query.next(24))


def test_ties_near_zero_l2_keep_ids_and_bound_the_cancellation(tmp_path):
    """The tie test's twin with queries 0.01 from their rows.  Both
    packages compute l2 as |q|^2 + |c|^2 - 2 c.q in float32, so a distance
    near zero is a difference of terms of size |q|^2 and carries their
    rounding: each package's sum over D terms is off by at most
    D * eps * (|q| + |c|)^2, about 4 * D * eps * |q|^2 here (|c| ~ |q|),
    and the two by twice that.  The ids stay exact; a near-zero distance
    may differ by up to 8 * D * eps * |q|^2, every other one by RTOL."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((150, D)).astype(np.float32)
    data = np.repeat(base, 4, axis=0)
    path = _build(tmp_path, "rep", data, levels=2, metric="l2", cluster_cap=40)
    Q = base[:5] + 0.01 * rng.standard_normal((5, D)).astype(np.float32)
    ref = RefBatched(ref_load_packed(ref_open_store(path))).search(Q, 24, b=4)
    ours = BatchedSearcher(load_packed(path), device="cpu").search(Q, 24, b=4)
    assert (np.diff(ours.dists.reshape(5, 6, 4), axis=-1) == 0).all()
    assert np.array_equal(np.asarray(ref.ids, np.int64), ours.ids)
    assert (ours.ids[:, :4] // 4 == np.arange(5)[:, None]).all()  # each query's own row first
    eps = np.finfo(np.float32).eps
    cancel = 8 * D * eps * (Q.astype(np.float64) ** 2).sum(1, keepdims=True)
    rd = np.asarray(ref.dists, np.float64)
    assert (np.abs(rd[:, :4]) < 0.01).all()  # the near-zero distances under test
    assert (np.abs(ours.dists - rd) <= np.maximum(RTOL * np.abs(rd), cancel)).all()
    nxt_ref, nxt = ref.query.next(24), ours.query.next(24)
    assert np.array_equal(np.asarray(nxt_ref.ids, np.int64), nxt.ids)


def test_open_index_auto_on_a_gpu_refuses_a_tombstoned_index_as_the_reference(built, monkeypatch, tmp_path):
    """On a GPU, "auto" opens packed mode, which refuses tombstones: with
    the device reported as CUDA (and, for the reference, its backend as an
    accelerator) both packages raise the same ``ValueError``; file mode
    searches the same index."""
    import shutil

    import jax

    from repro.core import open_index as ref_open

    _, _, path, Q = built
    p = shutil.copytree(path, tmp_path / "tomb")
    open_index(p, mode="file", device="cpu").delete([0])
    monkeypatch.setattr(port_api, "resolve_device", lambda d="cuda": torch.device("cuda"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(ValueError, match="tombstoned") as ours:
        open_index(p)
    with pytest.raises(ValueError, match="tombstoned") as theirs:
        ref_open(p, mode="auto")
    assert str(ours.value) == str(theirs.value)
    rs = open_index(p, mode="file", device="cpu").search(Q, K, b=4)
    assert 0 not in rs.ids


def test_three_levels_match_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    data = rng.standard_normal((2000, D)).astype(np.float32)
    path = _build(tmp_path, "l3", data, levels=3, metric="l2", cluster_cap=12)
    Q = rng.standard_normal((4, D)).astype(np.float32)
    ref = RefBatched(ref_load_packed(ref_open_store(path))).search(Q, K, b=5, b_internal=6)
    ours = BatchedSearcher(load_packed(path), device="cpu").search(Q, K, b=5, b_internal=6)
    _close(ref, ours)
    _close(ref.query.next(K), ours.query.next(K))


def test_file_vs_batched_parity(built):
    """Same dataset, same queries: file mode and packed mode agree on k-NN."""
    _, data, path, _ = built
    idx = open_index(path, mode="file", device="cpu")
    bs = open_index(path, mode="packed", device="cpu")
    rng = np.random.default_rng(11)
    Q = data[rng.integers(0, len(data), 6)]
    w = idx.info.nodes_per_level[0]
    rsb = bs.search(Q, k=5, b=64, b_internal=w)
    for r in range(len(Q)):
        host = idx.search(Q[r], k=5, b=64)
        assert host.row_ids(0) == list(rsb.ids[r]), f"row {r}"


def test_batched_matches_host_on_first_k(built):
    _, data, path, _ = built
    packed = load_packed(path)
    bs = open_index(path, mode="packed", device="cpu")
    rng = np.random.default_rng(3)
    Q = data[rng.integers(0, len(data), 8)]
    rsb = bs.search(Q, k=5, b=64, b_internal=packed.info.nodes_per_level[0])
    idx = open_index(path, mode="file", device="cpu")
    for r in range(8):
        host = idx.search(Q[r], k=5, b=64)
        assert host.row_ids(0) == list(rsb.ids[r]), f"row {r}"


def test_open_index_auto_picks_packed_on_a_gpu(built, monkeypatch):
    _, _, path, _ = built
    # on the CPU: file mode
    assert isinstance(open_index(path, device="cpu"), ECPIndex)
    # the leaf scorer hook is file mode's alone
    with pytest.raises(TypeError, match="scorer"):
        open_index(path, mode="packed", scorer=lambda *a: None, device="cpu")
    # told the device is CUDA: packed mode, on that device
    made = {}

    class Stub:
        def __init__(self, packed, **kw):
            made.update(kw, packed=packed)

    monkeypatch.setattr(port_api, "resolve_device", lambda d="cuda": torch.device("cuda"))
    monkeypatch.setattr(port_batched, "BatchedSearcher", Stub)
    s = open_index(path)
    assert isinstance(s, Stub) and made["device"] == "cuda"
    assert made["packed"].info.nodes_per_level == load_packed(path).info.nodes_per_level
    # a file-mode-only option keeps file mode
    assert isinstance(open_index(path, cache_max_nodes=8, device="cpu"), ECPIndex)
    with pytest.raises(ValueError, match="only apply to mode='file'"):
        open_index(path, mode="packed", cache_max_nodes=8, device="cpu")


def test_load_packed_refuses_a_tombstoned_index(built):
    _, _, path, _ = built
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        p = shutil.copytree(path, td + "/copy")
        idx = open_index(p, mode="file", device="cpu")
        idx.delete([0])
        with pytest.raises(ValueError, match="tombstoned"):
            load_packed(p)
