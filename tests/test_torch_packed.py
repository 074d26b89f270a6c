"""The port's packed device search (``core/packed.py``, ``core/batched.py``)
against the JAX package's, on indexes the reference built: ``load_packed``
gives the reference's arrays, and ``BatchedSearcher(device="cpu")`` gives
the reference ``BatchedSearcher``'s ids exactly, its distances within
1e-5 relative (1e-6 absolute) and its ``leaves_opened``, through
``next(k)``; ``open_index``'s "auto" mode picks packed mode on a GPU."""
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


def test_scan_in_leaf_blocks_is_the_same_function(built):
    """A scan budget of a few leaves (many blocks a chunk) and the default
    (one block) give the same results."""
    _, _, path, Q = built
    packed = load_packed(path)
    one = BatchedSearcher(packed, device="cpu")
    few = BatchedSearcher(packed, device="cpu")
    cap = packed.leaf.max_children
    few.scan_budget_bytes = 3 * cap * (D + len(Q)) * 4
    a, b = one.search(Q, K, b=8), few.search(Q, K, b=8)
    assert np.array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.dists, b.dists, rtol=RTOL, atol=ATOL)
    assert np.array_equal(a.query.next(K).ids, b.query.next(K).ids)


def test_scorer_hook_is_called_with_the_reference_shapes(built):
    metric, _, path, Q = built
    packed = load_packed(path)
    seen = []

    def scorer(q, c):
        seen.append((tuple(q.shape), tuple(c.shape)))
        return torch.stack([_dist_rows(q[i], c[i], metric) for i in range(len(q))])

    plain = BatchedSearcher(packed, device="cpu").search(Q, K, b=4)
    hooked = BatchedSearcher(packed, device="cpu", scorer=scorer).search(Q, K, b=4)
    cap = packed.leaf.max_children
    assert seen and all(s == ((len(Q), D), (len(Q), 4 * cap, D)) for s in seen)
    assert np.array_equal(plain.ids, hooked.ids)
    np.testing.assert_allclose(plain.dists, hooked.dists, rtol=RTOL, atol=ATOL)


def _dist_rows(q, c, metric):
    if metric == "ip":
        return -(c @ q)
    if metric == "l2":
        return (q * q).sum() + (c * c).sum(-1) - 2.0 * (c @ q)
    qn = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
    cn = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-12)
    return 1.0 - cn @ qn


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
