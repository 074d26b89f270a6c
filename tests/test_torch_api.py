"""The port's retrieval API against the JAX package's (the twins of
``tests/test_api.py``): the query-handle lifecycle, ``save``/``load_query``,
``RestartQuery``'s restart protocol, and ``MultiIndexSession``, N indexes
under one shared byte budget, whose cache counters (hits, misses,
evictions, residency) follow the reference's step for step on the same
calls.  Indexes are the reference's builds; ``device="cpu"``."""
import numpy as np
import pytest

from repro.core import ECPBuildConfig as RefCfg
from repro.core import MultiIndexSession as RefSession
from repro.core import RestartQuery as RefRestart
from repro.core import build_index as ref_build
from repro.core import open_index as ref_open
from repro.data import clustered_vectors
from repro_torch.core import (
    ECPIndex,
    MultiIndexSession,
    QueryClosedError,
    ResultSet,
    RestartQuery,
    Searcher,
    open_index,
)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("api_idx")
    data, _ = clustered_vectors(3, n=6000, dim=32, n_clusters=48)
    path = str(root / "ecp")
    ref_build(data, path, RefCfg(levels=2, metric="l2", cluster_cap=64, seed=0))
    data2, _ = clustered_vectors(9, n=6000, dim=32, n_clusters=48)
    path2 = str(root / "ecp2")
    ref_build(data2, path2, RefCfg(levels=2, metric="l2", cluster_cap=64, seed=1))
    return data, path, data2, path2


def _same(a, b, msg=""):
    np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"{msg}: ids")
    np.testing.assert_array_equal(a.dists, b.dists, err_msg=f"{msg}: dists")


# ------------------------------------------------------------ protocol shape
@pytest.mark.parametrize("mode", ["file", "packed"])
def test_every_searcher_speaks_the_protocol(built, mode):
    data, path, _, _ = built
    s = open_index(path, mode=mode, device="cpu")
    assert isinstance(s, Searcher)
    rs = s.search(data[5], k=4, b=8)
    assert isinstance(rs, ResultSet) and rs.ids.shape == (4,) and rs.query is not None
    assert s.search(data[:3], k=4, b=8).ids.shape == (3, 4)


def test_open_index_auto_and_bad_mode(built):
    _, path, _, _ = built
    assert isinstance(open_index(path, mode="auto", device="cpu"), ECPIndex)
    with pytest.raises(ValueError):
        open_index(path, mode="nope", device="cpu")


# ------------------------------------------------------- handle lifecycle
def test_query_lifecycle_next_close_closed_error(built):
    data, path, _, _ = built
    rs = open_index(path, mode="file", device="cpu").search(data[10], k=8, b=4)
    more = rs.query.next(8)
    assert not (set(rs.row_ids(0)) & set(more.row_ids(0)))
    rs.query.close()
    assert rs.query.closed
    for call in (lambda: rs.query.next(8), lambda: rs.query.save()):
        with pytest.raises(QueryClosedError):
            call()
    rs.query.close()


def test_batched_query_has_no_persistent_form(built):
    data, path, _, _ = built
    rs = open_index(path, mode="packed", device="cpu").search(data[:4], k=5, b=16)
    with pytest.raises(NotImplementedError, match="no persistent form"):
        rs.query.save()


# ---------------------------------------------------------- persistence
def test_save_load_roundtrip_preserves_frontier(built):
    data, path, _, _ = built
    rs = open_index(path, mode="file", device="cpu").search(data[21], k=10, b=4)
    rs.query.next(10)
    token = rs.query.save(name="roundtrip")
    assert token == "roundtrip"
    resumed = open_index(path, mode="file", device="cpu").load_query(token)
    theirs = ref_open(path, mode="file").load_query(token)
    assert (resumed.state.b, resumed.state.emitted) == (rs.query.state.b, rs.query.state.emitted)
    a = rs.query.next(10)
    _same(a, resumed.next(10))
    _same(a, theirs.next(10))


def test_save_names_continue_the_reference_numbering(built):
    """Unnamed saves take the next free ``q_NNNNNN``, counting those the
    other package wrote into the same group."""
    data, path, _, _ = built
    group = "numbering"
    t0 = open_index(path, mode="file", device="cpu").search(data[:3], k=6, b=4).query.save(group=group)
    t1 = ref_open(path, mode="file").search(data[3], k=6, b=4).query.save(group=group)
    t2 = open_index(path, mode="file", device="cpu").search(data[4], k=6, b=4).query.save(group=group)
    assert (t0, t1, t2) == ("q_000000", "q_000001", "q_000002")
    resumed = open_index(path, mode="file", device="cpu").load_query(t0, group=group)
    assert resumed.batch_stats is not None and len(resumed.states) == 3
    _same(resumed.next(6), ref_open(path, mode="file").load_query(t0, group=group).next(6))


# --------------------------------------------------------- restart protocol
@pytest.mark.parametrize("mode", ["file", "packed"])
def test_restart_query_is_the_reference_restart(built, mode):
    """``RestartQuery.next(k)`` re-searches for ``emitted + k`` and returns
    the tail, padded with ``(inf, -1)`` once the searcher runs dry."""
    data, path, _, _ = built
    q = data[:2] if mode == "packed" else data[7]
    ours = RestartQuery(open_index(path, mode=mode, device="cpu"), q, 5, b=8)
    theirs = RefRestart(ref_open(path, mode=mode), q, 5, b=8)
    for k in (5, 7):
        a, b = ours.next(k), theirs.next(k)
        assert np.array_equal(a.ids, np.asarray(b.ids, np.int64))
        np.testing.assert_allclose(a.dists, np.asarray(b.dists), rtol=1e-5, atol=1e-6)
        assert a.query is ours
    ours.close()
    with pytest.raises(QueryClosedError):
        ours.next(3)


def test_restart_query_pads_past_the_end(built):
    data, path, _, _ = built
    idx = open_index(path, mode="file", device="cpu")
    rq = RestartQuery(idx, data[0], 4, b=1, opts={"mx_inc": 0})
    got = rq.next(2000)
    n_live = int((got.ids >= 0).sum())
    assert got.ids.shape == (2000,) and n_live < 2000
    assert (got.ids[n_live:] == -1).all() and np.isinf(got.dists[n_live:]).all()
    want = idx.search(data[0], 2004, b=1, mx_inc=0)
    np.testing.assert_array_equal(got.ids, want.ids[4:])


# ------------------------------------------------------- shared cache
def _session_run(session_cls, path, path2, data, data2, budget, open_kw):
    sess = session_cls(cache_bytes=budget)
    a = sess.open(path, name="a", **open_kw)
    b = sess.open(path2, name="b", **open_kw)
    assert a.cache is sess.cache and b.cache is sess.cache
    rng = np.random.default_rng(4)
    trace, results = [], []
    for _ in range(12):
        ra = a.search(data[rng.integers(0, len(data))], k=5, b=8)
        rb = b.search(data2[rng.integers(0, len(data2))], k=5, b=8)
        results += [ra, rb]
        assert sess.cache.resident_bytes <= budget
        trace.append(sess.stats())
    sess.resize(cache_bytes=budget // 4)
    trace.append(sess.stats())
    results += [a.search(data[42], k=1, b=8), sess.search("b", data2[7], k=1, b=8)]
    trace.append(sess.stats())
    sess.close()
    assert sess.cache.n_resident == 0
    return trace, results


def test_multi_index_session_follows_the_reference(built):
    data, path, data2, path2 = built
    budget = 200_000
    ours, rs_ours = _session_run(MultiIndexSession, path, path2, data, data2, budget, {"device": "cpu"})
    theirs, rs_theirs = _session_run(RefSession, path, path2, data, data2, budget, {})
    assert ours == theirs
    for a, b in zip(rs_ours, rs_theirs):
        _same(a, b)
    st = ours[11]
    assert st["evictions"] > 0 and set(st["per_index"]) == {"a", "b"} and st["resident_bytes"] <= budget
    assert ours[-1]["resident_bytes"] <= budget // 4
    assert rs_ours[-2].ids[0] == 42 and rs_ours[-1].ids[0] == 7
    # each index answers as it does opened alone
    alone = open_index(path, mode="file", device="cpu")
    rng = np.random.default_rng(4)
    for j in range(12):
        _same(rs_ours[2 * j], alone.search(data[rng.integers(0, len(data))], k=5, b=8), f"a#{j}")
        rng.integers(0, len(data2))


def test_session_name_collision_lookup_and_invalidate(built):
    data, path, _, _ = built
    sess = MultiIndexSession(cache_bytes=1 << 20)
    x = sess.open(path, name="x", device="cpu")
    assert "x" in sess and sess.names() == ["x"] and sess["x"] is x
    with pytest.raises(ValueError):
        sess.open(path, name="x", device="cpu")
    x.search(data[0], k=5, b=4)
    assert sess.stats()["per_index"]["x"]["nodes"] > 0
    assert sess.invalidate("x") == 0  # refresh() drops the namespace
    assert sess.stats()["per_index"]["x"]["nodes"] == 0
    # a packed index stays addressable without drawing on the budget
    p = sess.open(path, name="p", mode="packed", device="cpu")
    assert sess.search("p", data[:2], k=3, b=8).ids.shape == (2, 3) and not hasattr(p, "cache")
    with sess:
        pass
    assert sess.names() == []


def test_session_quantized_and_prefetch_indexes(built, tmp_path):
    """Indexes opened through a session may scan quantized and prefetch:
    the prefetched payloads land in the shared budget, results stay the
    index's own."""
    from repro.core import convert as ref_convert

    data, path, data2, path2 = built
    qblob = str(ref_convert(path, tmp_path / "a.qblob", quant="int8"))
    sess = MultiIndexSession(cache_bytes=300_000)
    a = sess.open(qblob, name="a", quantized=True, backend="blob+prefetch", device="cpu")
    b = sess.open(path2, name="b", backend="fstore+prefetch", device="cpu")
    Q = data[:6] + 0.01
    _same(a.search(Q, k=10, b=6), open_index(path, mode="file", device="cpu").search(Q, k=10, b=6))
    _same(b.search(data2[:6], k=10, b=6), open_index(path2, mode="file", device="cpu").search(data2[:6], k=10, b=6))
    a.store.drain()
    b.store.drain()
    assert a.store.io.prefetch_issued + b.store.io.prefetch_issued > 0
    assert sess.cache.resident_bytes <= 300_000
    sess.close()
