"""The port's async prefetch store against the JAX package's, on index files
the reference wrote: the twins of the prefetch and throttle tests of
``tests/test_store.py``, the invariants of ``benchmarks/backends.py
--smoke``, and searches through ``"<name>+prefetch"`` backends that are
bit-identical to the reference's and to the port's own searches without
prefetch (fp and quantized, the quantized rounds' grouped kernel taking its
plain version on the CPU, ``device="cpu"``).

Prefetch counters depend on when background reads finish, so they are
compared only where the reference's tests make them deterministic:
``drain()``, an explicit warmup and threshold, sink delivery."""
import shutil
import time

import numpy as np
import pytest

from repro.core import AsyncPrefetchStore as RefPrefetchStore
from repro.core import ECPBuildConfig as RefCfg
from repro.core import build_index as ref_build
from repro.core import convert as ref_convert
from repro.core import open_index as ref_open
from repro.core import open_store as ref_open_store
from repro.data import clustered_vectors
from repro_torch.core import AsyncPrefetchStore, BlobStore, FStoreBackend, Store, open_index, open_store

DIM = 24


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    data, _ = clustered_vectors(5, n=5000, dim=DIM, n_clusters=40)
    root = tmp_path_factory.mktemp("prefetch")
    path = str(root / "ecp")
    ref_build(data, path, RefCfg(levels=2, metric="l2", cluster_cap=64, seed=2))
    blob = str(ref_convert(path, root / "idx.blob"))
    qblob = str(ref_convert(path, root / "idx.qblob", quant="int8"))
    return data, path, blob, qblob


def _wait(cond, what):
    # done-callbacks run just after drain()'s waiters wake
    for _ in range(400):
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(what)


def _same(a, b, msg=""):
    np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"{msg}: ids")
    np.testing.assert_array_equal(a.dists, b.dists, err_msg=f"{msg}: dists")


# ----------------------------------------------------------------- factory
@pytest.mark.parametrize("inner", ["fstore", "blob"])
def test_open_store_prefetch_spellings(built, inner):
    _, path, blob, _ = built
    src = path if inner == "fstore" else blob
    for ps in (open_store(src, backend=inner, prefetch=True), open_store(src, backend=f"{inner}+prefetch")):
        assert isinstance(ps, AsyncPrefetchStore) and isinstance(ps, Store)
        assert ps.backend == f"{inner}+prefetch" == ref_open_store(src, backend=f"{inner}+prefetch").backend
        assert isinstance(ps.inner, FStoreBackend if inner == "fstore" else BlobStore)
        # wrapping is idempotent
        assert open_store(ps, prefetch=True) is ps
        ps.close()


def test_prefetch_store_hits_and_close(built):
    _, _, blob, _ = built
    ps = open_store(blob, prefetch=True)
    keys = [(2, 0), (2, 1), (2, 2)]
    ps.prefetch(keys)
    direct = ref_open_store(blob)
    for key in keys:
        e, i = ps.get_node(*key)
        e1, i1 = direct.get_node(*key)
        np.testing.assert_array_equal(e, e1)
        np.testing.assert_array_equal(i, i1)
    assert ps.prefetch_issued == 3 and ps.prefetch_hits == 3
    assert (ps.io.prefetch_issued, ps.io.prefetch_hits) == (3, 3)
    ps.close()
    ps.prefetch([(2, 3)])  # no-op after close, must not raise
    assert ps.prefetch_issued == 3


def test_prefetch_on_node_sink_releases_futures(built):
    """With an on_node sink, completed prefetches flow to the caller and do
    NOT pin buffers in the store; the payloads are the reference's."""
    _, _, blob, _ = built
    ps = open_store(blob, prefetch=True)
    got = {}
    ps.prefetch([(2, j) for j in range(4)], on_node=lambda k, v: got.__setitem__(k, v))
    ps.drain()
    _wait(lambda: len(got) == 4 and not ps._futures, "sunk futures linger in flight")
    direct = ref_open_store(blob)
    for (lv, nd), (e, i) in got.items():
        e1, i1 = direct.get_node(lv, nd)
        np.testing.assert_array_equal(e, e1)
        np.testing.assert_array_equal(i, i1)
    ps.close()


@pytest.mark.parametrize("inner", ["fstore", "blob"])
def test_prefetch_drain_settles_io_as_the_reference(built, inner):
    """After ``drain()`` the background reads are counted, and they are the
    reference's reads of the same keys, byte for byte."""
    _, path, blob, _ = built
    src = path if inner == "fstore" else blob
    keys = [(2, j) for j in range(6)]
    io = []
    for make in (open_store, ref_open_store):
        ps = make(src, backend=inner, prefetch=True)
        ps.prefetch(keys)
        ps.drain()
        settled = ps.io.snapshot()
        assert ps.io.delta(settled).reads_issued == 0
        io.append(settled.as_dict())
        ps.close()
    assert io[0] == io[1] and io[0]["reads_issued"] >= 1


def test_prefetch_wrapper_invalidates_inflight_on_write(built, tmp_path):
    _, _, blob, _ = built
    dst = tmp_path / "m.blob"
    shutil.copyfile(blob, dst)
    s = BlobStore(dst)
    ps = AsyncPrefetchStore(s, workers=2)
    ps.prefetch([(2, 6)])
    ps.drain()
    e, i = s.get_node(2, 6)
    ps.append_rows(2, 6, np.zeros((1, s.dim), np.float16), np.array([90009]))
    e2, i2 = ps.get_node(2, 6)  # must NOT be the stale prefetched payload
    assert len(i2) == len(i) + 1 and 90009 in i2
    # the dropped payload was read for nothing
    assert ps.io.prefetch_wasted_bytes == e.nbytes + i.nbytes
    ps.close()


# ------------------------------------------------------- accuracy throttle
def _gate_script(ps):
    """The reference test's sequence; returns the counters after each step."""
    trace = [ps.hit_rate]
    ps.prefetch([(2, j) for j in range(8)])  # past warmup, zero consumed
    ps.drain()
    trace.append((ps.prefetch_issued, ps.hit_rate))
    ps.prefetch([(2, 8), (2, 9)])
    ps.prefetch([(2, 10), (2, 11)])
    trace.append((ps.prefetch_issued, ps.prefetch_suppressed))
    ps.prefetch([(2, 12), (2, 13), (2, 14)])  # the probe: one key admitted
    ps.drain()
    trace.append((ps.prefetch_issued, ps.prefetch_suppressed, (2, 12) in ps._futures,
                  (2, 13) in ps._futures))
    for key in [(2, j) for j in range(8)] + [(2, 12)]:
        ps.get_node(*key)
    trace.append((ps.prefetch_hits, ps.hit_rate))
    ps.prefetch([(2, 15), (2, 16)])
    trace.append(ps.prefetch_issued)
    ps.close()
    return trace


def test_prefetch_throttle_gate_lifecycle_matches_the_reference(built):
    """Unconsumed prefetches close the accuracy gate, a probe trickle keeps
    measuring, consuming the backlog reopens it: step for step the
    reference's counters."""
    _, _, blob, _ = built
    kw = dict(warmup=4, hit_rate_threshold=0.75, probe_every=3)
    ours = _gate_script(AsyncPrefetchStore(open_store(blob, backend="blob"), **kw))
    theirs = _gate_script(RefPrefetchStore(ref_open_store(blob, backend="blob"), **kw))
    assert ours == theirs
    assert ours == [1.0, (8, 0.0), (8, 4), (9, 6, True, False), (9, 1.0), 11]


def test_prefetch_throttle_byte_cap(built):
    _, _, blob, _ = built
    ps = AsyncPrefetchStore(open_store(blob, backend="blob"), max_inflight_bytes=1)
    ps.prefetch([(2, j) for j in range(5)])
    assert ps.prefetch_issued == 0 and ps.prefetch_suppressed == 5
    e, i = ps.get_node(2, 0)
    e1, i1 = ref_open_store(blob, backend="blob").get_node(2, 0)
    np.testing.assert_array_equal(e, e1)
    np.testing.assert_array_equal(i, i1)
    ps.close()


def test_prefetch_sink_delivery_not_double_counted(built):
    """Whoever pops the future owns (and counts) it exactly once."""
    _, _, blob, _ = built
    ps = open_store(blob, prefetch=True)
    got = {}
    ps.prefetch([(2, 4)], on_node=lambda k, v: got.__setitem__(k, v))
    ps.drain()
    _wait(lambda: got and not ps._futures, "sink never delivered")
    io0 = ps.io.snapshot()
    e, _ = ps.get_node(2, 4)  # demand read AFTER delivery: plain inner read
    assert ps.prefetch_hits == 0 and ps.io.delta(io0).prefetch_hits == 0
    np.testing.assert_array_equal(e, got[(2, 4)][0])
    ps.close()
    assert ps.io.prefetch_wasted_bytes == 0


def test_prefetch_throttle_engages_on_a_tight_cache(built):
    """``benchmarks/backends.py --smoke``'s comparison scenario (a tight
    cache budget, cold and warm pass): the gate closes, suppressing most
    speculation, and the results stay the plain blob's."""
    data, _, blob, _ = built
    rng = np.random.default_rng(7)
    qs = data[rng.integers(0, len(data), 48)]
    k, b = 50, 12
    cache_bytes = 32 * k * DIM * 4
    plain = open_index(blob, mode="file", backend="blob", cache_max_bytes=cache_bytes, device="cpu")
    with open_index(blob, mode="file", backend="blob+prefetch", cache_max_bytes=cache_bytes,
                    device="cpu") as idx:
        for _ in range(2):
            for q in qs:
                _same(idx.search(q, k, b=b), plain.search(q, k, b=b))
        issued, suppressed = idx.store.io.prefetch_issued, idx.store.prefetch_suppressed
    assert 0 < issued < suppressed, (issued, suppressed)
    plain.close()


# ------------------------------------------------------ searches under prefetch
@pytest.mark.parametrize("backend", ["fstore+prefetch", "blob+prefetch"])
def test_searches_with_prefetch_match_the_reference_and_no_prefetch(built, backend):
    data, path, blob, qblob = built
    src = path if backend.startswith("fstore") else blob
    rng = np.random.default_rng(2)
    Q = (data[rng.integers(0, len(data), 12)] + 0.01 * rng.normal(size=(12, DIM))).astype(np.float32)
    ours = open_index(src, mode="file", backend=backend, device="cpu")
    plain = open_index(src, mode="file", backend=backend.split("+")[0], device="cpu")
    theirs = ref_open(src, mode="file", backend=backend)
    for q in Q[:6]:
        a = ours.search(q, k=10, b=8)
        _same(a, theirs.search(q, k=10, b=8), "single vs reference")
        _same(a, plain.search(q, k=10, b=8), "single vs no prefetch")
    rb = ours.search(Q, k=20, b=4)
    _same(rb, theirs.search(Q, k=20, b=4), "batch vs reference")
    _same(rb, plain.search(Q, k=20, b=4), "batch vs no prefetch")
    _same(rb.query.next(20), plain.search(Q, k=20, b=4).query.next(20), "next")
    ours.store.drain()
    assert ours.store.io.prefetch_issued > 0
    # quantized rounds hint the prefetch too, and stay bit-identical; next
    # at a rerank depth that covers every emission (past it, an l2 next(k)
    # follows which leaves the cache holds in full, which prefetching
    # changes: ROADMAP Queue 3, in both packages)
    qsrc = path if backend.startswith("fstore") else qblob
    qi = open_index(qsrc, mode="file", backend=backend, quantized=True, rerank_depth=40,
                    device="cpu")
    rq = qi.search(Q, k=20, b=4)
    _same(rq, rb, "quantized batch")
    _same(rq.query.next(20), plain.search(Q, k=20, b=4).query.next(20), "quantized next")
    qi.store.drain()
    assert qi.store.io.prefetch_issued > 0
    qi.flush_prefetch_stats()
    assert not qi._pf_pending
    for idx in (ours, plain, theirs, qi):
        idx.close()


def test_snapshot_over_a_prefetch_store_keeps_its_generation(built, tmp_path):
    """A snapshot of a blob+prefetch index never prefetches, and stays
    bit-identical to its generation while the live index (which does
    prefetch) inserts into the leaves the snapshot reads."""
    data, _, blob, _ = built
    dst = str(tmp_path / "live.blob")
    shutil.copyfile(blob, dst)
    live = open_index(dst, mode="file", backend="blob+prefetch", device="cpu")
    rng = np.random.default_rng(3)
    Q = (data[rng.integers(0, len(data), 8)] + 0.01 * rng.normal(size=(8, DIM))).astype(np.float32)
    before = live.search(Q, k=20, b=6)
    snap = live.snapshot()
    assert snap._store_prefetch is None
    live.insert(Q + 0.001, np.arange(90000, 90008))
    live.search(Q, k=20, b=6)  # the live index prefetches the rewritten nodes
    _same(snap.search(Q, k=20, b=6), before, "snapshot after insert")
    got = live.search(Q, k=1, b=6)
    assert (got.ids[:, 0] >= 90000).all()
    snap.close()
    live.close()


def test_save_requires_fstore_backend(built):
    data, path, blob, _ = built
    bidx = open_index(blob, mode="file", backend="blob+prefetch", device="cpu")
    rs = bidx.search(data[1], k=5, b=8)
    with pytest.raises(NotImplementedError, match="fstore"):
        rs.query.save()
    with pytest.raises(NotImplementedError, match="fstore"):
        bidx.load_query("q_000000")
    bidx.close()


def test_prefetch_pool_reused_and_levels_loaded(built):
    _, path, _, _ = built
    idx = open_index(path, mode="file", device="cpu")
    idx.prefetch(up_to_level=1)
    pool1 = idx._pool
    n1 = idx.info.nodes_per_level[0]
    assert idx.load_node_count == n1
    idx.prefetch(up_to_level=1)
    assert idx._pool is pool1 and idx.load_node_count == n1  # cached, one pool
    idx.close()
    assert idx._pool is None
    idx.close()  # idempotent
