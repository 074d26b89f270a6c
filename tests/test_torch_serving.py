"""The port's serving path on the CPU: blob generation pinning and
copy-on-write (``BlobStore.pin`` / ``BlobSnapshot``), ``ECPSnapshot``
parity under writes, the reader/writer stress, the scheduler's
backpressure, deadlines and RW lock, the ``Server`` modes, session cap and
TTL, the latency ring — twins of the JAX package's ``tests/test_serving.py``
— plus concurrent quantized searches of one snapshot (each bit-identical
to the same search alone, no staging buffer shared) and the port's serve
demo run to its end."""
import shutil
import sys
import threading
import time

import numpy as np
import pytest

from repro.core import open_index as ref_open
from repro_torch.core import (
    BlobSnapshot,
    BlobStore,
    ECPBuildConfig,
    ECPSnapshot,
    QueryClosedError,
    build_index,
    convert,
    layout,
    open_index,
)
from repro_torch.data.synthetic import clustered_vectors
from repro_torch.launch import serve as port_serve
from repro_torch.launch.scheduler import (
    DeadlinePolicy,
    RequestScheduler,
    ServerOverloadedError,
    SnapshotManager,
)
from repro_torch.launch.serve import LatencyRing, Server, ServeStats

DIM = 24


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    data, _ = clustered_vectors(11, n=6000, dim=DIM, n_clusters=48)
    path = tmp_path_factory.mktemp("serve_idx") / "ecp"
    build_index(data, str(path), ECPBuildConfig(levels=2, metric="l2", cluster_cap=80, seed=4),
                device="cpu")
    bdir = tmp_path_factory.mktemp("serve_blob")
    blob = convert(str(path), bdir / "idx.blob")
    qblob = convert(str(path), bdir / "q.blob", quant="int8")
    return data, str(path), str(blob), str(qblob)


def _fresh(src: str, tmp_path, name="idx.blob") -> str:
    dst = tmp_path / name
    shutil.copy(src, dst)
    return str(dst)


def _fresh_blob(built, tmp_path):
    return _fresh(built[2], tmp_path)


def _open(path, **kw):
    return open_index(path, mode="file", device="cpu", **kw)


# ------------------------------------------------------------ BlobStore MVCC
def test_blob_pin_snapshot_reads_survive_overwrite(built, tmp_path):
    bs = BlobStore(_fresh_blob(built, tmp_path))
    emb0, ids0 = bs.get_node(1, 0)
    snap = bs.pin()
    assert isinstance(snap, BlobSnapshot) and snap.backend == "blob+snapshot"
    # doubling is exact in the blob's f16 storage dtype
    bs.write_node(1, 0, emb0 * 2.0, ids0 + 1000)
    e_live, i_live = bs.get_node(1, 0)
    e_snap, i_snap = snap.get_node(1, 0)
    np.testing.assert_array_equal(e_snap, emb0)
    np.testing.assert_array_equal(i_snap, ids0)
    np.testing.assert_array_equal(e_live, emb0 * 2.0)
    np.testing.assert_array_equal(i_live, ids0 + 1000)
    snap.close()
    bs.close()


def test_blob_snapshot_is_read_only_and_idempotent_close(built, tmp_path):
    bs = BlobStore(_fresh_blob(built, tmp_path))
    snap = bs.pin()
    with pytest.raises(PermissionError):
        snap.write_node(1, 0, np.zeros((1, DIM), np.float32), np.zeros(1, np.int64))
    with pytest.raises(PermissionError):
        snap.write_attrs(layout.INFO, {})
    with pytest.raises(PermissionError):
        snap.free_slot(1, 0)
    assert not snap.closed
    snap.close()
    snap.close()  # idempotent
    assert snap.closed
    bs.close()


def test_blob_retired_slots_recycle_after_release(built, tmp_path):
    """Copy-on-write under a pin moves the v3 quant block with the
    full-precision one, and the old slot recycles after the last pin."""
    bs = BlobStore(_fresh(built[3], tmp_path))
    emb, ids = bs.get_node(2, 0)
    q0 = bs.get_quantized(2, 0)
    snap = bs.pin()
    bs.write_node(2, 0, emb + 1, ids)  # COW -> old slot retired, not freed
    assert bs._retired, "overwrite under a pin must retire the old slot"
    pinned, live = snap.get_quantized(2, 0), bs.get_quantized(2, 0)
    np.testing.assert_array_equal(pinned.codes, q0.codes)   # the pin reads the old companion
    assert (pinned.scale, pinned.offset) == (q0.scale, q0.offset)
    assert live.offset != q0.offset                          # the live one was re-encoded
    snap.close()
    assert not bs._retired, "releasing the last pin recycles retired slots"
    bs.close()


def test_blob_free_slot_retires_while_pinned(built, tmp_path):
    bs = BlobStore(_fresh_blob(built, tmp_path))
    snap = bs.pin()
    emb, ids = snap.get_node(1, 1)
    bs.free_slot(1, 1)
    e2, i2 = snap.get_node(1, 1)
    np.testing.assert_array_equal(e2, emb)
    np.testing.assert_array_equal(i2, ids)
    snap.close()
    bs.close()


def test_blob_snapshot_survives_compact_replace(built, tmp_path):
    """os.replace of the blob file must not invalidate a pinned snapshot
    (it holds its own dup'd fd)."""
    idx = _open(_fresh_blob(built, tmp_path), backend="blob")
    emb, ids = idx.store.get_node(1, 0)
    snap_store = idx.store.pin()
    idx.insert(np.random.default_rng(0).normal(size=(32, DIM)).astype(np.float32))
    idx.compact()  # rewrites the file via os.replace
    e2, i2 = snap_store.get_node(1, 0)
    np.testing.assert_array_equal(e2, emb)
    np.testing.assert_array_equal(i2, ids)
    snap_store.close()
    idx.close()


# ------------------------------------------------------------- ECPSnapshot
def test_ecp_snapshot_bit_identical_under_mutation(built, tmp_path):
    data = built[0]
    idx = _open(_fresh_blob(built, tmp_path), backend="blob")
    rng = np.random.default_rng(2)
    qs = data[rng.integers(0, len(data), 12)]
    snap = idx.snapshot()
    assert isinstance(snap, ECPSnapshot)
    before = [snap.search(q, k=20, b=8) for q in qs]
    base = int(idx.info.next_id)
    idx.insert(
        data[:200] + 0.01 * rng.normal(size=(200, DIM)).astype(np.float32),
        np.arange(base, base + 200),
    )
    idx.delete(np.arange(0, 300, 5))
    idx.compact()
    after = [snap.search(q, k=20, b=8) for q in qs]
    for rs0, rs1 in zip(before, after):
        np.testing.assert_array_equal(rs0.ids, rs1.ids)
        np.testing.assert_array_equal(rs0.dists, rs1.dists)
    assert not set(idx.search(qs[0], k=20, b=8).row_ids(0)) & set(range(0, 300, 5))
    snap.close()
    idx.close()


def test_ecp_snapshot_continuation_survives_compact(built, tmp_path):
    data = built[0]
    idx = _open(_fresh_blob(built, tmp_path), backend="blob")
    snap = idx.snapshot()
    rs = snap.search(data[0], k=10, b=4)
    idx.compact()  # live queries would now raise StaleQueryError
    more = rs.query.next(10)
    assert more.ids.shape[-1] == 10
    rs.query.close()
    snap.close()
    idx.close()


def test_ecp_snapshot_refuses_writes(built, tmp_path):
    idx = _open(_fresh_blob(built, tmp_path), backend="blob")
    snap = idx.snapshot()
    for call in (lambda: snap.insert(np.zeros((1, DIM), np.float32)),
                 lambda: snap.delete([0]), snap.compact, snap.refresh):
        with pytest.raises(PermissionError):
            call()
    snap.close()
    idx.close()


def test_ecp_snapshot_unsupported_on_fstore(built):
    idx = _open(built[1], backend="fstore")
    assert not idx.supports_snapshot
    with pytest.raises(NotImplementedError):
        idx.snapshot()
    idx.close()


def test_snapshot_of_the_port_is_the_reference_search(built, tmp_path):
    """A snapshot taken after a port insert answers like the reference
    opening the same file."""
    data = built[0]
    path = _fresh_blob(built, tmp_path)
    idx = _open(path, backend="blob")
    base = int(idx.info.next_id)
    idx.insert(data[:40] + 0.02, np.arange(base, base + 40))
    snap = idx.snapshot()
    with ref_open(path, mode="file", backend="blob") as ref:
        for q in data[:5] + 0.02:
            a, b = snap.search(q, k=10, b=6), ref.search(q, k=10, b=6)
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.dists, b.dists)
    snap.close()
    idx.close()


# ------------------------------------------- concurrent reader/writer stress
def test_concurrent_readers_one_writer_stress(built, tmp_path):
    """Reader threads search pinned snapshots while a writer inserts,
    deletes, and compacts: every search returns k valid rows, no
    StaleQueryError, and a snapshot re-query is bit-identical."""
    data = built[0]
    idx = _open(_fresh_blob(built, tmp_path), backend="blob")
    mgr = SnapshotManager(idx)
    rng = np.random.default_rng(5)
    qs = data[rng.integers(0, len(data), 8)]
    errors: list = []
    stop = threading.Event()

    def reader(tid):
        r = np.random.default_rng(tid)
        try:
            while not stop.is_set():
                lease = mgr.lease()
                try:
                    q = qs[r.integers(0, len(qs))]
                    rs1 = lease.search(q, k=10, b=6)
                    rs2 = lease.search(q, k=10, b=6)
                    np.testing.assert_array_equal(rs1.ids, rs2.ids)
                    np.testing.assert_array_equal(rs1.dists, rs2.dists)
                    assert rs1.ids.shape[-1] == 10
                finally:
                    lease.release()
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    def writer():
        r = np.random.default_rng(77)
        try:
            for i in range(6):
                base = int(idx.info.next_id)
                idx.insert(r.normal(size=(48, DIM)).astype(np.float32), np.arange(base, base + 48))
                mgr.refresh()
                if i == 2:
                    idx.delete(np.arange(0, 120, 7))
                    mgr.refresh()
                if i == 4:
                    idx.compact()
                    mgr.refresh()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    readers = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
    wt = threading.Thread(target=writer)
    for t in readers:
        t.start()
    wt.start()
    wt.join(timeout=120)
    stop.set()
    for t in readers:
        t.join(timeout=60)
    assert not wt.is_alive() and not any(t.is_alive() for t in readers)
    mgr.close()
    idx.close()
    assert not errors, errors


def test_four_threads_of_quantized_searches_on_one_snapshot(built, tmp_path):
    """4 threads search one quantized snapshot at once: each result is
    bit-identical to the same search run alone, the staging pool holds at
    most one buffer a thread, and no update of quant_times is lost.  The
    threads start from a cold cache (an index of their own), so every
    leaf goes through the quantized rounds.  The rerank depth covers
    search + next(k) (2k): below it an l2 next(k) may depart from the fp
    engines, in both packages (ROADMAP Queue 3), and which leaves a warm
    cache sends to the fp scan would decide how."""
    data = built[0]
    path = _fresh(built[3], tmp_path)
    rng = np.random.default_rng(13)
    qs = data[rng.integers(0, len(data), 32)] + 0.01
    alone = []
    for q in qs:  # each search alone, on a cold index of its own
        solo = _open(path, backend="blob", quantized=True, rerank_depth=40)
        rs = solo.search(q, k=20, b=6)
        alone.append((rs, rs.query.next(20)))
        solo.close()
    idx = _open(path, backend="blob", quantized=True, rerank_depth=40)
    snap = idx.snapshot()
    got: dict = {}
    errors: list = []

    def worker(tid):
        try:
            for i in range(tid, len(qs), 4):
                rs = snap.search(qs[i], k=20, b=6)
                got[i] = (rs, rs.query.next(20))
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    # every round a thread ran is counted once (a search's stats carry its
    # own launches, one a round)
    launched = sum(got[i][0].stats.kernel_launches for i in range(len(qs)))
    assert launched > 0 and idx.quant_times["rounds"] == launched
    assert 1 <= len(idx._stages._free) <= 4  # at most one buffer a thread
    for i, (a, a_next) in enumerate(alone):
        b, b_next = got[i]
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
        np.testing.assert_array_equal(a_next.ids, b_next.ids)
        np.testing.assert_array_equal(a_next.dists, b_next.dists)
    snap.close()
    idx.close()


def test_four_threads_of_quantized_searches_on_one_snapshot_at_the_default_rerank_depth(built, tmp_path):
    """The twin of the test above at the default rerank depth, on a snapshot
    whose shared cache other searches have warmed: every thread's search is
    bit-identical to the same search alone on a cold index.  Its ``next(k)``
    is not compared: past the rerank depth a quantized l2 continuation
    depends on which leaves the cache holds (the known fault of ROADMAP
    Queue 3, shared with the reference; the test below pins it down)."""
    data = built[0]
    path = _fresh(built[3], tmp_path)
    rng = np.random.default_rng(17)
    qs = data[rng.integers(0, len(data), 32)] + 0.01
    alone = []
    for q in qs:
        solo = _open(path, backend="blob", quantized=True)
        alone.append(solo.search(q, k=20, b=6))
        solo.close()
    idx = _open(path, backend="blob", quantized=True)
    for q in qs[::2]:  # warm the shared cache: some leaves now scan in full precision
        idx.search(q, k=20, b=6).query.next(20)
    snap = idx.snapshot()
    got: dict = {}
    errors: list = []

    def worker(tid):
        try:
            for i in range(tid, len(qs), 4):
                rs = snap.search(qs[i], k=20, b=6)
                rs.query.next(20)
                got[i] = rs
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert 1 <= len(idx._stages._free) <= 4
    for i, a in enumerate(alone):
        np.testing.assert_array_equal(a.ids, got[i].ids)
        np.testing.assert_array_equal(a.dists, got[i].dists)
    snap.close()
    idx.close()


def test_quantized_l2_next_past_the_rerank_depth_follows_cache_warmth_as_in_the_reference(built, tmp_path):
    """The known fault of ROADMAP Queue 3, pinned down: at the default rerank
    depth a quantized l2 ``next(k)`` prunes its leaves at the search's depth,
    unless the shared cache holds a leaf in full precision, which is then
    scanned whole.  So a continuation on a cold index differs from the same
    one on an index that other searches warmed, while both searches' first
    ``k`` agree.  The port does exactly what the reference does in each
    state.  When the fault is repaired, cold and warm become equal and this
    test turns into that identity check."""
    data = built[0]
    path = _fresh(built[3], tmp_path)
    rng = np.random.default_rng(13)
    qs = data[rng.integers(0, len(data), 8)] + 0.01

    def cold(open_fn):
        out = []
        for q in qs:
            ix = open_fn()
            rs = ix.search(q, k=20, b=6)
            out.append((rs, rs.query.next(20)))
            ix.close()
        return out

    def warm(open_fn):
        ix = open_fn()
        for q in qs:
            ix.search(q, k=20, b=6).query.next(20)
        out = []
        for q in qs:
            rs = ix.search(q, k=20, b=6)
            out.append((rs, rs.query.next(20)))
        ix.close()
        return out

    port = lambda: _open(path, backend="blob", quantized=True)
    ref = lambda: ref_open(path, mode="file", quantized=True)
    pc, pw, rc, rw = cold(port), warm(port), cold(ref), warm(ref)
    same = lambda a, b: np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)
    for i in range(len(qs)):
        assert same(pc[i][0], pw[i][0]), f"query {i}: the first k depend on the cache"
        for state, p, r in (("cold", pc, rc), ("warm", pw, rw)):
            np.testing.assert_array_equal(p[i][0].ids, np.asarray(r[i][0].ids))
            np.testing.assert_array_equal(p[i][1].ids, np.asarray(r[i][1].ids), err_msg=f"{state} next, query {i}")
            np.testing.assert_array_equal(p[i][1].dists, np.asarray(r[i][1].dists))
    assert sum(not same(pc[i][1], pw[i][1]) for i in range(len(qs))) > 0, (
        "cold and warm continuations agree: the fault of ROADMAP Queue 3 is gone, make this the identity check")


def test_stage_pool_hands_each_holder_its_own_buffer():
    import torch

    from repro_torch.core.search import _StagePool

    pool = _StagePool(torch.device("cpu"))
    with pool.stage() as a, pool.stage() as b:
        assert a is not b
    assert len(pool._free) == 2
    with pool.stage() as c:
        assert c in (a, b)  # returned buffers are reused


# ---------------------------------------------------------------- scheduler
class _StubRS:
    def __init__(self, k):
        self.ids = np.zeros(k, np.int64)
        self.dists = np.zeros(k, np.float32)
        self.query = type("Q", (), {"close": lambda s: None, "next": lambda s, k: None})()


class _SlowSearcher:
    def __init__(self, delay_s=0.05):
        self.delay_s = delay_s
        self.bs: list = []

    def search(self, q, k, b=None, **opts):
        self.bs.append(b)
        time.sleep(self.delay_s)
        return _StubRS(k)


def test_scheduler_backpressure_rejects_when_full():
    sched = RequestScheduler(_SlowSearcher(0.05), workers=1, queue_depth=1)
    futs, rejected = [], 0
    for _ in range(12):
        try:
            futs.append(sched.submit(np.zeros(4), 5))
        except ServerOverloadedError:
            rejected += 1
    assert rejected > 0
    for f in futs:
        f.result(timeout=60)
    st = sched.stats.as_dict()
    assert st["submitted"] == st["completed"] + st["rejected"] + st["failed"]
    assert st["rejected"] == rejected
    sched.shutdown()


def test_scheduler_deadline_shrinks_b():
    s = _SlowSearcher(0.01)
    sched = RequestScheduler(s, workers=1, queue_depth=8)
    for _ in range(4):  # warm the EWMA with generous deadlines
        sched.search(np.zeros(4), 5, b=64, deadline_ms=10_000)
    r = sched.search(np.zeros(4), 5, b=64, deadline_ms=0.01)
    assert r.b_effective == sched.policy.b_min
    assert s.bs[-1] == sched.policy.b_min
    assert r.b_requested == 64
    assert sched.stats.as_dict()["degraded"] >= 1
    sched.shutdown()


def test_deadline_policy_ewma_and_clamp():
    p = DeadlinePolicy(b_min=2, alpha=0.5, safety=1.0, init_s_per_b=1e-3)
    assert p.choose_b(100, remaining_s=-1) == 2
    assert p.choose_b(100, remaining_s=10.0) == 100
    assert p.choose_b(100, remaining_s=0.01) == 10
    p.observe(10, 0.1)
    assert p.s_per_b == pytest.approx(0.5 * 1e-3 + 0.5 * 0.01)
    p.observe(0, 1.0)
    p.observe(10, -1.0)
    assert p.s_per_b == pytest.approx(0.5 * 1e-3 + 0.5 * 0.01)


def test_scheduler_worker_error_propagates():
    class Boom:
        def search(self, q, k, b=None, **o):
            raise RuntimeError("kaboom")

    sched = RequestScheduler(Boom(), workers=1, queue_depth=4)
    with pytest.raises(RuntimeError, match="kaboom"):
        sched.submit(np.zeros(4), 5).result(timeout=60)
    st = sched.stats.as_dict()
    assert st["failed"] == 1
    assert st["submitted"] == st["completed"] + st["rejected"] + st["failed"]
    sched.shutdown()


def test_scheduler_mutate_serializes_with_rwlock_reads():
    events = []
    lock = threading.Lock()

    class Tracked:
        def search(self, q, k, b=None, **o):
            with lock:
                events.append("r+")
            time.sleep(0.02)
            with lock:
                events.append("r-")
            return _StubRS(k)

    sched = RequestScheduler(Tracked(), workers=2, queue_depth=8)
    assert sched.snapshots is None
    futs = [sched.submit(np.zeros(4), 5) for _ in range(2)]
    time.sleep(0.005)

    def mut():
        with lock:
            events.append("w+")
        time.sleep(0.01)
        with lock:
            events.append("w-")

    sched.mutate(mut)
    for f in futs:
        f.result(timeout=60)
    sched.shutdown()
    i_w = events.index("w+")
    assert "r+" not in events[i_w : events.index("w-")], events


# ---------------------------------------------------------------- Server
def test_server_sync_mode_unchanged(built):
    idx = _open(built[1], backend="fstore")
    with Server(idx) as srv:
        rs, sid = srv.search(np.zeros(DIM, np.float32), k=5, b=4)
        assert rs.ids.shape[-1] == 5
        srv.more(sid, k=5)
        srv.close(sid)
        with pytest.raises(QueryClosedError):
            srv.more(sid, k=5)
        s = srv.stats.summary()
        assert s["queries"] == 1 and s["continuations"] == 1
        assert s["p50_ms"] is not None


def test_server_concurrent_blob_uses_snapshots(built, tmp_path):
    data = built[0]
    idx = _open(_fresh_blob(built, tmp_path), backend="blob")
    with Server(idx, workers=2, queue_depth=8) as srv:
        assert srv.scheduler is not None and srv.scheduler.snapshots is not None
        rs, sid = srv.search(data[0], k=10, b=6)
        base = int(idx.info.next_id)
        srv.insert(np.random.default_rng(0).normal(size=(32, DIM)).astype(np.float32),
                   np.arange(base, base + 32))
        srv.compact()
        more = srv.more(sid, k=10)  # snapshot-backed: immune to the compact
        assert more.ids.shape[-1] == 10
        srv.close(sid)


def test_server_batched_mode_and_write_path_refusal(built):
    data = built[0]
    bs = open_index(built[1], mode="packed", device="cpu")
    with Server(bs) as srv:
        rs, sid = srv.search(data[:4], k=5, b=4)
        assert rs.ids.shape == (4, 5)
        assert srv.more(sid, k=5).ids.shape == (4, 5)
        with pytest.raises(TypeError, match="MutableIndex"):
            srv.insert(data[:1])


def test_server_session_cap_evicts_lru(built):
    idx = _open(built[1], backend="fstore")
    with Server(idx, session_cap=3) as srv:
        sids = [srv.search(np.zeros(DIM, np.float32), k=5, b=4)[1] for _ in range(5)]
        assert srv.open_sessions == 3
        for sid in sids[:2]:
            with pytest.raises(QueryClosedError):
                srv.more(sid, k=5)
        srv.more(sids[-1], k=5)
        assert srv.stats.summary()["evicted_sessions"] == 2


def test_server_session_ttl_evicts_idle(built):
    idx = _open(built[1], backend="fstore")
    now = [0.0]
    with Server(idx, session_ttl_s=10.0, clock=lambda: now[0]) as srv:
        sid_old = srv.search(np.zeros(DIM, np.float32), k=5, b=4)[1]
        now[0] = 5.0
        sid_new = srv.search(np.zeros(DIM, np.float32), k=5, b=4)[1]
        now[0] = 11.0
        srv.search(np.zeros(DIM, np.float32), k=5, b=4)  # triggers sweep
        with pytest.raises(QueryClosedError):
            srv.more(sid_old, k=5)
        srv.more(sid_new, k=5)


def test_serve_stats_bounded_and_threadsafe():
    stats = ServeStats(ring_capacity=64)
    threads = [
        threading.Thread(target=lambda: [stats.record("search", 1.0) for _ in range(500)])
        for _ in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    ring = stats.ring("search")
    assert ring.count == 2000
    assert len(ring.values()) == 64
    assert stats.summary()["search_p99_ms"] == 1.0


def test_latency_ring_percentiles():
    r = LatencyRing(capacity=8)
    assert r.percentile(50) is None
    for v in [1.0, 2.0, 3.0, 4.0]:
        r.record(v)
    assert r.percentile(50) == pytest.approx(2.5)
    for v in range(100):
        r.record(float(v))
    assert r.values().min() == 92.0


# --------------------------------------------------------------- the demo
def test_serve_demo_runs_to_its_end_on_the_cpu(capsys):
    out = port_serve.demo("blob", device="cpu", n_items=3000)
    assert out["interactive"]["inserts"] == 64 and out["interactive"]["compactions"] == 1
    assert out["scheduler"]["completed"] == 32
    assert out["batched"]["queries"] == 32 and out["batched"]["continuations"] == 32
    assert "batched:" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #2"):
        port_serve.demo("blob+prefetch", device="cpu", n_items=3000)
