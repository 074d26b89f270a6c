"""ANN serving driver — the paper's own application as a service loop (the
port's counterpart of the reference's ``launch/serve.py``).

One ``Server`` class over ANY ``Searcher`` (core/api.py): the serving
logic no longer cares whether requests hit the host-driven file structure
(``open_index(path, mode="file")`` — per-query state, get-next-k
continuation, LRU-bounded memory: the paper's mode) or the device-side
level-synchronous beam search (``mode="packed"`` — request batching, and
what ``open_index(path)`` opens on a GPU).  Continuations are tracked as ``Query`` handles behind integer
session ids; closing a session frees its state and later use raises
``QueryClosedError`` — not a silent crash.

Concurrency (``workers > 0``): searches go through a
``launch/scheduler.RequestScheduler`` — a bounded admission queue (full
queue rejects with ``ServerOverloadedError``: backpressure, not unbounded
buffering), a worker pool, per-request deadlines mapped onto the effort
knob ``b`` (overload degrades recall, not latency), and snapshot-isolated
reads on pinning (blob) stores so searches never block on a writer.
``workers=0`` (the default) keeps the original synchronous behavior.

Sessions are bounded too: at most ``session_cap`` live continuations
(least-recently-used evicted first) and an optional ``session_ttl_s``
idle timeout; using an evicted session raises ``QueryClosedError``.

When the searcher is a ``MutableIndex`` (file-mode eCP-FS), the server
also exposes the write path: ``insert`` / ``delete`` apply while read
sessions stay valid (inserts append, deletes tombstone); ``compact``
rewrites the tree, after which resuming a pre-compaction session raises
``StaleQueryError`` — the client re-issues the search.  (Sessions served
from a snapshot keep their pinned generation and never turn stale.)

  PYTHONPATH=src python -m repro_torch.launch.serve --demo                # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --demo --device cpu   # on the CPU

The demo's ``--backend`` is ``fstore`` or ``blob``; ``blob+prefetch`` (an
async prefetch store) is not ported yet and raises.
"""
from __future__ import annotations

import argparse
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import (
    ECPBuildConfig,
    MutableIndex,
    QueryClosedError,
    ResultSet,
    Searcher,
    build_index,
    convert,
    open_index,
)
from repro_torch.data.synthetic import clustered_vectors
from repro_torch.launch.scheduler import (
    DeadlinePolicy,
    RequestScheduler,
    ServerOverloadedError,
)

__all__ = ["LatencyRing", "Server", "ServeStats", "ServerOverloadedError", "demo"]


class LatencyRing:
    """Fixed-capacity ring of latency samples: O(capacity) memory no
    matter how long the server runs, percentiles over the most recent
    ``capacity`` observations.  Callers synchronize (ServeStats holds the
    lock)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._buf = np.zeros(self.capacity, np.float64)
        self.count = 0  # total ever recorded (>= len(values()))

    def record(self, ms: float) -> None:
        self._buf[self.count % self.capacity] = ms
        self.count += 1

    def values(self) -> np.ndarray:
        return self._buf[: min(self.count, self.capacity)].copy()

    def percentile(self, p: float):
        n = min(self.count, self.capacity)
        if n == 0:
            return None
        return float(np.percentile(self._buf[:n], p))


class ServeStats:
    """Thread-safe serving counters with bounded latency memory.

    Latencies are kept in per-phase ``LatencyRing`` buffers ("search",
    "more", ...) instead of an append-forever list; every update happens
    under one lock so the multi-threaded scheduler path can share it.
    """

    def __init__(self, ring_capacity: int = 4096):
        self._lock = threading.Lock()
        self._capacity = int(ring_capacity)
        self._rings: dict[str, LatencyRing] = {}
        self.queries = 0
        self.continuations = 0
        self.inserts = 0
        self.deletes = 0
        self.compactions = 0
        self.evicted_sessions = 0

    def record(self, phase: str, ms: float) -> None:
        with self._lock:
            ring = self._rings.get(phase)
            if ring is None:
                ring = self._rings[phase] = LatencyRing(self._capacity)
            ring.record(ms)

    def count(self, field_name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field_name, getattr(self, field_name) + n)

    def ring(self, phase: str) -> LatencyRing | None:
        with self._lock:
            return self._rings.get(phase)

    def summary(self) -> dict:
        with self._lock:
            merged = (
                np.concatenate([r.values() for r in self._rings.values()])
                if self._rings
                else np.empty(0)
            )
            out = {
                "queries": self.queries,
                "continuations": self.continuations,
                "p50_ms": float(np.percentile(merged, 50)) if merged.size else None,
                "p99_ms": float(np.percentile(merged, 99)) if merged.size else None,
            }
            for phase, ring in self._rings.items():
                out[f"{phase}_p50_ms"] = ring.percentile(50)
                out[f"{phase}_p99_ms"] = ring.percentile(99)
            if self.inserts or self.deletes or self.compactions:
                out.update(
                    inserts=self.inserts,
                    deletes=self.deletes,
                    compactions=self.compactions,
                )
            if self.evicted_sessions:
                out["evicted_sessions"] = self.evicted_sessions
        return out


@dataclass
class _Session:
    query: object               # the Query continuation handle
    lease: object = None        # ECPSnapshot lease backing it (or None)
    last_used: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def dispose(self) -> None:
        try:
            self.query.close()
        finally:
            if self.lease is not None:
                self.lease.release()
                self.lease = None


class Server:
    """Serving loop over any unified-API searcher.

    ``search`` answers one vector or a whole request batch and returns
    ``(ResultSet, session_id)``; ``more`` resumes a session via its Query
    handle; ``close`` drops it.  Works identically for file-mode eCP-FS,
    the packed device searcher, and any baseline.

    With ``workers > 0`` searches run on a ``RequestScheduler`` worker
    pool: pass ``deadline_ms=`` to ``search`` to let the deadline policy
    shrink ``b``; a full admission queue raises ``ServerOverloadedError``.
    Continuations (``more``) always run on the calling thread — their
    state is single-owner — under the session's own lock.
    """

    def __init__(
        self,
        searcher: Searcher,
        *,
        workers: int = 0,
        queue_depth: int = 64,
        session_cap: int = 1024,
        session_ttl_s: float | None = None,
        policy: DeadlinePolicy | None = None,
        default_b: int = 8,
        clock=time.monotonic,
    ):
        self.searcher = searcher
        self.stats = ServeStats()
        self.session_cap = int(session_cap)
        self.session_ttl_s = session_ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._sessions: OrderedDict[int, _Session] = OrderedDict()
        self._next_sid = 0
        self.scheduler: RequestScheduler | None = None
        if workers > 0:
            self.scheduler = RequestScheduler(
                searcher,
                workers=workers,
                queue_depth=queue_depth,
                policy=policy,
                default_b=default_b,
            )

    # ------------------------------------------------------------- sessions
    def _register(self, query, lease=None) -> int:
        evicted: list[_Session] = []
        with self._lock:
            now = self._clock()
            self._evict_locked(now, evicted)
            while len(self._sessions) >= self.session_cap:
                _, old = self._sessions.popitem(last=False)
                evicted.append(old)
            sid = self._next_sid
            self._next_sid += 1
            self._sessions[sid] = _Session(query=query, lease=lease, last_used=now)
        for s in evicted:
            self.stats.count("evicted_sessions")
            s.dispose()
        return sid

    def _evict_locked(self, now: float, out: list) -> None:
        if self.session_ttl_s is None:
            return
        while self._sessions:
            sid, sess = next(iter(self._sessions.items()))
            if now - sess.last_used <= self.session_ttl_s:
                break
            del self._sessions[sid]
            out.append(sess)

    def _session(self, sid: int) -> _Session:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                raise QueryClosedError(f"unknown, closed, or evicted session: {sid}")
            sess.last_used = self._clock()
            self._sessions.move_to_end(sid)
            return sess

    # -------------------------------------------------------------- reading
    def search(
        self, q, k: int = 100, *, b=None, deadline_ms=None, **opts
    ) -> tuple[ResultSet, int]:
        """Serve one search; extra ``opts`` (e.g. the recall knob
        ``probe_m``) flow through to the underlying searcher."""
        t0 = time.perf_counter()
        if self.scheduler is not None:
            res = self.scheduler.search(q, k, b=b, deadline_ms=deadline_ms, **opts)
            rs, lease = res.rs, res.lease
        else:
            rs = self.searcher.search(np.asarray(q, np.float32), k, b=b, **opts)
            lease = None
        sid = self._register(rs.query, lease)
        n = 1 if rs.ids.ndim == 1 else rs.ids.shape[0]
        self.stats.count("queries", n)
        self.stats.record("search", (time.perf_counter() - t0) * 1e3)
        return rs, sid

    def submit(self, q, k: int = 100, *, b=None, deadline_ms=None, **opts):
        """Async variant (needs ``workers > 0``): returns a Future of a
        ``(ResultSet, session_id)`` pair; may raise ServerOverloadedError."""
        if self.scheduler is None:
            raise RuntimeError("submit() needs Server(..., workers>0)")
        t0 = time.perf_counter()
        inner = self.scheduler.submit(q, k, b=b, deadline_ms=deadline_ms, **opts)
        from concurrent.futures import Future

        outer: Future = Future()

        def _done(f):
            if f.exception() is not None:
                outer.set_exception(f.exception())
                return
            res = f.result()
            sid = self._register(res.rs.query, res.lease)
            n = 1 if res.rs.ids.ndim == 1 else res.rs.ids.shape[0]
            self.stats.count("queries", n)
            self.stats.record("search", (time.perf_counter() - t0) * 1e3)
            outer.set_result((res.rs, sid))

        inner.add_done_callback(_done)
        return outer

    def more(self, sid: int, k: int = 100) -> ResultSet:
        t0 = time.perf_counter()
        sess = self._session(sid)
        guard = (
            self.scheduler.read_lock()
            if self.scheduler is not None and sess.lease is None
            else _NULL_CTX
        )
        with sess.lock, guard:
            rs = sess.query.next(k)
        self.stats.count(
            "continuations", 1 if rs.ids.ndim == 1 else rs.ids.shape[0]
        )
        self.stats.record("more", (time.perf_counter() - t0) * 1e3)
        return rs

    def close(self, sid: int) -> None:
        with self._lock:
            sess = self._sessions.pop(sid, None)
        if sess is None:
            raise QueryClosedError(f"unknown, closed, or evicted session: {sid}")
        sess.dispose()

    @property
    def open_sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    # ------------------------------------------------------------ mutation
    def _mutable(self) -> MutableIndex:
        s = self.searcher
        if not isinstance(s, MutableIndex):
            raise TypeError(
                f"{type(s).__name__} is not a MutableIndex; the write path "
                "needs a file-mode eCP index (open_index(mode='file'))"
            )
        return s

    def _mutate(self, fn):
        if self.scheduler is not None:
            return self.scheduler.mutate(fn)
        return fn()

    def insert(self, vectors, ids=None) -> dict:
        """Ingest vectors while serving; open sessions stay valid."""
        r = self._mutate(lambda: self._mutable().insert(vectors, ids))
        self.stats.count("inserts", r["inserted"])
        return r

    def delete(self, ids) -> int:
        """Tombstone items; results filter them immediately."""
        n = self._mutate(lambda: self._mutable().delete(ids))
        self.stats.count("deletes", n)
        return n

    def compact(self) -> dict:
        """Rewrite the index; pre-compaction live sessions turn stale
        (resuming one raises StaleQueryError) but stay registered until
        closed.  Snapshot-backed sessions keep their pinned generation."""
        r = self._mutate(lambda: self._mutable().compact())
        self.stats.count("compactions")
        return r

    def shutdown(self) -> None:
        """Close every open session, the scheduler, and the searcher."""
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for s in sessions:
            s.dispose()
        if self.scheduler is not None:
            self.scheduler.shutdown()
        close = getattr(self.searcher, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_CTX = _NullCtx()


BACKENDS = ("fstore", "blob")


def demo(backend: str = "fstore", device="cuda", *, n_items: int = 50_000) -> dict:
    """The reference's three servers over one ``clustered_vectors``
    collection (``n_items`` x 128, l2): interactive file mode with the
    write path, a 4-worker scheduler over snapshots of the blob while a
    writer inserts, and a batched packed-mode server.  The device work
    (the build's assignment, the packed search) runs on ``device``.
    Returns each server's stats summary."""
    import tempfile

    if backend not in BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP Queue 1 #2: "
            "AsyncPrefetchStore and prefetch=True); use fstore or blob"
        )
    out: dict = {}
    data, _ = clustered_vectors(0, n=n_items, dim=128, n_clusters=256)
    with tempfile.TemporaryDirectory() as td:
        path = td + "/idx"
        print("building index ...")
        build_index(data, path, ECPBuildConfig(levels=2, cluster_cap=200, metric="l2"),
                    device=device)
        blob = str(convert(path, td + "/idx.blob"))
        rng = np.random.default_rng(1)
        qs = data[rng.integers(0, len(data), 32)] + 0.01 * rng.normal(size=(32, 128)).astype(np.float32)

        # interactive: the paper's mode — one request at a time, bounded RAM;
        # the node storage is the --backend axis (fstore | blob)
        idx = open_index(
            path if backend == "fstore" else blob,
            mode="file", backend=backend, cache_max_nodes=64, device=device,
        )
        with Server(idx) as srv:  # shutdown() closes sessions + the index
            sids = [srv.search(q, k=20, b=8)[1] for q in qs]
            for sid in sids[:8]:
                srv.more(sid, k=20)
            for sid in sids:
                srv.close(sid)

            # the write path: ingest + tombstone while serving, then compact
            new = data[:64] + 0.02 * rng.normal(size=(64, 128)).astype(np.float32)
            srv.insert(new, np.arange(len(data), len(data) + 64))
            srv.delete(np.arange(0, 500, 7))
            hit = srv.search(new[0], k=5, b=8)[0]
            if len(data) not in hit.row_ids(0):
                raise AssertionError("inserted item must be findable")
            print(f"compacted: {srv.compact()}")
            out["interactive"] = srv.stats.summary()
            print(f"interactive[{backend}]:", out["interactive"])
            print("  store io:", idx.store.io.as_dict())

        # concurrent: worker pool + deadline-aware effort on the blob store
        # (snapshot-isolated reads: searches never block on the writer)
        cidx = open_index(blob, mode="file", backend="blob", cache_max_nodes=64, device=device)
        with Server(cidx, workers=4, queue_depth=32) as csrv:
            futs = [csrv.submit(q, k=20, b=8, deadline_ms=50.0) for q in qs]
            csrv.insert(new, np.arange(len(data) + 64, len(data) + 128))
            for f in futs:
                _, sid = f.result()
                csrv.close(sid)
            out["concurrent"] = csrv.stats.summary()
            out["scheduler"] = csrv.scheduler.stats.as_dict()
            print("concurrent: ", out["concurrent"])
            print("  scheduler:", out["scheduler"])

        # batched: same Server, device searcher, whole batch per tick
        with Server(open_index(path, mode="packed", device=device)) as bsrv:
            rs, sid = bsrv.search(qs, k=20, b=8)
            bsrv.more(sid, k=20)
            bsrv.close(sid)
            out["batched"] = bsrv.stats.summary()
            print("batched:    ", out["batched"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true")
    ap.add_argument(
        "--backend", choices=("fstore", "blob", "blob+prefetch"), default="fstore",
        help="node storage for the interactive (file-mode) server; blob+prefetch "
        "is not ported yet and raises",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-items", type=int, default=50_000)
    args = ap.parse_args()
    if args.demo:
        demo(args.backend, args.device, n_items=args.n_items)
    else:
        print("use --demo (library mode: import Server + repro_torch.core.open_index)")
