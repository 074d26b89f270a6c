"""Concurrent request scheduling for the serving layer (the port's copy of
the reference's ``launch/scheduler.py``: host threading and numpy).

The paper's serving scenario is many queries against memory-constrained
indexes; ``BENCH_search.json`` showed the naive single-threaded loop pays
~15x search-latency inflation the moment a writer is active (the search
waits for every insert batch to finish).  This module turns serving into
a concurrent, deadline-aware pipeline with three pieces:

  ``RequestScheduler``
    A bounded admission queue in front of a worker thread pool.  A full
    queue REJECTS (``ServerOverloadedError``) instead of buffering without
    bound — backpressure the client can act on.  Each worker executes one
    search per request against an isolated snapshot (below), so reads
    never block on ``insert``/``delete``/``compact``.

  ``DeadlinePolicy``
    Maps a request's remaining deadline onto the paper's effort knob
    ``b`` (leaves scanned per increment): an EWMA of observed
    seconds-per-unit-``b`` estimates what effort still fits, and the
    request's ``b`` shrinks toward ``b_min`` as the deadline nears.
    Overload therefore degrades RECALL (fewer leaves scanned) instead of
    latency — the knob the paper exposes, applied end-to-end.

  ``SnapshotManager``
    Leases generation-pinned ``ECPSnapshot`` views to workers.  Reads are
    always served from the freshest *committed* snapshot: after each
    mutation the scheduler re-pins; while a mutation is mid-flight,
    readers keep the previous generation (never a torn state, never a
    block).  Requires a pinning store (blob); for fstore the scheduler
    falls back to a readers-writer lock — reads still run concurrently
    with each other, only writes are exclusive.

Replica setup: because a ``BlobSnapshot`` is just a dup'd fd over the one
blob file, N read-only server processes can serve the same file while a
single writer process mutates it; external readers poll
``info.generation`` (see ``core/lifecycle.publish_generation``) and
``refresh()`` when it moves.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "DeadlinePolicy",
    "RequestScheduler",
    "ScheduledResult",
    "SchedulerStats",
    "ServerOverloadedError",
    "SnapshotManager",
]


class ServerOverloadedError(RuntimeError):
    """Admission queue full — backpressure: back off and retry, lower the
    request rate, or raise ``queue_depth``/``workers``."""


# ---------------------------------------------------------------- deadlines
class DeadlinePolicy:
    """Shrink the effort knob ``b`` to fit a request's remaining deadline.

    Keeps an EWMA of observed seconds-per-unit-``b`` across completed
    searches; ``choose_b`` returns the largest ``b <= b_requested`` whose
    estimated cost (with a safety factor) fits the remaining time, floored
    at ``b_min`` so a late request still returns *some* answer instead of
    an error.  Thread-safe.
    """

    def __init__(
        self,
        *,
        b_min: int = 1,
        alpha: float = 0.2,
        safety: float = 1.5,
        init_s_per_b: float = 5e-4,
    ):
        self.b_min = max(1, int(b_min))
        self._alpha = float(alpha)
        self._safety = float(safety)
        self._s_per_b = float(init_s_per_b)
        self._lock = threading.Lock()

    @property
    def s_per_b(self) -> float:
        with self._lock:
            return self._s_per_b

    def choose_b(self, b: int, remaining_s: float) -> int:
        if remaining_s <= 0:
            return self.b_min
        with self._lock:
            est = self._s_per_b
        fits = int(remaining_s / (est * self._safety)) if est > 0 else b
        return max(self.b_min, min(int(b), fits))

    def observe(self, b_used: int, elapsed_s: float) -> None:
        if b_used <= 0 or elapsed_s < 0:
            return
        obs = elapsed_s / b_used
        with self._lock:
            self._s_per_b += self._alpha * (obs - self._s_per_b)


# ---------------------------------------------------------------- snapshots
class SnapshotManager:
    """Refcounted leases over the freshest committed ``ECPSnapshot``.

    ``lease()`` hands out the current snapshot (taking one reference; the
    caller must ``release()`` it).  When the index's published generation
    has moved past the cached snapshot, the manager re-pins — but only if
    the mutation lock is free: mid-mutation readers keep the previous
    committed generation rather than blocking.  ``refresh()`` (called by
    the scheduler after each mutation returns) force-pins the new
    generation.
    """

    def __init__(self, index):
        self._index = index
        self._lock = threading.Lock()
        self._cur = None
        self.refreshes = 0

    def lease(self):
        with self._lock:
            cur = self._cur
            stale = cur is None or cur.generation != self._index.info.generation
            if stale:
                # block only for the very first snapshot; afterwards a
                # busy writer means "serve the previous generation"
                if self._index._mut_lock.acquire(blocking=cur is None):
                    try:
                        self._repin_locked()
                    finally:
                        self._index._mut_lock.release()
            return self._cur.acquire()

    def refresh(self) -> None:
        """Re-pin after a mutation committed (the writer has released the
        mutation lock, so this never serves a torn state)."""
        with self._lock:
            with self._index._mut_lock:
                self._repin_locked()

    def _repin_locked(self) -> None:
        new = self._index.snapshot()
        old, self._cur = self._cur, new
        self.refreshes += 1
        if old is not None:
            old.release()

    @property
    def current_generation(self):
        with self._lock:
            return None if self._cur is None else self._cur.generation

    def close(self) -> None:
        with self._lock:
            cur, self._cur = self._cur, None
        if cur is not None:
            cur.release()


# ------------------------------------------------------------------ RW lock
class _RWLock:
    """Many concurrent readers / one exclusive writer, writer-preferring —
    the fallback isolation for stores without generation pinning."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


# ---------------------------------------------------------------- scheduler
@dataclass
class SchedulerStats:
    """Deadline/admission accounting (guarded by ``lock``).  Invariants
    the serving smoke test asserts: ``submitted == completed + rejected +
    failed + pending``; ``deadline_misses <= completed``; ``degraded``
    only counts requests that carried a deadline."""

    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    failed: int = 0
    degraded: int = 0          # b shrunk below the requested effort
    deadline_misses: int = 0   # finished after their deadline anyway
    queue_wait_ms: float = 0.0  # cumulative admission-to-start wait
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def as_dict(self) -> dict:
        with self.lock:
            d = {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                "degraded": self.degraded,
                "deadline_misses": self.deadline_misses,
                "queue_wait_ms": round(self.queue_wait_ms, 3),
            }
        return d


@dataclass
class ScheduledResult:
    """What a scheduled search resolves to: the ``ResultSet``, the snapshot
    lease backing its query handle (``None`` in RW-lock mode — the caller
    owns releasing it), the effort actually spent, and the queue wait."""

    rs: object
    lease: object
    b_requested: int
    b_effective: int
    queue_wait_ms: float


@dataclass
class _Req:
    q: np.ndarray
    k: int
    b: int | None
    deadline: float | None  # absolute time.monotonic()
    opts: dict
    future: Future
    t_submit: float


_STOP = object()


class RequestScheduler:
    """Thread-pool searches over an index, with bounded admission and
    snapshot-isolated reads.

    ``submit`` enqueues one search and returns a ``Future`` resolving to a
    ``ScheduledResult``; a full queue raises ``ServerOverloadedError``
    instead of queueing unboundedly.  ``search`` is the blocking
    convenience.  ``mutate(fn)`` runs a write: with a pinning (blob) store
    the mutation runs concurrently with reads (they hold snapshots) and
    the manager re-pins afterwards; with fstore it takes the writer side
    of a RW lock.  ``read_lock()`` brackets non-snapshot reads (query
    continuations) in RW-lock mode and is free otherwise.
    """

    def __init__(
        self,
        index,
        *,
        workers: int = 4,
        queue_depth: int = 64,
        policy: DeadlinePolicy | None = None,
        default_b: int = 8,
    ):
        self.index = index
        self.policy = policy if policy is not None else DeadlinePolicy()
        self.default_b = int(default_b)
        self.stats = SchedulerStats()
        # snapshot isolation needs a generation-pinning index: either it
        # says so itself (ECPIndex / FederatedIndex expose
        # supports_snapshot) or its raw store pins (blob behind a bare
        # searcher)
        pinnable = getattr(index, "supports_snapshot", False) or (
            getattr(getattr(index, "store", None), "pin", None) is not None
        )
        self.snapshots = (
            SnapshotManager(index)
            if pinnable and hasattr(index, "snapshot")
            else None
        )
        self._rw = _RWLock()
        self.queue_depth = int(queue_depth)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._threads = [
            threading.Thread(target=self._worker, name=f"serve-worker-{i}", daemon=True)
            for i in range(max(1, int(workers)))
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ requests
    def submit(self, q, k: int = 100, *, b=None, deadline_ms=None, **opts) -> Future:
        f: Future = Future()
        now = time.monotonic()
        deadline = None if deadline_ms is None else now + float(deadline_ms) / 1e3
        req = _Req(q=q, k=int(k), b=b, deadline=deadline, opts=opts, future=f, t_submit=now)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self.stats.lock:
                self.stats.rejected += 1
                self.stats.submitted += 1
            raise ServerOverloadedError(
                f"admission queue full ({self.queue_depth} requests pending); "
                "back off and retry"
            ) from None
        with self.stats.lock:
            self.stats.submitted += 1
        return f

    def search(self, q, k: int = 100, *, b=None, deadline_ms=None, **opts) -> ScheduledResult:
        return self.submit(q, k, b=b, deadline_ms=deadline_ms, **opts).result()

    # ------------------------------------------------------------ mutation
    def mutate(self, fn):
        """Run one mutation; readers never observe a torn state.  With
        snapshots, reads proceed concurrently on pinned generations and
        the manager re-pins once the mutation commits; without, the
        mutation holds the write lock."""
        if self.snapshots is not None:
            out = fn()  # ECPIndex serializes mutators on its _mut_lock
            self.snapshots.refresh()
            return out
        self._rw.acquire_write()
        try:
            return fn()
        finally:
            self._rw.release_write()

    class _ReadLock:
        def __init__(self, rw: "_RWLock | None"):
            self._rw = rw

        def __enter__(self):
            if self._rw is not None:
                self._rw.acquire_read()
            return self

        def __exit__(self, *exc):
            if self._rw is not None:
                self._rw.release_read()

    def read_lock(self) -> "_ReadLock":
        """Context manager for reads that bypass the worker pool (query
        continuations): shares the RW lock in fstore mode, no-op when
        snapshot isolation is on."""
        return self._ReadLock(None if self.snapshots is not None else self._rw)

    # ------------------------------------------------------------- workers
    def _worker(self) -> None:
        while True:
            req = self._q.get()
            if req is _STOP:
                return
            if not req.future.set_running_or_notify_cancel():
                continue
            try:
                req.future.set_result(self._execute(req))
            except BaseException as e:  # delivered to the caller, not lost
                with self.stats.lock:
                    self.stats.failed += 1
                req.future.set_exception(e)

    def _execute(self, req: _Req) -> ScheduledResult:
        t0 = time.monotonic()
        b_req = self.default_b if req.b is None else int(req.b)
        b_eff = b_req
        if req.deadline is not None:
            b_eff = self.policy.choose_b(b_req, req.deadline - t0)
        lease = None
        if self.snapshots is not None:
            lease = self.snapshots.lease()
            searcher = lease
        else:
            self._rw.acquire_read()
            searcher = self.index
        try:
            rs = searcher.search(np.asarray(req.q, np.float32), req.k, b=b_eff, **req.opts)
        except BaseException:
            if lease is not None:
                lease.release()
            raise
        finally:
            if lease is None:
                self._rw.release_read()
        done = time.monotonic()
        self.policy.observe(b_eff, done - t0)
        with self.stats.lock:
            self.stats.completed += 1
            self.stats.queue_wait_ms += (t0 - req.t_submit) * 1e3
            if b_eff < b_req:
                self.stats.degraded += 1
            if req.deadline is not None and done > req.deadline:
                self.stats.deadline_misses += 1
        return ScheduledResult(
            rs=rs,
            lease=lease,
            b_requested=b_req,
            b_effective=b_eff,
            queue_wait_ms=(t0 - req.t_submit) * 1e3,
        )

    # ------------------------------------------------------------ lifecycle
    def shutdown(self) -> None:
        """Drain queued requests, stop the workers, drop the cached
        snapshot.  Idempotent."""
        for _ in self._threads:
            self._q.put(_STOP)
        for t in self._threads:
            t.join()
        self._threads = []
        if self.snapshots is not None:
            self.snapshots.close()

    def __enter__(self) -> "RequestScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
