"""The port's tracing (``repro_torch.tracing``) and the packed path it
instruments: off, nothing is recorded and no profiler range is entered;
on, every stage's span, the host syncs and the scan's rows are counted as
the search passed them; spans nest per thread; set-up phases record
untraced; results do not change.  The ``cuda`` tests hold the sync
counter to torch's own sync warnings and keep the spans' device shadows
out of the benchmark's device work.  No JAX here, so the file runs where
the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing.py
"""
import json
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import ECPBuildConfig, build_index, open_index
from repro_torch.launch.serve import Server

ROOT = Path(__file__).resolve().parents[1]
D, K, B_LEAVES = 16, 50, 1
CFG = ECPBuildConfig(levels=2, metric="cosine", cluster_cap=40)


def _index(root: Path, device: str):
    data = np.random.default_rng(7).standard_normal((2400, D)).astype(np.float32)
    build_index(data, str(root / "ix"), CFG, device=device)
    return open_index(str(root / "ix"), mode="packed", device=device)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    return _index(tmp_path_factory.mktemp("tracing"), "cpu")


@pytest.fixture
def queries():
    return np.random.default_rng(8).standard_normal((6, D)).astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


def _serve(searcher, q, k=K, b=B_LEAVES):
    srv = Server(searcher)
    rs, sid = srv.search(q, k, b=b)
    more = srv.more(sid, k)
    srv.close(sid)
    return rs, more


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


def test_off_nothing_is_recorded_and_no_profiler_range_is_entered(packed, queries, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not tracing.enabled()
    _serve(packed, queries)
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}


def test_on_under_the_profiler_each_stage_and_sync_is_counted(packed, queries):
    _profiled(lambda: _serve(packed, queries))
    snap = tracing.snapshot()
    n = {name: s["count"] for name, s in snap["spans"].items()}
    chunks = n["ecpfs.packed.score"]
    assert chunks >= 3, "the search and its continuation scan more than one chunk"
    assert n["ecpfs.serve.search"] == n["ecpfs.serve.more"] == n["ecpfs.packed.rank"] == 1
    assert n["ecpfs.packed.upload"] == 1 and n["ecpfs.packed.merge"] == chunks
    assert n["ecpfs.packed.advance"] == n["ecpfs.packed.emit"] == n["ecpfs.packed.result"] == 2
    # the search's first chunk is scanned before its loop: each other chunk
    # ends a loop pass, and each of the two loops ends with a pass that stops
    assert n["ecpfs.packed.advance.wait"] == chunks + 1
    # the upload, a torch.unique per chunk, a test per pass, 3 copies twice
    assert snap["counters"]["ecpfs.packed.host_syncs"] == 1 + chunks + (chunks + 1) + 6
    assert snap["spans"]["ecpfs.packed.score"]["parents"] == {"ecpfs.serve.search": 1, "ecpfs.packed.advance": chunks - 1}
    assert all(s["device_n"] == 0 for s in snap["spans"].values())  # no CUDA events on the CPU

    # the rows, recomputed from the ranked leaves chunk by chunk
    q = torch.as_tensor(queries)
    with torch.no_grad():
        rank = packed.rank_leaves(q, max(B_LEAVES, 8))[0].numpy()
    sizes = packed.leaf_mask.sum(dim=1).numpy()
    cap = packed.leaf_mask.shape[1]
    R = rank.shape[1]
    scored = needed = 0
    for c in range(chunks):
        pos = c * B_LEAVES + np.arange(B_LEAVES)
        leaf = rank[:, np.minimum(pos, R - 1)]
        scored += len(queries) * len(np.unique(np.maximum(leaf, 0))) * cap
        needed += int(sizes[leaf[(pos < R)[None, :] & (leaf >= 0)]].sum())
    assert snap["counters"]["ecpfs.packed.rows_scored"] == scored
    assert snap["counters"]["ecpfs.packed.rows_needed"] == needed
    assert 0 < needed < scored


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    with tracing.on():
        with tracing.span("ecpfs.test.outer"):
            time.sleep(0.01)
            for _ in range(2):
                with tracing.span("ecpfs.test.inner"):
                    time.sleep(0.01)
    spans = tracing.snapshot()["spans"]
    outer, inner = spans["ecpfs.test.outer"], spans["ecpfs.test.inner"]
    assert inner["count"] == 2 and inner["parents"] == {"ecpfs.test.outer": 2}
    assert outer["parents"] == {None: 1}
    assert inner["self_s"] == inner["host_s"] >= 0.02
    assert outer["self_s"] == pytest.approx(outer["host_s"] - inner["host_s"], rel=1e-9, abs=1e-12)
    assert outer["self_s"] >= 0.01


def test_two_threads_spans_do_not_mix():
    opened, closed = threading.Event(), threading.Event()

    def a():
        with tracing.span("ecpfs.test.a"):
            opened.set()
            assert closed.wait(10)

    def b():
        assert opened.wait(10)
        with tracing.span("ecpfs.test.b"):
            time.sleep(0.02)
        closed.set()

    with tracing.on():
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
    assert not any(t.is_alive() for t in threads)
    spans = tracing.snapshot()["spans"]
    assert spans["ecpfs.test.b"]["parents"] == {None: 1}
    assert spans["ecpfs.test.a"]["parents"] == {None: 1}
    assert spans["ecpfs.test.a"]["self_s"] == spans["ecpfs.test.a"]["host_s"] >= 0.02


def test_set_up_phases_record_with_tracing_off(tmp_path):
    assert not tracing.enabled()
    _index(tmp_path, "cpu")
    snap = tracing.snapshot()
    assert set(snap["phases"]) == {"ecpfs.build.hierarchy", "ecpfs.build.assign", "ecpfs.build.write",
                                   "ecpfs.open.load", "ecpfs.open.upload"}
    assert all(p["count"] == 1 and p["s"] > 0 for p in snap["phases"].values())
    assert snap["spans"] == {} and snap["counters"] == {}


def test_results_are_bit_identical_with_tracing_on_and_off(packed, queries):
    off = _serve(packed, queries)
    on = _profiled(lambda: _serve(packed, queries))
    with tracing.on():
        forced = _serve(packed, queries)
    for got in (on, forced):
        for a, b in zip(off, got):
            assert np.array_equal(a.ids, b.ids)
            assert np.array_equal(a.dists.view(np.uint32), b.dists.view(np.uint32))
            assert [s.leaves_opened for s in a.stats] == [s.leaves_opened for s in b.stats]


def test_a_continuation_carries_its_search_request_id(packed, queries, monkeypatch):
    seen = []

    class Range:
        def __init__(self, name, inputs=(), kwargs=None):
            seen.append((name, kwargs))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    srv = Server(packed)
    with tracing.on():
        for _ in range(2):
            _, sid = srv.search(queries, K, b=B_LEAVES)
            srv.more(sid, K)
    ids = [(name, args) for name, args in seen if name.startswith("ecpfs.serve.")]
    assert ids == [("ecpfs.serve.search", {"request": 0}), ("ecpfs.serve.more", {"request": 0}),
                   ("ecpfs.serve.search", {"request": 1}), ("ecpfs.serve.more", {"request": 1})]


def test_the_request_id_reaches_an_exported_trace(packed, queries, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True) as prof:
        srv = Server(packed)
        _, sid = srv.search(queries, K, b=B_LEAVES)
        srv.more(sid, K)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    got = {(e["name"], e["args"].get("request")) for e in events if e.get("name", "").startswith("ecpfs.serve.")}
    assert got == {("ecpfs.serve.search", 0), ("ecpfs.serve.more", 0)}


# ------------------------------------------------------------- on the card
@pytest.fixture(scope="module")
def card_index(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events and sync warnings exist only on the card")
    return _index(tmp_path_factory.mktemp("tracing_cuda"), "cuda")


@pytest.mark.cuda
def test_host_syncs_counts_what_torch_warns_of(card_index, queries):
    """Every wait the counter counts is one torch flags in its sync debug
    mode, and no other: the upload from pageable memory, each loop test,
    each copy back (the card's leaf scoring waits for nothing)."""
    _serve(card_index, queries)  # warm
    torch.cuda.synchronize()
    tracing.reset()
    with tracing.on(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _serve(card_index, queries)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    warned = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    snap = tracing.snapshot()
    assert snap["spans"]["ecpfs.packed.score"]["count"] >= 3
    assert snap["counters"]["ecpfs.packed.host_syncs"] == len(warned), [str(w.message)[:120] for w in warned]


@pytest.mark.cuda
def test_program_spans_are_not_device_work(card_index, queries, monkeypatch):
    """A traced search on a client thread, as the benchmark runs it: the
    spans are on the host timeline, their device shadows stay out of the
    benchmark's device operations, the CUDA events time the stages, and
    pending event pairs stay bounded."""
    sys.path.insert(0, str(ROOT))
    from portbench.trace import WINDOW, from_profiler

    monkeypatch.setattr(tracing, "MAX_PENDING", 4)
    _serve(card_index, queries)  # warm
    torch.cuda.synchronize()
    tracing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        prof = torch.profiler.profile(activities=acts, experimental_config=cfg)
    except (AttributeError, TypeError):
        prof = torch.profiler.profile(activities=acts)
    pending = []

    def client():
        for _ in range(3):
            _serve(card_index, queries)
            pending.append(len(tracing._pending))

    with prof:
        with torch.profiler.record_function(WINDOW):
            t = threading.Thread(target=client)
            t.start()
            t.join(120)
            torch.cuda.synchronize()
    assert not t.is_alive()
    tr = from_profiler(prof)
    assert tr.device, "the profiler recorded no device operation"
    assert not [n for n, _, _ in tr.device if n.startswith("ecpfs.")]
    assert {"ecpfs.serve.search", "ecpfs.packed.rank", "ecpfs.packed.score"} <= {n for n, _, _ in tr.host}
    snap = tracing.snapshot()
    assert snap["spans"]["ecpfs.serve.search"]["count"] == 3
    for stage in ("ecpfs.packed.rank", "ecpfs.packed.score", "ecpfs.packed.merge"):
        rec = snap["spans"][stage]
        assert rec["device_n"] == rec["count"] > 0 and rec["device_s"] > 0
    assert max(pending) <= 5
