"""The port's CUDA kernels on the card.  Every test here carries the ``cuda``
marker and skips without a GPU: a kernel written in CUDA has no CPU mode.
No JAX here, so the file runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import leaf_distances as ld
from repro_torch.kernels import leaf_merge as lm
from repro_torch.kernels.distance_topk import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _calls(device, seed=0):
    """Kernel calls whose workspaces differ in size, so that threads running
    them at once grow the shared (device, stream) workspace under each
    other: key lists past the first 1 MiB, more than 1024 counters."""
    g = torch.Generator().manual_seed(seed)
    D = 128
    calls = []
    for G, N, k in ((32, 455, 100), (128, 5360, 128), (256, 2048, 256), (1500, 300, 64), (64, 700, 700)):
        codes = torch.randint(-128, 128, (G, N, D), generator=g, dtype=torch.int8)
        n_rows = torch.randint(0, N + 1, (G,), generator=g, dtype=torch.int32)
        args = (torch.randn(G, D, generator=g), codes, torch.rand(G, generator=g) * 0.01 + 1e-3,
                torch.randn(G, generator=g) * 0.01, n_rows)
        calls.append(("grouped", tuple(t.to(device) for t in args), k, "cosine"))
    for B, N, k in ((1, 5632, 5632), (8, 1024, 1024), (2048, 512, 512), (16, 4096, 100)):
        args = (torch.randn(B, D, generator=g), torch.randn(N, D, generator=g))
        calls.append(("full" if k >= N else "merge", tuple(t.to(device) for t in args), k, "l2"))
    return calls


def _run(call):
    kind, args, k, metric = call
    if kind == "grouped":
        return ops.grouped_distance_topk_tensors(*args, k, metric, "int8")
    return ops.distance_topk(*args, k, metric)


def test_threads_sharing_the_default_stream_match_the_calls_run_alone(card):
    """4 threads launch both distance kernels on the one default stream they
    share, at shapes that grow the shared workspace while other threads hold
    it: every result is bit-identical to the same call run alone."""
    calls = _calls(card)
    ops.workspaces.clear()
    alone = [_run(c) for c in calls]
    torch.cuda.synchronize()
    ops.workspaces.clear()  # start small again: the threads grow it
    got: dict = {}
    errors: list = []

    def worker(t):
        try:
            for rep in range(3):
                for i in range(t, len(calls), 4):
                    got[(rep, i)] = _run(calls[i])
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got) == 3 * len(calls)
    for (rep, i), (d, idx) in got.items():
        np.testing.assert_array_equal(d.cpu().numpy(), alone[i][0].cpu().numpy(), err_msg=f"call {i} rep {rep}")
        np.testing.assert_array_equal(idx.cpu().numpy(), alone[i][1].cpu().numpy(), err_msg=f"call {i} rep {rep}")
    ws = next(iter(ops.workspaces.values()))
    assert len(ops.workspaces) == 1 and int(ws[1].abs().sum()) == 0  # one workspace, counters at rest


def test_candidate_scores_on_the_card_is_one_launch_of_the_split_path(card):
    """The recsys tower's scoring at B = 1 on the card: one launch of the
    k < N path, the plain version's top 100 (scores within 1e-4 * max(1,
    |s|), ids equal but among such near-equal scores), the tail block's
    last row found first, every finish counter back at 0."""
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    from repro_torch.models import recsys

    g = torch.Generator().manual_seed(5)
    for N, d in ((200_000, 18), (200_003, 32), (1000, 16)):
        q, cand = torch.randn(1, d, generator=g), torch.randn(N, d, generator=g)
        cand[-1] = q[0] * 50
        q, cand = q.to(card), cand.to(card)
        ops.reset_launches()
        s, i = recsys.candidate_scores(q, cand, 100)
        assert ops.launches["distance_topk"] == 1
        assert s.shape == i.shape == (1, 100) and i.dtype == torch.int32 and s.device == card
        d0, i0 = distance_topk_ref(q, cand, 100, "ip")
        s, i, s0, i0 = s.cpu().numpy(), i.cpu().numpy(), -d0.cpu().numpy(), i0.cpu().numpy()
        tol = 1e-4 * np.maximum(1.0, np.abs(s0))
        assert (np.abs(s - s0) <= tol).all()
        for j in np.flatnonzero(i[0] != i0[0]):
            hit = np.flatnonzero(i0[0] == i[0, j])
            ref = s0[0, hit[0]] if len(hit) else s0[0, -1]
            assert abs(s[0, j] - ref) <= 2e-4 * max(1.0, abs(ref)), (N, d, j)
        assert int(i[0, 0]) == N - 1
    torch.cuda.synchronize()
    for _, counters in ops.workspaces.values():
        assert int(torch.count_nonzero(counters)) == 0


# ------------------------------------------------- packed mode's leaf scoring
def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _leaf_case(device, metric, B, b, L, cap, D, seed=0, median=250, offset=False):
    """Leaves as ``BatchedSearcher`` holds them: unit rows near one common
    direction (dots about 0.8, as the benchmark's collection), ragged
    prefixes (leaf 0 full, leaf 1 empty, the rest around ``median`` rows),
    zero padding.  Each query takes b distinct leaves, leaf 0 first (a leaf
    every query chose); a few slots invalid.  ``offset`` puts the block 4
    bytes past an aligned address (the kernel's 4-byte copies)."""
    g = torch.Generator(device=device).manual_seed(seed)
    mu = _unit(torch.randn(D, device=device, generator=g))
    n_rows = torch.exp(torch.randn(L, device=device, generator=g) * 0.6) * median
    n_rows = n_rows.clamp(1, cap).to(torch.int32)
    n_rows[0] = cap
    n_rows[1:2] = 0
    store = torch.empty(L * cap * D + int(offset), device=device)
    emb = store[int(offset):].view(L, cap, D)
    emb.copy_(_unit(2 * mu + torch.randn(L, cap, D, device=device, generator=g) / D ** 0.5))
    emb *= (torch.arange(cap, device=device)[None, :] < n_rows[:, None])[..., None]
    q = _unit(2 * mu + torch.randn(B, D, device=device, generator=g) / D ** 0.5)
    leaf_c = torch.argsort(torch.rand(B, L - 1, device=device, generator=g), dim=1)[:, : b - 1] + 1
    leaf_c = torch.cat([torch.zeros(B, 1, dtype=torch.long, device=device), leaf_c], dim=1)
    lvalid = torch.ones(B, b, dtype=torch.bool, device=device)
    lvalid[1:4, -max(1, b // 6):] = False
    q_sq = torch.sum(q * q, dim=-1) if metric == "l2" else None
    sq = torch.sum(emb * emb, dim=-1) if metric == "l2" else None
    return q, q_sq, emb, sq, n_rows, leaf_c, lvalid


def _real(args):
    """Each valid slot's real rows: the only entries the kernel writes."""
    emb, n_rows, leaf_c, lvalid = args[2], args[4], args[5], args[6]
    return (torch.arange(emb.shape[1], device=emb.device) < n_rows[leaf_c][..., None]) & lvalid[..., None]


def _against_plain(args, metric, atol):
    """The kernel against its plain version on each valid slot's real rows;
    returns them."""
    ld.reset_launches()
    got = ld.leaf_distances(*args, metric)
    assert ld.launches["leaf_distances"] == 1
    want = ld.leaf_distances_ref(*args, metric)
    assert got.shape == want.shape and got.dtype == torch.float32
    real = _real(args)
    assert bool(torch.isfinite(got[real]).all())
    err = float((got[real] - want[real]).abs().max()) if bool(real.any()) else 0.0
    assert err <= atol, (metric, err)
    return got[real]


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_leaf_distances_at_the_main_paths_shape_is_the_plain_version(card, metric):
    """B = 128 queries, b = 64 leaves each, leaves padded to 5248 rows of
    1152 (median 250): each valid slot's real rows within 1e-5 of the plain
    version (float32 sums in another order over 1152 terms); a second
    launch is bit-identical there."""
    args = _leaf_case(card, metric, B=128, b=64, L=96, cap=5248, D=1152)
    got = _against_plain(args, metric, 1e-5)
    assert torch.equal(ld.leaf_distances(*args, metric)[_real(args)], got)


@pytest.mark.parametrize(
    "B,b,L,cap,D,offset",
    [
        (5, 3, 7, 40, 18, False),     # D not a multiple of 4: 4-byte copies
        (5, 3, 7, 40, 20, False),     # a K-slice past D
        (33, 9, 12, 300, 64, False),  # 33 pairs on leaf 0: two query groups
        (3, 2, 4, 129, 1152, True),   # a block 4 bytes off alignment; 129 rows: two tiles
        (1, 1, 1, 8, 8, False),
    ],
)
def test_leaf_distances_edges(card, B, b, L, cap, D, offset):
    for metric in ("l2", "ip", "cosine"):
        _against_plain(_leaf_case(card, metric, B, b, L, cap, D, median=cap // 3, offset=offset), metric, 1e-5)


def test_packed_search_on_the_card_is_the_cpu_searchers_and_launches_once_a_chunk(card, tmp_path):
    """A packed search and two ``next`` on the card return the CPU
    searcher's ids (distances within 1e-5), under each metric; the leaf
    kernel launches once for each scan chunk (``ecpfs.packed.score`` span)
    and the merge kernel once for each merge (``ecpfs.packed.merge``)."""
    from repro_torch import tracing
    from repro_torch.core import BatchedSearcher, ECPBuildConfig, build_index, load_packed

    rng = np.random.default_rng(11)
    data = rng.standard_normal((3000, 48)).astype(np.float32)
    Q = rng.standard_normal((20, 48)).astype(np.float32)
    for metric in ("l2", "ip", "cosine"):
        path = str(tmp_path / metric)
        build_index(data, path, ECPBuildConfig(levels=2, metric=metric, cluster_cap=40), device="cpu")
        packed = load_packed(path)
        on_card, on_cpu = BatchedSearcher(packed, device="cuda"), BatchedSearcher(packed, device="cpu")
        ld.reset_launches()
        lm.reset_launches()
        tracing.reset()
        with tracing.on():
            a = on_card.search(Q, 50, b=1)
            nexts = [a.query.next(50) for _ in range(2)]
        spans = tracing.snapshot()["spans"]
        chunks, merges = spans["ecpfs.packed.score"]["count"], spans["ecpfs.packed.merge"]["count"]
        tracing.reset()
        assert chunks >= 3 and ld.launches["leaf_distances"] == chunks
        assert merges == chunks and lm.launches["leaf_merge"] == merges
        c = on_cpu.search(Q, 50, b=1)
        for x, y in [(a, c)] + list(zip(nexts, [c.query.next(50) for _ in range(2)])):
            assert np.array_equal(x.ids, y.ids), metric
            np.testing.assert_allclose(x.dists, y.dists, rtol=1e-5, atol=1e-5)


# ------------------------------------------- packed search's CUDA graphs
@pytest.fixture(scope="module")
def graph_index(tmp_path_factory):
    """metric -> the packed index of one collection (3000 x 48, leaves of
    up to 40 rows), built on the CPU; and 40 queries."""
    from repro_torch.core import ECPBuildConfig, build_index, load_packed

    rng = np.random.default_rng(12)
    data = rng.standard_normal((3000, 48)).astype(np.float32)
    Q = rng.standard_normal((40, 48)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("graphs")
    out = {}
    for metric in ("l2", "ip", "cosine"):
        build_index(data, str(tmp / metric), ECPBuildConfig(levels=2, metric=metric, cluster_cap=40), device="cpu")
        out[metric] = load_packed(str(tmp / metric))
    return out, Q


def _page(p):
    """(ids [rows, k], dists [rows, k], leaves opened a row) of a page."""
    stats = p.stats if isinstance(p.stats, list) else [p.stats]
    return np.atleast_2d(p.ids), np.atleast_2d(p.dists), [s.leaves_opened for s in stats]


def _pages(rs, n_next, k):
    """``_page`` of a search and of its ``n_next`` pages."""
    return [_page(p) for p in [rs] + [rs.query.next(k) for _ in range(n_next)]]


def _same(a, b):
    assert len(a) == len(b)
    for (ia, da, la), (ib, db, lb) in zip(a, b):
        assert np.array_equal(ia, ib) and np.array_equal(da, db) and la == lb


def _traced(fn):
    from repro_torch import tracing

    tracing.reset()
    with tracing.on():
        out = fn()
    snap = tracing.snapshot()
    tracing.reset()
    return out, snap


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("b", [2, 1])
def test_a_replayed_search_is_the_first_eager_one_bit_for_bit(card, graph_index, metric, b):
    """A shape runs eagerly at its first search, is captured at its second
    and replayed from then on: each search and two ``next`` are the eager
    ones bit for bit, and the CPU searcher's ids.  At b = 1 a page takes
    several chunks, so ``_advance`` replays the chunk graphs on the state
    it copies in."""
    from repro_torch.core import BatchedSearcher

    packed, Q = graph_index
    s = BatchedSearcher(packed[metric], device="cuda")
    eager, snap0 = _traced(lambda: _pages(s.search(Q, 50, b=b), 2, 50))
    assert not s._graphs and "ecpfs.packed.graph_replays" not in snap0["counters"]
    for i in range(2):
        replayed, snap = _traced(lambda: _pages(s.search(Q, 50, b=b), 2, 50))
        _same(eager, replayed)
        c = snap["counters"]
        assert c.get("ecpfs.packed.graph_captures", 0) == (1 if i == 0 else 0)
        chunks = snap["spans"]["ecpfs.packed.score"]["count"]
        assert c["ecpfs.packed.graph_replays"] == chunks == snap0["spans"]["ecpfs.packed.score"]["count"]
        if b == 1:
            assert chunks >= 4, "the search and its pages scan several chunks"
    assert len(s._graphs) == 1
    cpu = _pages(BatchedSearcher(packed[metric], device="cpu").search(Q, 50, b=b), 2, 50)
    for (ia, da, la), (ib, db, lb) in zip(eager, cpu):
        assert np.array_equal(ia, ib) and la == lb, metric
        np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-5)


def test_interleaved_sessions_equal_the_same_calls_alone(card, graph_index):
    """Search A, search B, next A, next B on one searcher's graphs: each
    session's pages are those of its calls run alone, so a session keeps
    its own state and a ``next`` that scans copies its own in."""
    from repro_torch.core import BatchedSearcher

    packed, Q = graph_index
    s = BatchedSearcher(packed["cosine"], device="cuda")
    qa, qb = Q[:20], Q[20:]
    for _ in range(2):
        s.search(qa, 50, b=1)  # eager, then captured
    alone = [_pages(s.search(q, 50, b=1), 2, 50) for q in (qa, qb)]
    a, b = s.search(qa, 50, b=1), s.search(qb, 50, b=1)
    got = [[_page(a)], [_page(b)]]
    for _ in range(2):
        for r, g in zip((a, b), got):
            g.append(_page(r.query.next(50)))
    _same(alone[0], got[0])
    _same(alone[1], got[1])
    assert len(s._graphs) == 1


def test_threads_sharing_one_searchers_graphs_match_the_calls_alone(card, graph_index):
    """More threads than cores search and page through one searcher's
    graphs at once, on the default stream they share, the interpreter
    switching often: every page is that of the same calls run alone."""
    from repro_torch.core import BatchedSearcher

    packed, Q = graph_index
    s = BatchedSearcher(packed["l2"], device="cuda")
    n = (os.cpu_count() or 4) + 2
    parts = [Q[(4 * t) % 40:(4 * t) % 40 + 4] for t in range(n)]
    for _ in range(2):
        s.search(parts[0], 50, b=1)
    alone = [_pages(s.search(q, 50, b=1), 2, 50) for q in parts]
    torch.cuda.synchronize()
    got, errors = {}, []

    def worker(t):
        try:
            got[t] = [_pages(s.search(parts[t], 50, b=1), 2, 50) for _ in range(5)]
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for t in range(n):
        for pages in got[t]:
            _same(alone[t], pages)
    assert len(s._graphs) == 1


def test_each_shape_captures_once_and_launches_equal_the_spans(card, graph_index):
    """A second shape captures once, at its second search in a row; past
    ``GRAPH_SHAPES`` shapes a search stays eager.  Each kernel's launches
    equal the ``score`` and ``merge`` spans, replayed or not, and the
    replays equal the chunks that replayed."""
    from repro_torch.core import BatchedSearcher, batched

    packed, Q = graph_index
    s = BatchedSearcher(packed["ip"], device="cuda")
    shapes = [(Q[:n], b) for n, b in ((1, 2), (40, 1), (17, 1), (40, 3), (5, 1))]
    assert len(shapes) > batched.GRAPH_SHAPES
    eager = None
    for i, (q, b) in enumerate(shapes):
        for n in range(3):
            ld.reset_launches()
            lm.reset_launches()
            pages, snap = _traced(lambda: _pages(s.search(q, 30, b=b), 1, 30))
            eager = pages if i == n == 0 else eager
            chunks, merges = snap["spans"]["ecpfs.packed.score"]["count"], snap["spans"]["ecpfs.packed.merge"]["count"]
            c = snap["counters"]
            assert ld.launches["leaf_distances"] == chunks and lm.launches["leaf_merge"] == merges == chunks
            kept = i < batched.GRAPH_SHAPES
            assert c.get("ecpfs.packed.graph_captures", 0) == (1 if kept and n == 1 else 0), (i, n)
            assert c.get("ecpfs.packed.graph_replays", 0) == (chunks if kept and n > 0 else 0), (i, n)
        assert len(s._graphs) == min(i + 1, batched.GRAPH_SHAPES)
    # a single query ([D]) is the shape B = 1, captured above as Q[:1]: it
    # replays, and its pages are the first, eager search's
    replays = _traced(lambda: _pages(s.search(Q[0], 30, b=2), 1, 30))[1]["counters"]["ecpfs.packed.graph_replays"]
    assert replays > 0
    _same(_pages(s.search(Q[0], 30, b=2), 1, 30), eager)


def test_shapes_that_alternate_stay_eager(card, graph_index):
    """A shape is captured only when it follows a search of its own shape:
    two shapes searched in turn capture nothing, and a run of one captures
    it at its second search."""
    from repro_torch.core import BatchedSearcher

    packed, Q = graph_index
    s = BatchedSearcher(packed["l2"], device="cuda")
    for _ in range(3):
        s.search(Q[:8], 20, b=2)
        s.search(Q[:9], 20, b=2)
    assert not s._graphs
    s.search(Q[:9], 20, b=2)
    assert list(s._graphs) == [(9, 2, 8, 256)]


def _kernel_records(fn, names):
    """{name: kernel records whose name holds it} of one call of ``fn``
    under torch.profiler with CUDA activity, the call 50 ms inside the
    trace at both ends."""
    import time

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    ks = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {n: sum(n in k for k in ks) for n in names}


def test_the_profiler_sees_each_replayed_chunk_run_each_kernel_once(card, graph_index):
    """Independent of the counters: the profiler's kernel records of a
    replayed search and two pages hold each packed kernel once a chunk,
    as many as the eager search's.  A dropped record can only hide a
    launch: no trace may show more, and one of eight must show them all."""
    from repro_torch.core import BatchedSearcher

    packed, Q = graph_index
    s = BatchedSearcher(packed["cosine"], device="cuda")
    names = ("leaf_distances_kernel", "leaf_merge_kernel")
    _, snap = _traced(lambda: _pages(s.search(Q, 50, b=1), 2, 50))  # eager
    chunks = snap["spans"]["ecpfs.packed.score"]["count"]
    assert chunks >= 4
    s.search(Q, 50, b=1)  # captured
    seen = []
    for _ in range(8):
        got = _kernel_records(lambda: _pages(s.search(Q, 50, b=1), 2, 50), names)
        seen.append(got)
        assert all(v <= chunks for v in got.values()), (chunks, seen)
        if all(v == chunks for v in got.values()):
            break
    assert all(v == chunks for v in seen[-1].values()), (chunks, seen)
    assert len(s._graphs) == 1


# ------------------------------------------------------- packed mode's merge
def _signed_zeros(shape, g):
    """-0.0 and +0.0, a 0.5 now and then."""
    zeros = torch.where(torch.rand(shape, generator=g) < 0.5, -0.0, 0.0)
    return torch.where(torch.rand(shape, generator=g) < 0.3, 0.5, zeros)


def _merge_case(kind, C, B, b, L, cap, seed=0):
    """A scan chunk as ``_scan_chunk`` hands it to the merge, on the CPU:
    ragged leaves (leaf 0 empty, leaf 1 full), unique item ids, NaN and
    -inf past each leaf's rows and in the slots left out, a repeated leaf,
    invalid slots and an exhausted tail (query 1); a sorted buffer, finite
    for a share of C, then (+inf, -1).  ``kind``: "random" distances,
    "ties" (a grid of five values), "same" (one value everywhere, buffer
    included), "zeros" (-0.0 and +0.0 tied, as ip gives, and 0.5)."""
    g = torch.Generator().manual_seed(seed)
    n_rows = torch.randint(0, cap + 1, (L,), generator=g, dtype=torch.int32)
    n_rows[0], n_rows[1] = 0, cap
    leaf_ids = torch.randperm(L * cap, generator=g).view(L, cap).long()
    leaf_c = torch.randint(0, L, (B, b), generator=g)
    leaf_c[:, 1 % b] = 1
    lvalid = torch.rand(B, b, generator=g) > 0.1
    if B > 1 and b > 2:
        lvalid[1, -2:] = False
        leaf_c[1, -2:] = leaf_c[1, -3]
    d = {"random": lambda: torch.rand(B, b, cap, generator=g),
         "ties": lambda: torch.randint(0, 5, (B, b, cap), generator=g).float() / 4,
         "same": lambda: torch.full((B, b, cap), 0.25),
         "zeros": lambda: _signed_zeros((B, b, cap), g)}[kind]()
    real = (torch.arange(cap) < n_rows[leaf_c][..., None]) & lvalid[..., None]
    junk = torch.tensor([float("nan"), -float("inf")])[torch.randint(0, 2, (B, b, cap), generator=g)]
    d = torch.where(real, d, junk)
    n_fin = torch.randint(0, C + 1, (B,), generator=g)
    n_fin[0] = 0
    grid = {"same": lambda: torch.full((B, C), 0.25), "zeros": lambda: _signed_zeros((B, C), g)}.get(
        kind, lambda: torch.randint(0, 5, (B, C), generator=g).float() / 4)()
    buf_d = torch.sort(torch.where(torch.arange(C)[None, :] < n_fin[:, None], grid, torch.inf), dim=-1,
                       stable=True).values
    buf_i = torch.where(torch.isfinite(buf_d), torch.randint(10**6, 2 * 10**6, (B, C), generator=g), -1)
    return buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid


def _merge_against_plain(args, card):
    """The kernel on the card against the plain version on CPU copies, bit
    for bit; a second launch identical.  Returns the kernel's output."""
    lm.reset_launches()
    on = [t.to(card) for t in args]
    got = lm.leaf_merge(*on)
    again = lm.leaf_merge(*on)
    assert lm.launches["leaf_merge"] == 2
    want = lm.leaf_merge_ref(*[t.cpu() for t in args])
    for x, y, z in zip(got, again, want):
        x, y = x.cpu(), y.cpu()
        assert x.shape == z.shape and x.dtype == z.dtype
        bits = (lambda t: t.view(torch.int32)) if x.dtype == torch.float32 else (lambda t: t)
        assert torch.equal(bits(x), bits(z)), "the kernel differs from the plain version"
        assert torch.equal(bits(x), bits(y)), "two launches differ"
    return got


def test_leaf_merge_at_the_main_paths_shape_is_the_plain_version(card):
    """B = 128 queries, b = 64 leaves padded to 5248 rows of 1152 (median
    250), C = 400: the leaf kernel's chunk merged into an empty buffer, and
    a second chunk into that result, bit for bit the plain version's."""
    args = _leaf_case(card, "cosine", B=128, b=64, L=96, cap=5248, D=1152)
    n_rows = args[4]
    g = torch.Generator().manual_seed(3)
    leaf_ids = torch.randperm(96 * 5248, generator=g).view(96, 5248).long().to(card)
    d = ld.leaf_distances(*args, "cosine")
    C = 400
    buf = (torch.full((128, C), torch.inf, device=card), torch.full((128, C), -1, dtype=torch.long, device=card))
    buf = _merge_against_plain((*buf, d, leaf_ids, n_rows, args[5], args[6]), card)
    assert bool(torch.isfinite(buf[0]).all())
    leaf_c = torch.roll(args[5], 7, dims=1).contiguous()
    d2 = ld.leaf_distances(args[0], None, args[2], None, n_rows, leaf_c, args[6], "cosine")
    _merge_against_plain((*buf, d2, leaf_ids, n_rows, leaf_c, args[6]), card)


@pytest.mark.parametrize("C", [256, 400, 4096])
@pytest.mark.parametrize("kind", ["random", "ties", "same"])
def test_leaf_merge_edges(card, kind, C):
    """Heavy ties (the radix passes run into the positions), invalid and
    exhausted slots, empty and full leaves; many candidates (radix passes)
    and fewer than C finite ones (no pass)."""
    for B, b, L, cap in ((16, 64, 40, 700), (5, 3, 6, 9), (1, 1, 2, 1)):
        _merge_against_plain(_merge_case(kind, C, B, b, L, cap, seed=C), card)


def test_leaf_merge_signed_zeros_under_ip(card):
    """-0.0 ties with +0.0 in position order, and each keeps its sign, as
    the plain version on the CPU; many rows and few."""
    for B, b, L, cap, C in ((8, 64, 40, 700, 400), (4, 5, 6, 30, 256)):
        out = _merge_against_plain(_merge_case("zeros", C, B, b, L, cap, seed=1), card)
        z = out[0][out[0] == 0]
        assert bool(torch.signbit(z).any()) and bool((~torch.signbit(z)).any())


def test_leaf_merge_beyond_shared_memory(card):
    """C past the shared-memory sort area (its keys in global scratch), and
    b past the slots kept in shared memory."""
    assert lm.sort_keys(20000) > lm.SORT_SMEM
    _merge_against_plain(_merge_case("ties", 20000, 4, 64, 40, 1200, seed=2), card)
    _merge_against_plain(_merge_case("random", 20000, 3, 4, 6, 50, seed=3), card)
    assert lm.SLOTS_SMEM < 8200
    _merge_against_plain(_merge_case("ties", 400, 3, 8200, 50, 4, seed=4), card)
