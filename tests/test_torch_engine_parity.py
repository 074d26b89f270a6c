"""The port's legacy engine (``core/legacy.py``) is the port's own parity
oracle (the twins of ``tests/test_engine_parity.py``): it is bit-identical
to the reference's legacy engine, and the port's flat engine is
bit-identical to it, single and batch, with excludes, continuation and
statistics, on both storage backends of index files the reference wrote.

Saved queries are files of the index (``Query.save`` into the fstore), so
they cross packages: a query saved by either package, by either engine,
fp or quantized, loads in the other and continues identically."""
import numpy as np
import pytest

from repro.core import ECPBuildConfig as RefCfg
from repro.core import build_index as ref_build
from repro.core import convert as ref_convert
from repro.core import open_index as ref_open
from repro.data import clustered_vectors
from repro_torch.core import LegacyQueryState, QueryState, open_index

N, DIM = 6000, 24
BACKENDS = ("fstore", "blob")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    data, _ = clustered_vectors(0, n=N, dim=DIM, n_clusters=48)
    root = tmp_path_factory.mktemp("parity")
    path = str(root / "ecp")
    ref_build(data, path, RefCfg(levels=2, metric="l2", cluster_cap=64, seed=0))
    blob = str(ref_convert(path, root / "ecp.blob"))
    rng = np.random.default_rng(7)
    queries = (data[rng.integers(0, N, 16)] + 0.01 * rng.normal(size=(16, DIM)).astype(np.float32)).astype(
        np.float32
    )
    return data, {"fstore": path, "blob": blob}, queries


def _open(paths, backend, **kw):
    return open_index(paths[backend], mode="file", backend=backend, device="cpu", **kw)


def _ref(paths, backend, **kw):
    return ref_open(paths[backend], mode="file", backend=backend, **kw)


def _same(a, b, msg=""):
    np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"{msg}: ids")
    np.testing.assert_array_equal(a.dists, b.dists, err_msg=f"{msg}: dists")


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_legacy_is_the_reference_legacy(built, backend):
    _, paths, queries = built
    ours = _open(paths, backend, engine="legacy")
    theirs = _ref(paths, backend, engine="legacy")
    for q in queries[:6]:
        a, b = ours.search(q, k=20, b=4), theirs.search(q, k=20, b=4)
        _same(a, b, backend)
        assert isinstance(a.query.state, LegacyQueryState)
        _same(a.query.next(15), b.query.next(15), f"{backend} next")
        sa, sb = a.query.stats, b.query.stats
        assert (sa.nodes_opened, sa.leaves_opened, sa.distance_calcs, sa.node_loads, sa.io.bytes_read) == (
            sb.nodes_opened, sb.leaves_opened, sb.distance_calcs, sb.node_loads, sb.io.bytes_read)
    rb = ours.search(queries[:4], k=10, b=4)
    _same(rb, theirs.search(queries[:4], k=10, b=4), "legacy batch")


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_query_bit_identical(built, backend):
    _, paths, queries = built
    flat, leg = _open(paths, backend), _open(paths, backend, engine="legacy")
    for q in queries[:8]:
        _same(flat.search(q, k=20, b=4), leg.search(q, k=20, b=4), backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_bit_identical_to_independent_rows(built, backend):
    _, paths, queries = built
    flat, leg = _open(paths, backend), _open(paths, backend, engine="legacy")
    rb = flat.search(queries, k=25, b=4)
    assert rb.batched and rb.ids.shape == (len(queries), 25)
    for r, q in enumerate(queries):
        rl = leg.search(q, k=25, b=4)
        np.testing.assert_array_equal(rb.ids[r], rl.ids, err_msg=f"{backend} row {r}")
        np.testing.assert_array_equal(rb.dists[r], rl.dists, err_msg=f"{backend} row {r}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_continuation_stream_bit_identical(built, backend):
    _, paths, queries = built
    rf = _open(paths, backend).search(queries[0], k=10, b=4)
    rl = _open(paths, backend, engine="legacy").search(queries[0], k=10, b=4)
    _same(rf, rl, backend)
    for i in range(4):
        _same(rf.query.next(15), rl.query.next(15), f"{backend} next#{i}")


def test_batch_continuation_bit_identical(built):
    _, paths, queries = built
    rb = _open(paths, "blob").search(queries, k=10, b=4)
    nb = rb.query.next(20)
    leg = _open(paths, "blob", engine="legacy")
    for r, q in enumerate(queries):
        nl = leg.search(q, k=10, b=4).query.next(20)
        np.testing.assert_array_equal(nb.ids[r], nl.ids, err_msg=f"row {r}")
        np.testing.assert_array_equal(nb.dists[r], nl.dists, err_msg=f"row {r}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_exclude_bit_identical(built, backend):
    _, paths, queries = built
    flat, leg = _open(paths, backend), _open(paths, backend, engine="legacy")
    q = queries[1]
    exclude = set(flat.search(q, k=20, b=2, mx_inc=0).row_ids(0))
    rf = flat.search(q, k=20, b=2, mx_inc=4, exclude=exclude)
    _same(rf, leg.search(q, k=20, b=2, mx_inc=4, exclude=exclude), backend)
    assert not (set(rf.row_ids(0)) & exclude)


def test_single_stats_parity(built):
    _, paths, queries = built
    sf = _open(paths, "fstore").search(queries[3], k=10, b=4).query.stats
    sl = _open(paths, "fstore", engine="legacy").search(queries[3], k=10, b=4).query.stats
    assert (sf.nodes_opened, sf.leaves_opened, sf.distance_calcs, sf.increments) == (
        sl.nodes_opened, sl.leaves_opened, sl.distance_calcs, sl.increments)


def test_exclude_mutation_between_increments_honored(built):
    _, paths, queries = built
    q = queries[5]
    rf = _open(paths, "blob").search(q, k=10, b=2, mx_inc=0)
    rl = _open(paths, "blob", engine="legacy").search(q, k=10, b=2, mx_inc=0)
    _same(rf, rl, "pre-mutation")
    poison = set(int(i) for i in rf.ids[5:8] if i >= 0)
    rf.query.state.exclude.update(poison)
    rl.query.state.exclude.update(poison)
    nf, nl = rf.query.next(15), rl.query.next(15)
    _same(nf, nl, "post-mutation")
    assert not (set(nf.row_ids(0)) & poison)


def test_legacy_engine_runs_the_prefetch_hints(built):
    _, paths, queries = built
    leg = _open(paths, "blob", engine="legacy", prefetch=True)
    _same(leg.search(queries[0], k=20, b=4), _ref(paths, "blob", engine="legacy").search(queries[0], k=20, b=4))
    leg.store.drain()
    assert leg.store.io.prefetch_issued > 0
    leg.close()


# ----------------------------------------------------------- persistence
OPENERS = {
    "port": lambda paths, **kw: _open(paths, "fstore", **kw),
    "ref": lambda paths, **kw: _ref(paths, "fstore", **kw),
}


@pytest.mark.parametrize("saver,loader", [("port", "ref"), ("ref", "port"), ("port", "port")])
@pytest.mark.parametrize("save_engine,load_engine", [("flat", "flat"), ("legacy", "legacy"), ("flat", "legacy")])
def test_saved_queries_cross_packages_and_engines(built, saver, loader, save_engine, load_engine):
    """Mid-traversal state saved by one package and engine resumes in the
    other bit-identically to the uninterrupted stream."""
    _, paths, queries = built
    src = OPENERS[saver](paths, engine=save_engine)
    rs = src.search(queries[2], k=10, b=4)
    rs.query.next(7)
    token = rs.query.save(name=f"{saver}_{save_engine}_to_{loader}_{load_engine}")
    resumed = OPENERS[loader](paths, engine=load_engine).load_query(token)
    want = OPENERS["port"](paths, engine="legacy").search(queries[2], k=10, b=4)
    want.query.next(7)
    for i in range(3):
        a = rs.query.next(12)
        b = resumed.next(12)
        _same(a, b, f"resumed next#{i}")
        _same(a, want.query.next(12), f"legacy stream next#{i}")
    if loader == "port":
        st = resumed.state
        assert isinstance(st, LegacyQueryState if load_engine == "legacy" else QueryState)
        assert (st.b, st.emitted) == (4, 10 + 7 + 3 * 12)


@pytest.mark.parametrize("saver", ["port", "ref"])
def test_saved_batch_crosses_packages(built, saver):
    _, paths, queries = built
    rb = OPENERS[saver](paths).search(queries[:4], k=8, b=4)
    token = rb.query.save()
    loader = "ref" if saver == "port" else "port"
    resumed = OPENERS[loader](paths).load_query(token)
    _same(rb.query.next(10), resumed.next(10))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("saver", ["port", "ref"])
def test_saved_quantized_query_continues_as_the_reference(tmp_path, metric, saver):
    """A quantized query is saved as a ``QueryState`` with its candidate
    buffer and no survivor state, as in the reference; restored in either
    package it continues as the reference's restored query does.  Under
    cosine (no bound prunes a row) that is the unsaved query's own
    continuation; under l2 it departs from it in both packages alike at
    the default rerank depth (ROADMAP Queue 3) and equals it at a depth
    that covers every emission."""
    data, _ = clustered_vectors(0, n=4000, dim=DIM, n_clusters=48)
    path = str(tmp_path / "ecp")
    ref_build(data, path, RefCfg(levels=2, metric=metric, cluster_cap=64, seed=0))
    rng = np.random.default_rng(7)
    Q = (data[rng.integers(0, len(data), 6)] + 0.05 * rng.normal(size=(6, DIM))).astype(np.float32)
    make = {
        "port": lambda **kw: open_index(path, mode="file", quantized=True, device="cpu", **kw),
        "ref": lambda **kw: ref_open(path, mode="file", quantized=True, **kw),
    }
    for depth in (None, 200):
        rs = make[saver](rerank_depth=depth).search(Q, 20, b=4)
        token = rs.query.save(name=f"{saver}_{depth}")
        unsaved = rs.query.next(50)
        ours = make["port"](rerank_depth=depth).load_query(token)
        theirs = make["ref"](rerank_depth=depth).load_query(token)
        assert type(ours.states[0]) is QueryState and ours.states[0].virtual_i is None
        a = ours.next(50)
        _same(a, theirs.next(50), f"{metric} depth={depth}: port vs reference restore")
        if metric == "cosine" or depth is not None:
            _same(a, unsaved, f"{metric} depth={depth}: restored vs unsaved")
            fp = open_index(path, mode="file", device="cpu").search(Q, 20, b=4).query.next(50)
            _same(a, fp, f"{metric} depth={depth}: restored vs fp engine")


def test_deep_quantized_continuation_orders_ties_as_the_reference(tmp_path):
    """A quantized ``next(k)`` past the candidates of earlier calls scans
    the leaves those calls read in full on the fp path, staged before the
    increment's quantized leaves; rows of different leaves at exactly equal
    float32 distances then leave in another order than the fp engine's.
    Both packages do it (ROADMAP Queue 3), so the port's unsaved query is
    the reference's bit for bit, equal to the fp engine up to the order of
    ties, while the same query saved and restored in a fresh index (no leaf
    read in full yet) is the fp engine's exactly."""
    from repro_torch.core import ECPIndex

    x, _ = clustered_vectors(0, n=60_008, dim=64)
    data, Q = x[:60_000], x[60_000:60_004]
    path = str(tmp_path / "ecp")
    ref_build(data, path, RefCfg(levels=2, metric="cosine", cluster_cap=455))
    ours = open_index(path, mode="file", quantized=True, device="cpu").search(Q, 100, b=64)
    theirs = ref_open(path, mode="file", quantized=True).search(Q, 100, b=64)
    token = ours.query.save("deep")
    fp = open_index(path, mode="file", device="cpu").search(Q, 100, b=64)
    restored = ECPIndex(path, quantized=True, device="cpu").load_query("deep")
    for h in (ours.query, theirs.query, fp.query, restored):
        h.next(100)
    deep = max(len(st.I) for st in restored.states) + 1
    a, b, f, r = (h.next(deep) for h in (ours.query, theirs.query, fp.query, restored))
    _same(a, b, "port vs reference, unsaved")
    _same(r, f, "restored vs fp engine")
    assert np.array_equal(a.dists, f.dists)
    swapped = np.flatnonzero(a.ids != f.ids)
    assert len(swapped) > 0  # the departure this test pins
    for row, j in zip(*np.nonzero(a.ids != f.ids)):
        run = np.flatnonzero(f.dists[row] == f.dists[row, j])
        assert a.ids[row, j] in f.ids[row, run]
