"""The two recall knobs through the port (the twins of
``tests/test_recall_knobs.py``): multi-probe traversal (``probe_m``) and
build-time spill replication (``spill_s``) keep every engine of the port
bit-identical to its legacy oracle and to the reference, spill never emits
a duplicate id (across saves, across packages), ``b`` stays at its base
across doubling and save/load, and the ``frontier/recall/*`` rows of
``BENCH_search.json`` come out of the port with the same recall,
``bytes_read`` and ``reads_issued``.  The indexes are the reference's
builds; the quantized kernel takes its plain version (``device="cpu"``)."""
import json
import pathlib

import numpy as np
import pytest

from benchmarks.recall import GRID, _build_suite, _exact_topk
from repro.core import ECPBuildConfig as RefCfg
from repro.core import build_index as ref_build
from repro.core import convert as ref_convert
from repro.core import open_index as ref_open
from repro.data import clustered_vectors
from repro_torch.core import ECPBuildConfig, build_index, open_index
from repro_torch.core.distances import np_distances

N, DIM = 5000, 24
BACKENDS = ("fstore", "blob")
BENCH = pathlib.Path(__file__).resolve().parents[1] / "BENCH_search.json"


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    data, _ = clustered_vectors(0, n=N, dim=DIM, n_clusters=48)
    root = tmp_path_factory.mktemp("knobs")
    paths = {}
    for s in (0, 1, 2):
        p = str(root / f"ecp_s{s}")
        ref_build(data, p, RefCfg(levels=2, metric="l2", cluster_cap=64, seed=0, spill_s=s))
        paths[("fstore", s)] = p
        paths[("blob", s)] = str(ref_convert(p, root / f"ecp_s{s}.blob"))
    rng = np.random.default_rng(7)
    queries = (data[rng.integers(0, N, 12)] + 0.05 * rng.normal(size=(12, DIM)).astype(np.float32)).astype(
        np.float32
    )
    return data, paths, queries


def _open(paths, backend, spill=0, **kw):
    return open_index(paths[(backend, spill)], mode="file", backend=backend, device="cpu", **kw)


def _ref(paths, backend, spill=0, **kw):
    return ref_open(paths[(backend, spill)], mode="file", backend=backend, **kw)


def _same(a, b, msg=""):
    np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"{msg}: ids")
    np.testing.assert_array_equal(a.dists, b.dists, err_msg=f"{msg}: dists")


# --------------------------------------------------------- probe_m parity
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m", (1, 2, 3))
def test_engines_bit_identical_at_any_probe_m(built, backend, m):
    _, paths, queries = built
    flat, leg = _open(paths, backend), _open(paths, backend, engine="legacy")
    rleg = _ref(paths, backend, engine="legacy")
    rb = flat.search(queries, k=20, b=4, probe_m=m)
    for r, q in enumerate(queries):
        rl = leg.search(q, k=20, b=4, probe_m=m)
        _same(rl, rleg.search(q, k=20, b=4, probe_m=m), f"legacy vs reference m={m} row {r}")
        np.testing.assert_array_equal(flat.search(q, k=20, b=4, probe_m=m).ids, rl.ids)
        np.testing.assert_array_equal(rb.ids[r], rl.ids, err_msg=f"batch m={m} row {r}")
        np.testing.assert_array_equal(rb.dists[r], rl.dists, err_msg=f"batch m={m} row {r}")


def test_quantized_engine_bit_identical_at_probe_m(built):
    _, paths, queries = built
    qblob = str(pathlib.Path(paths[("blob", 0)]).parent / "ecp_s0.port.qblob")
    ref_convert(paths[("fstore", 0)], qblob, quant="int8")
    quant = open_index(qblob, mode="file", backend="blob", quantized=True, device="cpu")
    leg = _open(paths, "blob", engine="legacy")
    for m in (1, 2):
        rq = quant.search(queries, k=20, b=4, probe_m=m)
        for r, q in enumerate(queries):
            np.testing.assert_array_equal(rq.ids[r], leg.search(q, k=20, b=4, probe_m=m).ids)
    quant.close()
    leg.close()


def test_probe_m_default_flows_from_open_index(built):
    _, paths, queries = built
    wide, narrow = _open(paths, "blob", probe_m=2), _open(paths, "blob")
    q = queries[0]
    _same(wide.search(q, k=20, b=4), narrow.search(q, k=20, b=4, probe_m=2), "default")
    _same(wide.search(q, k=20, b=4, probe_m=1), narrow.search(q, k=20, b=4), "override")


@pytest.mark.parametrize("backend", BACKENDS)
def test_probe_m_continuation_and_save_load(built, backend):
    """next(k) at probe_m=2, with a save/load mid-stream on the fstore (the
    port saves, the reference resumes), stays the uninterrupted legacy
    stream."""
    _, paths, queries = built
    rf = _open(paths, backend).search(queries[1], k=10, b=4, probe_m=2)
    rl = _open(paths, backend, engine="legacy").search(queries[1], k=10, b=4, probe_m=2)
    _same(rf, rl, backend)
    if backend == "fstore":
        rf.query.save("knob_q")
        qf = _ref(paths, backend).load_query("knob_q")
        assert qf.state.probe_m == 2
    else:
        qf = rf.query
    for i in range(3):
        _same(qf.next(15), rl.query.next(15), f"{backend} next#{i}")


# ----------------------------------------------------------- spill parity
@pytest.mark.parametrize("backend", BACKENDS)
def test_spill_engines_agree_and_never_duplicate(built, backend):
    _, paths, queries = built
    rb = _open(paths, backend, spill=1).search(queries, k=20, b=4)
    leg = _open(paths, backend, spill=1, engine="legacy")
    _same(rb, _ref(paths, backend, spill=1).search(queries, k=20, b=4), "vs reference")
    for r, q in enumerate(queries):
        np.testing.assert_array_equal(rb.ids[r], leg.search(q, k=20, b=4).ids, err_msg=f"spill row {r}")
        live = [int(x) for x in rb.ids[r] if x >= 0]
        assert len(live) == len(set(live)), f"duplicate id emitted, row {r}"


@pytest.mark.parametrize("engine", ["flat", "legacy"])
@pytest.mark.parametrize("saver,loader", [("port", "port"), ("port", "ref"), ("ref", "port")])
def test_spill_next_k_never_duplicates_across_saves_and_packages(built, engine, saver, loader):
    """No id repeats across the whole stream, through a mid-stream save in
    one package and load in the other: the seen-set travels as
    ``seen_ids``."""
    _, paths, queries = built
    make = {"port": _open, "ref": _ref}
    rs = make[saver](paths, "fstore", spill=2, engine=engine).search(queries[2], k=8, b=4)
    seen = [int(x) for x in rs.ids if x >= 0]
    rs.query.save(f"spill_{engine}_{saver}_{loader}")
    qh = make[loader](paths, "fstore", spill=2, engine=engine).load_query(f"spill_{engine}_{saver}_{loader}")
    stream = make["ref"](paths, "fstore", spill=2, engine=engine).search(queries[2], k=8, b=4)
    for _ in range(4):
        nxt = qh.next(8)
        _same(nxt, stream.query.next(8))
        seen += [int(x) for x in nxt.ids if x >= 0]
    assert len(seen) == len(set(seen))


def test_spill_build_matches_the_reference_and_mutates_cleanly(built, tmp_path):
    """The port's spill build writes the reference's leaves; deletes filter
    every replica, inserts and compact never emit a duplicate, and
    ``n_items`` stays the logical live count."""
    data, paths, queries = built
    path = str(tmp_path / "mut")
    build_index(data, path, ECPBuildConfig(levels=2, metric="l2", cluster_cap=64, seed=0, spill_s=1),
                device="cpu")
    ours, theirs = open_index(path, mode="file", device="cpu"), _ref(paths, "fstore", spill=1)
    _same(ours.search(queries, k=20, b=4), theirs.search(queries, k=20, b=4), "port build")
    assert ours.info.n_items == N
    rng = np.random.default_rng(5)
    newv = (data[rng.integers(0, N, 30)] + 0.02 * rng.normal(size=(30, DIM))).astype(np.float32)
    r = ours.insert(newv)
    assert r["inserted"] == 30 and ours.info.n_items == N + 30 and "spilled" in r
    ours.delete(np.arange(50, 90))
    live = [int(x) for x in ours.search(data[60], k=30, b=16).ids if x >= 0]
    assert not (set(live) & set(range(50, 90))) and len(live) == len(set(live))
    c = ours.compact()
    assert c["live"] == N + 30 - 40 == ours.info.n_items and ours.info.spill_s == 1
    live = [int(x) for x in ours.search(queries[0], k=20, b=8).ids if x >= 0]
    assert len(live) == len(set(live))


# ---------------------------------------------------------------- recall
def test_recall_monotone_in_probe_m_and_spill(built):
    data, paths, queries = built
    exact = np.argsort(np_distances(queries, data, "l2"), axis=1, kind="stable")[:, :10]
    exact_sets = [set(map(int, row)) for row in exact]

    def recall(spill, m):
        res = _open(paths, "blob", spill=spill).search(queries, k=10, b=8, probe_m=m)
        hits = sum(len(exact_sets[r] & {int(x) for x in res.ids[r] if x >= 0}) for r in range(len(queries)))
        return hits / (len(queries) * 10)

    r1, r2, r4 = recall(0, 1), recall(0, 2), recall(0, 4)
    assert r1 <= r2 <= r4
    assert recall(1, 1) >= r1
    assert max(r2, r4, recall(1, 1), recall(2, 1)) > r1


def test_the_frontier_rows_of_bench_search_come_out_of_the_port(tmp_path):
    """``benchmarks/recall.py``'s suite (n=6000, dim=32, its seeds), built
    by the reference, swept through the port: recall@10, ``bytes_read``
    and ``reads_issued`` of the cold batch search equal the committed
    ``frontier/recall/*`` rows."""
    rows = {r["name"]: r for r in json.loads(BENCH.read_text())["scenarios"]
            if r["name"].startswith("frontier/recall/")}
    assert len(rows) == len(GRID)
    data, queries, blobs = _build_suite(str(tmp_path), n=6000, dim=32)
    exact_sets = [set(map(int, row)) for row in _exact_topk(data, queries, 10)]
    for b, m, s in GRID:
        want = rows[f"frontier/recall/b={b}/m={m}/s={s}"]
        with open_index(blobs[s], mode="file", backend="blob", device="cpu") as idx:
            io0 = idx.store.io.snapshot()
            res = idx.search(queries, 10, b=b, probe_m=m)
            io = idx.store.io.delta(io0)
        hits = sum(len(exact_sets[r] & {int(x) for x in res.ids[r] if x >= 0}) for r in range(len(queries)))
        recall = round(hits / (len(queries) * 10), 4)
        assert want["derived"].startswith(f"recall={recall};"), (b, m, s, recall, want["derived"])
        assert (io.bytes_read, io.reads_issued) == (want["io"]["bytes_read"], want["io"]["reads_issued"]), (b, m, s)


# ----------------------------------------------------- bugfix regressions
@pytest.mark.parametrize("engine", ["flat", "legacy"])
def test_query_b_pinned_across_doubling_and_save(built, engine):
    _, paths, queries = built
    rs = _open(paths, "fstore", engine=engine).search(queries[0], k=4000, b=2, mx_inc=5)
    assert rs.query.stats.increments > 0
    assert rs.query.b == 2
    rs.query.save(f"pinned_{engine}")
    assert _open(paths, "fstore", engine=engine).load_query(f"pinned_{engine}").b == 2
    assert _ref(paths, "fstore", engine=engine).load_query(f"pinned_{engine}").b == 2


def test_saved_query_after_doubling_continues_identically(built):
    _, paths, queries = built
    ra = _open(paths, "fstore").search(queries[3], k=200, b=2, mx_inc=3)
    want = [ra.query.next(50) for _ in range(2)]
    rb = _open(paths, "fstore").search(queries[3], k=200, b=2, mx_inc=3)
    rb.query.save("doubled_q")
    for loaded in (_open(paths, "fstore").load_query("doubled_q"), _ref(paths, "fstore").load_query("doubled_q")):
        for i, w in enumerate(want):
            _same(loaded.next(50), w, f"next#{i}")


def test_cosine_norm_cache_parity_and_hit(tmp_path):
    data, _ = clustered_vectors(0, n=2000, dim=16, n_clusters=24)
    path = str(tmp_path / "cos")
    ref_build(data, path, RefCfg(levels=2, metric="cosine", cluster_cap=64))
    idx = open_index(path, mode="file", device="cpu")
    leg = open_index(path, mode="file", engine="legacy", device="cpu")
    assert idx._norms is not None
    rs = idx.search(data[:6], k=10, b=6)
    assert len(idx._norms._d) > 0
    _same(rs, ref_open(path, mode="file").search(data[:6], k=10, b=6), "vs reference")
    for r in range(6):
        rl = leg.search(data[r], k=10, b=6)
        np.testing.assert_array_equal(rs.ids[r], rl.ids, err_msg=f"cosine row {r}")
        np.testing.assert_array_equal(rs.dists[r], rl.dists, err_msg=f"cosine row {r}")
