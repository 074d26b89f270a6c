"""The port's baselines (``repro_torch.core.baselines``) against the JAX
package's (the twins of ``tests/test_baselines.py``): the same inputs, made
with numpy from a seed, go through both, ``device="cpu"``.

Host paths are held bit for bit: the k-means centroid update and its
reseeding, the IVF lists and their search, ``BruteForce``'s single query,
and both graphs (``HNSWLite``, ``VamanaLite``: adjacency and searches).
The device paths are plain PyTorch against plain jitted JAX: ``kmeans``'s
assignment (equal assignments, so equal centroids) and ``BruteForce``'s
batch block (ids equal, distances within ``RTOL``/``ATOL``, the float32
difference of ``torch_distances`` against ``jnp_distances``).  The last
test rebuilds the ``table3/eCP-FS`` and ``table3/IVF`` rows of
``BENCH_search.json`` from the port.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from benchmarks.mmir import make_dataset
from repro.core.baselines import BruteForce as RefBruteForce
from repro.core.baselines import HNSWLite as RefHNSW
from repro.core.baselines import IVFIndex as RefIVF
from repro.core.baselines import VamanaLite as RefVamana
from repro.core.baselines import kmeans as ref_kmeans
from repro.data import clustered_vectors
from repro_torch.core import ECPBuildConfig, QueryClosedError, RestartQuery, build_index, open_index
from repro_torch.core.baselines import BruteForce, HNSWLite, IVFIndex, VamanaLite, kmeans

RTOL, ATOL = 1e-5, 1e-5
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dataset():
    data, _ = clustered_vectors(1, n=3000, dim=24, n_clusters=32)
    bf = BruteForce(data, device="cpu")
    rng = np.random.default_rng(2)
    qs = data[rng.integers(0, len(data), 15)] + 0.005 * rng.normal(size=(15, 24)).astype(np.float32)
    gt = [set(bf.search(q, 10).row_ids(0)) for q in qs]
    return data, qs, gt


@pytest.fixture(scope="module")
def graphs(dataset):
    """Both packages' graphs at the reference test's size and settings,
    built once for the module (the Vamana builds take most of its time)."""
    data, _, _ = dataset
    return {
        "hnsw": (HNSWLite(data, M=12, ef_construction=48), RefHNSW(data, M=12, ef_construction=48)),
        "vamana": (VamanaLite(data, R=16, L_build=48), RefVamana(data, R=16, L_build=48)),
    }


def _same(a, b, msg=""):
    np.testing.assert_array_equal(a.ids, np.asarray(b.ids), err_msg=f"{msg}: ids")
    np.testing.assert_array_equal(a.dists, np.asarray(b.dists), err_msg=f"{msg}: dists")


def _recall(searcher, qs, gt, *, b=None):
    rec = []
    for q, g in zip(qs, gt):
        ids = searcher.search(q, 10, b=b).row_ids(0)
        rec.append(len(g & set(ids)) / 10)
    return float(np.mean(rec))


# ------------------------------------------------------------------- k-means
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_kmeans_matches_reference(dataset, metric):
    """The device assignment gives the reference's assignments, so the host
    update gives its centroids bit for bit, iteration after iteration."""
    data, _, _ = dataset
    cent, assign = kmeans(data, 16, iters=5, metric=metric, batch=1000, device="cpu")
    rcent, rassign = ref_kmeans(data, 16, iters=5, metric=metric, batch=1000)
    assert assign.dtype == np.int32 and cent.shape == (16, 24)
    np.testing.assert_array_equal(assign, np.asarray(rassign))
    np.testing.assert_array_equal(cent, np.asarray(rcent))
    if metric == "l2":  # the reference test's sanity: every cluster used
        assert (np.bincount(assign, minlength=16) > 0).sum() >= 12


def test_kmeans_reseeds_empty_clusters_as_reference():
    """A cluster that empties in the second iteration (no exact ties: the
    two packages break those differently, and the reference not even the
    same way across rows): eight points on a line, the rng's first draw
    seeding the centroids at 0, -1 and 9.  The centroid from 0 moves to 2,
    after which 0 is nearer -0.8 and 4 nearer 5.775, so it is reseeded
    from the same rng stream in the same order as the reference's."""
    seed = 3
    first = np.random.default_rng(seed).choice(8, size=3, replace=False)
    vals = np.empty(8)
    vals[first] = [0.0, -1.0, 9.0]
    vals[[i for i in range(8) if i not in first]] = [-0.6, 4.0, 4.6, 4.7, 4.8]
    data = np.zeros((8, 4), np.float32)
    data[:, 0] = vals
    timings = {}
    for iters in (1, 2, 4):
        cent, assign = kmeans(data, 3, iters=iters, seed=seed, device="cpu", timings=timings)
        rcent, rassign = ref_kmeans(data, 3, iters=iters, seed=seed)
        np.testing.assert_array_equal(assign, np.asarray(rassign))
        np.testing.assert_array_equal(cent, np.asarray(rcent))
        if iters == 2:  # the emptied centroid is a data point again
            assert 0 not in assign and (data == cent[0]).all(axis=1).any()
    assert timings["assign_s"] > 0 and timings["update_s"] > 0


# ----------------------------------------------------------------------- IVF
def test_ivf_lists_and_search_match_reference(dataset):
    data, qs, gt = dataset
    ivf = IVFIndex(data, n_lists=32, train_iters=5, device="cpu")
    ref = RefIVF(data, n_lists=32, train_iters=5)
    np.testing.assert_array_equal(ivf.centroids, ref.centroids)
    assert len(ivf.lists) == len(ref.lists) == 32
    for a, b in zip(ivf.lists, ref.lists):
        np.testing.assert_array_equal(a, b)
    for b in (None, 1, 4, 8, 32):
        _same(ivf.search(qs, 10, b=b), ref.search(qs, 10, b=b), f"batch b={b}")
        _same(ivf.search(qs[3], 10, b=b), ref.search(qs[3], 10, b=b), f"single b={b}")
    assert _recall(ivf, qs, gt, b=8) >= 0.8


def test_restart_query_matches_tail(dataset):
    """Baseline continuation == the tail of one bigger search (Table 4),
    and equal to the reference's continuation."""
    data, qs, _ = dataset
    ivf = IVFIndex(data, n_lists=32, train_iters=5, device="cpu")
    ref = RefIVF(data, n_lists=32, train_iters=5)
    rs, rrs = ivf.search(qs[0], 10, b=8), ref.search(qs[0], 10, b=8)
    assert isinstance(rs.query, RestartQuery)
    more = rs.query.next(10)
    _same(more, rrs.query.next(10), "next(10)")
    big = ivf.search(qs[0], 20, b=8)
    np.testing.assert_array_equal(np.concatenate([rs.ids, more.ids]), big.ids)
    # a batch continuation, past the candidates of one list (padded)
    brs, rbrs = ivf.search(qs[:4], 10, b=1), ref.search(qs[:4], 10, b=1)
    _same(brs.query.next(200), rbrs.query.next(200), "batch next(200)")
    rs.query.close()
    with pytest.raises(QueryClosedError):
        rs.query.next(5)


# --------------------------------------------------------------- brute force
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_bruteforce_matches_reference(dataset, metric):
    data, qs, _ = dataset
    bf, ref = BruteForce(data, metric, device="cpu"), RefBruteForce(data, metric)
    for r in range(4):  # single query: host numpy, bit for bit
        _same(bf.search(qs[r], 5), ref.search(qs[r], 5), f"single row {r}")
    rs, rrs = bf.search(qs, 50), ref.search(qs, 50)  # batch: the device block
    assert rs.ids.shape == (15, 50)
    np.testing.assert_array_equal(rs.ids, np.asarray(rrs.ids))
    np.testing.assert_allclose(rs.dists, np.asarray(rrs.dists), rtol=RTOL, atol=ATOL)
    for r in range(4):  # the reference test: batch ids are the single ones
        np.testing.assert_array_equal(bf.search(qs[:4], 5).ids[r], bf.search(qs[r], 5).ids)
    nxt = rs.query.next(10)
    np.testing.assert_array_equal(nxt.ids, bf.search(qs, 60).ids[:, 50:])


# ---------------------------------------------------------------- the graphs
@pytest.mark.parametrize("kind", ["hnsw", "vamana"])
def test_graph_equals_reference(graphs, dataset, kind):
    """Same rng order, same host arithmetic: the same graph, and searches
    bit-identical at every beam width, single and batch."""
    data, qs, gt = dataset
    g, ref = graphs[kind]
    if kind == "hnsw":
        np.testing.assert_array_equal(g.levels, ref.levels)
        assert (g.entry, g.max_level) == (ref.entry, ref.max_level)
        assert g.graph == ref.graph
    else:
        assert g.medoid == ref.medoid
        assert [list(map(int, n)) for n in g.nbrs] == [list(map(int, n)) for n in ref.nbrs]
    for b in (None, 10, 64):
        _same(g.search(qs, 10, b=b), ref.search(qs, 10, b=b), f"{kind} batch b={b}")
    _same(g.search(qs[1], 10, b=64), ref.search(qs[1], 10, b=64), f"{kind} single")
    assert _recall(g, qs, gt, b=64) >= 0.8
    _same(g.search(qs[2], 10, b=64).query.next(10), ref.search(qs[2], 10, b=64).query.next(10),
          f"{kind} next(10)")


# -------------------------------------------------------------------- table 3
def _table3(searcher, b, bf, tasks, k=100):
    solved, recalls = 0, []
    for t in tasks:
        ok = False
        for q in t.queries:
            ids = set(searcher.search(q, k, b=b).row_ids(0))
            gt = set(bf.search(q, k).row_ids(0))
            recalls.append(len(ids & gt) / k)
            ok = ok or (t.target in ids)
        solved += int(ok)
    return f"tasks={solved}/{len(tasks)};recall={round(float(np.mean(recalls)), 4)}"


def test_table3_rows_from_the_port(tmp_path):
    """``benchmarks/table3_tasks.py`` on the ``--fast`` suite
    (``benchmarks/indexes.py``: 6000 items, dim 32, 24 tasks; eCP-FS at
    cap 64, b=16; IVF 32 lists, 6 iterations, nprobe 16), every index
    built by the port: the eCP-FS and IVF rows of ``BENCH_search.json``.
    HNSW and DiskANN-lite are left out (their builds at 6000 items take
    minutes here); ``test_graph_equals_reference`` holds their graphs."""
    rows = {r["name"]: r["derived"] for r in json.loads((REPO / "BENCH_search.json").read_text())["scenarios"]}
    ds = make_dataset(n_items=6000, dim=32, n_tasks=24, seed=0)
    bf = BruteForce(ds.data, device="cpu")
    path = str(tmp_path / "ecp_index")
    build_index(ds.data, path, ECPBuildConfig(levels=2, metric="l2", cluster_cap=64), device="cpu")
    with open_index(path, mode="file", device="cpu") as ecp:
        assert _table3(ecp, 16, bf, ds.tasks) == rows["table3/eCP-FS"]
    ivf = IVFIndex(ds.data, n_lists=32, train_iters=6, device="cpu")
    assert _table3(ivf, 16, bf, ds.tasks) == rows["table3/IVF"]
