"""The port's file formats against the JAX package's: the index on disk is
the state the two share, so each opens what the other wrote, ``convert``
writes the same bytes, and the one-shot build writes the same files.

The build comparison runs the port's leaf assignment on the CPU
(``device="cpu"``).  Its data is drawn well apart from any leader-distance
tie (``_min_margin``), so float32 sums taken in another order cannot move
an item to another leaf; the check itself is byte equality.
"""
from pathlib import Path

import numpy as np
import pytest

from repro.core import ECPBuildConfig as RefCfg
from repro.core import build_index as ref_build
from repro.core import convert as ref_convert
from repro.core.quant import distance_bounds as ref_bounds
from repro.core.quant import encode_node as ref_encode
from repro.core.quant import reconstruction_radius as ref_radius
from repro.core.store import BlobStore as RefBlobStore
from repro.core.store import open_store as ref_open_store
from repro_torch.core import BlobStore, ECPBuildConfig, FStoreBackend, build_index, convert, open_store
from repro_torch.core.layout import IndexInfo, derive_shape
from repro_torch.core.quant import distance_bounds, encode_node, reconstruction_radius
from repro_torch.core.store import NodeNormCache

from repro.core.layout import derive_shape as ref_derive_shape

D = 16


def _data(n=1500, seed=0):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _keys(store):
    info = IndexInfo.from_attrs(store.read_attrs("info"))
    keys = [(0, 0)]
    for lv in range(1, info.levels + 1):
        keys += [(lv, j) for j in range(info.nodes_per_level[lv - 1])]
    return info, keys


def _dist64(x, c, metric):
    x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
    if metric == "ip":
        return -x @ c.T
    if metric == "l2":
        return (x * x).sum(1)[:, None] + (c * c).sum(1)[None] - 2 * x @ c.T
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    return 1 - xn @ (c / np.linalg.norm(c, axis=1, keepdims=True)).T


def _gap(d):
    """Relative gap between the best and the second-best of each row."""
    if d.shape[1] < 2:
        return np.full(len(d), np.inf)
    s = np.sort(d, axis=1)
    return (s[:, 1] - s[:, 0]) / np.maximum(1.0, np.abs(s[:, 0]))


def _min_margin(data, store, metric, seed=0):
    """The smallest relative gap between the chosen and the runner-up
    leader over every decision of a two-level build, in float64: each
    leaf leader's parent, and each item's beam-1 descent (root, then
    the chosen node's children)."""
    info = IndexInfo.from_attrs(store.read_attrs("info"))
    assert info.levels == 2
    lead = data[np.random.default_rng(seed).choice(len(data), info.n_leaders, replace=False)]
    n1 = info.nodes_per_level[0]
    gaps = [_gap(_dist64(lead, lead[:n1], metric))]
    d_root = _dist64(data, lead[:n1], metric)
    gaps.append(_gap(d_root))
    first = d_root.argmin(1)
    for j in range(n1):
        kids = store.get_node(1, j)[1].astype(np.int64)
        rows = np.flatnonzero(first == j)
        if len(rows) and len(kids):
            gaps.append(_gap(_dist64(data[rows], lead[kids], metric)))
    return float(min(g.min() for g in gaps))


@pytest.fixture(scope="module")
def ref_index(tmp_path_factory):
    """A reference-built fstore index and its v1 / v2 / v3 blobs."""
    d = tmp_path_factory.mktemp("ref")
    data = _data()
    ref_build(data, str(d / "fs"), RefCfg(levels=2, metric="l2", cluster_cap=48))
    blobs = {
        "v1": ref_convert(str(d / "fs"), d / "v1.blob", format=1),
        "v2": ref_convert(str(d / "fs"), d / "v2.blob"),
        "v3": ref_convert(str(d / "fs"), d / "v3.blob", quant="int8"),
        "v3f16": ref_convert(str(d / "fs"), d / "v3f16.blob", quant="float16"),
    }
    return d, data, blobs


@pytest.mark.parametrize("which", ["fs", "v1", "v2", "v3", "v3f16"])
def test_port_reads_reference_stores(ref_index, which):
    d, _, blobs = ref_index
    path = str(d / "fs") if which == "fs" else str(blobs[which])
    ours, theirs = open_store(path), ref_open_store(path)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.read_attrs("info") == theirs.read_attrs("info")
    info, keys = _keys(ours)
    assert _keys(theirs) == (info, keys)
    for (e1, i1), (e2, i2) in zip(ours.get_nodes(keys), theirs.get_nodes(keys)):
        assert e1.dtype == e2.dtype and np.array_equal(e1, e2) and np.array_equal(i1, i2)
    assert ours.node_rows(keys) == theirs.node_rows(keys)
    leaf = (info.levels, 1)
    rows = np.array([0, 2, 3])
    for a, b in zip(ours.get_node_rows(*leaf, rows), theirs.get_node_rows(*leaf, rows)):
        assert np.array_equal(a, b)
    if which.startswith("v3"):
        assert ours.quant_format == theirs.quant_format
        qf = ours.quant_format
        for q1, q2 in zip(ours.get_nodes_quantized(keys, qf), theirs.get_nodes_quantized(keys, qf)):
            assert np.array_equal(q1.codes, q2.codes) and q1.codes.dtype == q2.codes.dtype
            assert (q1.scale, q1.offset, q1.n_rows) == (q2.scale, q2.offset, q2.n_rows)
        q1, q2 = ours.get_quantized(*leaf, qf), theirs.get_quantized(*leaf, qf)
        assert np.array_equal(q1.codes, q2.codes)
    assert ours.io.bytes_read == theirs.io.bytes_read and ours.io.reads_issued == theirs.io.reads_issued


@pytest.mark.parametrize(
    "kw", [{"format": 1}, {}, {"quant": "int8"}, {"quant": "float16"}], ids=["v1", "v2", "v3-int8", "v3-f16"]
)
def test_convert_writes_the_reference_bytes_and_the_reference_opens_them(ref_index, tmp_path, kw):
    d, _, _ = ref_index
    ours = convert(str(d / "fs"), tmp_path / "port.blob", **kw)
    theirs = ref_convert(str(d / "fs"), tmp_path / "ref.blob", **kw)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    rb = RefBlobStore(ours)
    info, keys = _keys(rb)
    mine = BlobStore(ours)
    for (e1, i1), (e2, i2) in zip(rb.get_nodes(keys), mine.get_nodes(keys)):
        assert np.array_equal(e1, e2) and np.array_equal(i1, i2)


def test_v2_to_v3_upgrade_matches(ref_index, tmp_path):
    d, _, blobs = ref_index
    ours = convert(str(blobs["v2"]), tmp_path / "port.blob", quant="int8")
    theirs = ref_convert(str(blobs["v2"]), tmp_path / "ref.blob", quant="int8")
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()


@pytest.mark.parametrize("qformat", ["int8", "float16"])
@pytest.mark.parametrize("n", [0, 1, 37])
def test_encode_node_matches(qformat, n):
    emb = np.random.default_rng(n).normal(size=(n, 24)).astype(np.float16)
    a, b = encode_node(emb, qformat), ref_encode(emb, qformat)
    assert a.codes.dtype == b.codes.dtype and np.array_equal(a.codes, b.codes)
    assert (a.scale, a.offset, a.n_rows, a.qformat) == (b.scale, b.offset, b.n_rows, b.qformat)
    assert reconstruction_radius(a.scale, 24) == ref_radius(b.scale, 24)
    if n:
        q = np.random.default_rng(99).normal(size=24).astype(np.float32)
        for metric in ("l2", "ip", "cosine"):
            approx = np.random.default_rng(5).normal(size=n)
            qn = float(np.linalg.norm(q))
            lo1, hi1 = distance_bounds(approx, a.radius, metric, qn)
            lo2, hi2 = ref_bounds(approx, b.radius, metric, qn)
            assert np.array_equal(lo1, lo2) and np.array_equal(hi1, hi2)


@pytest.mark.parametrize("n,cap,levels", [(1500, 48, 2), (5000, 64, 3), (10, 4, 1)])
def test_derive_shape_matches(n, cap, levels):
    assert derive_shape(n, cap, levels) == ref_derive_shape(n, cap, levels)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("spill_s", [0, 1])
def test_build_writes_the_reference_files(tmp_path, metric, spill_s):
    data = _data()
    cfg = dict(levels=2, metric=metric, cluster_cap=48, spill_s=spill_s, insert_batch=512)
    ref_build(data, str(tmp_path / "ref"), RefCfg(**cfg))
    store = build_index(data, str(tmp_path / "port"), ECPBuildConfig(**cfg), device="cpu")
    assert isinstance(store, FStoreBackend)
    # float32 sums in another order move a distance by ~1e-6 of itself
    assert _min_margin(data, store, metric) > 1e-5, "test data sits on a leader tie"
    a, b = _tree_bytes(tmp_path / "ref"), _tree_bytes(tmp_path / "port")
    assert a.keys() == b.keys()
    assert [k for k in a if a[k] != b[k]] == []


def test_reference_searches_the_port_build(tmp_path):
    from repro.core import open_index as ref_open

    data = _data(800, seed=3)
    build_index(data, str(tmp_path / "fs"), ECPBuildConfig(levels=2, metric="l2", cluster_cap=40), device="cpu")
    blob = convert(str(tmp_path / "fs"), tmp_path / "x.blob", quant="int8")
    rs = ref_open(str(blob), mode="file").search(data[:4], 5, b=4)
    assert rs.ids.shape == (4, 5) and (rs.ids[:, 0] == np.arange(4)).all()


def test_norm_cache_is_bounded_and_matches_the_reference():
    from repro.core.store import NodeNormCache as RefNodeNormCache

    nc, rc = NodeNormCache(2), RefNodeNormCache(2)
    embs = [np.random.default_rng(i).normal(size=(5, 4)).astype(np.float16) for i in range(3)]
    for i, e in enumerate(embs):
        a, b = nc.get(1, i, e), rc.get(1, i, e)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert nc.get(1, i, e) is a  # served from the cache for the same array
    assert len(nc) == 2
