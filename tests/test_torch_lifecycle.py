"""The port's index lifecycle (``core/lifecycle.py``, ``ECPIndex.insert /
delete / compact``, the blob's write path in ``core/store.py``) against the
JAX package's: the same sequence of mutations, applied to an fstore and to
a v3 int8 blob in each package, leaves byte-identical files after every
step; flat-engine searches are bit-identical; each package opens and
searches the other's mutated index; the streaming build and
``reservoir_sample`` match their reference twins; and the reference's
validation and error cases behave the same way in the port."""
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from repro.core import ECPBuildConfig as RefCfg
from repro.core import build_index as ref_build
from repro.core import build_index_streaming as ref_streaming
from repro.core import convert as ref_convert
from repro.core import open_index as ref_open
from repro.core import reservoir_sample as ref_reservoir
from repro.data import clustered_vectors
from repro_torch.core import (
    ECPBuildConfig,
    MutableIndex,
    StaleQueryError,
    build_index,
    build_index_streaming,
    convert,
    open_index,
    reservoir_sample,
)

N, DIM, CAP = 2000, 16, 64
CFG = ECPBuildConfig(levels=2, cluster_cap=CAP, seed=3, insert_batch=512)
REF_CFG = RefCfg(levels=2, cluster_cap=CAP, seed=3, insert_batch=512)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A reference-built index: fstore and v3 int8 blob."""
    data, _ = clustered_vectors(0, n=N, dim=DIM, n_clusters=20)
    root = tmp_path_factory.mktemp("torch_lifecycle")
    ref_build(data, str(root / "idx"), REF_CFG)
    blob = ref_convert(str(root / "idx"), root / "idx.blob", quant="int8")
    return data, str(root / "idx"), str(blob)


def _copy(base, dst: Path, backend: str) -> str:
    _, fpath, bpath = base
    if backend == "fstore":
        shutil.copytree(fpath, dst)
    else:
        shutil.copyfile(bpath, dst)
    return str(dst)


def _files(path: str) -> dict:
    """Every file of an index (relative path -> bytes)."""
    p = Path(path)
    if p.is_file():
        return {"": p.read_bytes()}
    return {
        str(f.relative_to(p)): f.read_bytes()
        for f in sorted(p.rglob("*"))
        if f.is_file()
    }


def _same_search(one, other, queries, **kw):
    for q in queries:
        ra, rb = one.search(q, **kw), other.search(q, **kw)
        np.testing.assert_array_equal(ra.ids, rb.ids)
        np.testing.assert_array_equal(ra.dists, rb.dists)


def _same_nodes(p1: str, p2: str) -> None:
    with open_index(p1, mode="file", device="cpu") as a, open_index(p2, mode="file", device="cpu") as b:
        info = a.info
        assert info.to_attrs() == b.info.to_attrs()
        keys = [(0, 0)] + [
            (lv, nd) for lv in range(1, info.levels + 1) for nd in range(info.nodes_per_level[lv - 1])
        ]
        for k in keys:
            for x, y in zip(a.store.get_node(*k), b.store.get_node(*k)):
                np.testing.assert_array_equal(x, y, err_msg=str(k))


def _live_ids(idx) -> list:
    out = []
    for j in range(idx.info.nodes_per_level[-1]):
        out.extend(idx.store.get_node(idx.info.levels, j)[1].tolist())
    return out


# ------------------------------------------------ the cross-package sequence
@pytest.mark.parametrize("backend", ["fstore", "blob"])
def test_mutation_sequence_is_the_reference_byte_for_byte(base, tmp_path, backend):
    data, _, _ = base
    name = "idx" if backend == "fstore" else "idx.blob"
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    rpath = _copy(base, tmp_path / "ref" / name, backend)
    ppath = _copy(base, tmp_path / "port" / name, backend)
    rng = np.random.default_rng(4)
    near = np.asarray(data[0], np.float32)
    # a tight cluster past cap around one item: the leaf it lands in splits
    burst = np.tile(near, (CAP + 10, 1)) + 0.001 * rng.normal(size=(CAP + 10, DIM)).astype(np.float32)
    spread = (data[rng.integers(0, N, 60)] + 0.05 * rng.normal(size=(60, DIM))).astype(np.float32)
    new = np.concatenate([burst, spread])
    new_ids = np.arange(N, N + len(new))
    del_ids = np.concatenate([rng.choice(N, 80, replace=False), new_ids[:5]])
    queries = np.concatenate([data[rng.integers(0, N, 6)] + 0.01, new[:3]])
    steps = [
        ("insert", lambda ix: ix.insert(new, new_ids)),
        ("delete", lambda ix: ix.delete(del_ids)),
        ("reinsert", lambda ix: ix.insert(new[1:2] + 0.3, new_ids[1:2])),
        ("compact", lambda ix: ix.compact()),
    ]
    ref_idx = ref_open(rpath, mode="file", backend=backend)
    ours = open_index(ppath, mode="file", backend=backend, device="cpu")
    assert isinstance(ours, MutableIndex)
    leaves0 = ours.info.n_leaders
    try:
        for step, fn in steps:
            r_out, p_out = fn(ref_idx), fn(ours)
            if step == "insert":
                assert p_out["splits"] >= 1 and ours.info.n_leaders > leaves0
            assert r_out == p_out, step
            assert _files(ppath) == _files(rpath), f"{backend}: files differ after {step}"
            assert ours.info.to_attrs() == ref_idx.info.to_attrs(), step
            assert ours.tombstones == ref_idx.tombstones, step
            _same_search(ref_idx, ours, queries, k=20, b=8)
    finally:
        ref_idx.close()
        ours.close()
    # each package opens and searches the other's mutated index
    with ref_open(ppath, mode="file", backend=backend) as a, \
         open_index(rpath, mode="file", backend=backend, device="cpu") as b:
        _same_search(a, b, queries, k=20, b=8)


@pytest.mark.parametrize("backend", ["fstore", "blob"])
def test_compact_of_a_spill_built_index_is_the_reference(tmp_path, backend):
    """Compaction of an index whose vectors sit in up to two leaves: the
    blob rebuilds through the one-shot build, the fstore through the
    streaming one, and each must write the reference's bytes (replicas in
    each insert batch's order, primaries first)."""
    data, _ = clustered_vectors(5, n=1800, dim=DIM, n_clusters=16)
    cfg = dict(levels=2, metric="l2", cluster_cap=48, seed=2, insert_batch=256, spill_s=1)
    ref_build(data, str(tmp_path / "src"), RefCfg(**cfg))
    if backend == "blob":
        ref_convert(str(tmp_path / "src"), tmp_path / "src.blob", quant="int8")
    name = "idx" if backend == "fstore" else "idx.blob"
    src = tmp_path / ("src" if backend == "fstore" else "src.blob")
    paths = []
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
        dst = tmp_path / side / name
        shutil.copytree(src, dst) if backend == "fstore" else shutil.copyfile(src, dst)
        paths.append(str(dst))
    drop = np.random.default_rng(6).choice(len(data), 150, replace=False)
    with ref_open(paths[0], mode="file", backend=backend) as r, \
         open_index(paths[1], mode="file", backend=backend, device="cpu") as p:
        r.delete(drop)
        p.delete(drop)
        assert r.compact() == p.compact()
        assert p.info.to_attrs() == r.info.to_attrs()
    assert _files(paths[1]) == _files(paths[0])


@pytest.mark.parametrize("backend", ["fstore", "blob"])
def test_each_package_searches_the_others_mutations_before_compact(base, tmp_path, backend):
    """Tombstones and split leaves written by one package, read by the
    other (quantized too on the blob: the v3 companions were re-encoded)."""
    data, _, _ = base
    name = "idx" if backend == "fstore" else "idx.blob"
    (tmp_path / "p").mkdir()
    path = _copy(base, tmp_path / "p" / name, backend)
    rng = np.random.default_rng(6)
    new = (data[rng.integers(0, N, 90)] + 0.05 * rng.normal(size=(90, DIM))).astype(np.float32)
    with open_index(path, mode="file", backend=backend, device="cpu") as ours:
        ours.insert(new, np.arange(N, N + 90))
        ours.delete(np.arange(0, N, 17))
        queries = np.concatenate([new[:4], data[:3] + 0.02])
        with ref_open(path, mode="file", backend=backend) as theirs:
            _same_search(theirs, ours, queries, k=15, b=8)
        if backend == "blob":
            qo = open_index(path, mode="file", quantized=True, rerank_depth=30, device="cpu")
            qr = ref_open(path, mode="file", quantized=True, rerank_depth=30)
            _same_search(qr, qo, queries, k=15, b=8)


# ------------------------------------------------------------ streaming build
def test_streaming_build_is_the_reference_and_the_one_shot_build(base, tmp_path):
    data, fpath, _ = base

    def chunks():  # odd chunk size on purpose: boundaries must not matter
        for lo in range(0, N, 517):
            yield data[lo : lo + 517]

    build_index_streaming(chunks, str(tmp_path / "st"), CFG, device="cpu")
    ref_streaming(chunks, str(tmp_path / "rst"), REF_CFG)
    assert _files(str(tmp_path / "st")) == _files(str(tmp_path / "rst"))
    # the same nodes as the one-shot build (whose leaves are chunked apart)
    _same_nodes(str(tmp_path / "st"), fpath)
    # one-shot iterators are spooled; (emb, ids) pairs carry their ids
    gen = (data[lo : lo + 700] for lo in range(0, N, 700))
    build_index_streaming(gen, str(tmp_path / "sp"), CFG, device="cpu")
    assert _files(str(tmp_path / "sp")) == _files(str(tmp_path / "st"))
    ids = np.arange(N) * 7 + 3
    pairs = [(data[lo : lo + 190], ids[lo : lo + 190]) for lo in range(0, N, 190)]
    build_index_streaming(pairs, str(tmp_path / "pp"), CFG, device="cpu")
    ref_streaming(pairs, str(tmp_path / "rpp"), REF_CFG)
    assert _files(str(tmp_path / "pp")) == _files(str(tmp_path / "rpp"))


def test_streaming_build_reservoir_mode_is_the_reference(tmp_path):
    data, _ = clustered_vectors(3, n=1500, dim=DIM, n_clusters=12)

    def src():
        return (data[lo : lo + 400] for lo in range(0, 1500, 400))

    build_index_streaming(src, str(tmp_path / "resv"), CFG, n_leaders=24, device="cpu")
    ref_streaming(src, str(tmp_path / "rresv"), REF_CFG, n_leaders=24)
    assert _files(str(tmp_path / "resv")) == _files(str(tmp_path / "rresv"))
    with pytest.raises(ValueError, match="smaller than the requested leader count"):
        build_index_streaming([data[:20]], str(tmp_path / "over"), CFG, n_leaders=50, device="cpu")
    with pytest.raises(ValueError, match="empty collection"):
        build_index_streaming(iter([]), str(tmp_path / "e2"), CFG, device="cpu")


@pytest.mark.parametrize("k", [1, 20, 200])
def test_reservoir_sample_is_the_reference(k):
    data = np.random.default_rng(0).normal(size=(150, 4)).astype(np.float32)
    chunks = [data[lo : lo + 17] for lo in range(0, 150, 17)]
    s, p, n = reservoir_sample(iter(chunks), k, seed=1)
    rs, rp, rn = ref_reservoir(iter(chunks), k, seed=1)
    assert n == rn == 150
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(s, data[p])
    with pytest.raises(ValueError):
        reservoir_sample(iter([]), 4)


# ---------------------------------------------- validation and error twins
def test_insert_validation_and_live_id(base, tmp_path):
    data, _, _ = base
    path = _copy(base, tmp_path / "idx", "fstore")
    with open_index(path, mode="file", device="cpu") as idx:
        with pytest.raises(ValueError, match="vectors must be"):
            idx.insert(np.zeros((2, DIM + 1), np.float32))
        with pytest.raises(ValueError, match="unique"):
            idx.insert(np.zeros((2, DIM), np.float32), np.array([5, 5]))
        assert idx.insert(np.zeros((0, DIM), np.float32))["inserted"] == 0
        with pytest.raises(ValueError, match="already live"):
            idx.insert(data[:1] + 0.5, [5])
        # nothing was written: the index still compacts and id 5 is unique
        idx.compact()
        assert _live_ids(idx).count(5) == 1


def test_compact_of_everything_deleted_raises(base, tmp_path):
    path = _copy(base, tmp_path / "idx", "fstore")
    with open_index(path, mode="file", device="cpu") as idx:
        idx.delete(np.arange(N))
        with pytest.raises(ValueError, match="empty index"):
            idx.compact()


def test_compact_stales_open_queries_but_inserts_do_not(base, tmp_path):
    data, _, _ = base
    path = _copy(base, tmp_path / "idx", "fstore")
    with open_index(path, mode="file", device="cpu") as idx:
        rs = idx.search(data[7], k=10, b=4)
        idx.insert(data[:1] + 0.2, [N])
        idx.delete([3])
        assert len(rs.query.next(10)) > 0
        idx.compact()
        with pytest.raises(StaleQueryError):
            rs.query.next(10)
        assert 3 not in idx.search(data[7], k=10, b=4).row_ids(0)


def test_blob_split_refuses_cleanly_when_parent_block_full(base, tmp_path):
    data, _, _ = base
    path = _copy(base, tmp_path / "idx.blob", "blob")
    with open_index(path, mode="file", backend="blob", device="cpu") as idx:
        before = sorted(_live_ids(idx))
        target = idx.store.get_node(idx.info.levels, 0)[0][0]
        new = np.tile(np.asarray(target, np.float32), (CAP + 10, 1))
        orig = type(idx.store).capacity_rows
        try:  # make the parent look full so the pre-flight must trip
            type(idx.store).capacity_rows = property(lambda self: 8)
            with pytest.raises(ValueError, match="compact"):
                idx.insert(new, np.arange(N, N + CAP + 10))
        finally:
            type(idx.store).capacity_rows = orig
        assert sorted(_live_ids(idx)) == before
        assert idx.info.n_items == N


def test_v1_blob_split_header_overflow_raises_before_any_write(tmp_path):
    data, _ = clustered_vectors(9, n=12_000, dim=16, n_clusters=64)
    build_index(data, str(tmp_path / "big"), ECPBuildConfig(levels=2, cluster_cap=8, seed=0),
                device="cpu")
    blob = convert(tmp_path / "big", tmp_path / "big.blob", format=1)
    with open_index(str(blob), mode="file", backend="blob", device="cpu") as idx:
        assert idx.store.format == 1
        target = idx.store.get_node(2, 0)[0][0]
        new = np.tile(np.asarray(target, np.float32), (20, 1))
        with pytest.raises(ValueError, match="header grew past"):
            idx.insert(new, np.arange(12_000, 12_020))
        assert sorted(_live_ids(idx)) == list(range(12_000))


def test_refresh_resyncs_after_external_writer(base, tmp_path):
    """A reader's refresh() picks up metadata, root and tombstones written
    by another handle on the same files (here: the reference's)."""
    data, _, _ = base
    for backend, name in (("fstore", "idx"), ("blob", "idx.blob")):
        path = _copy(base, tmp_path / name, backend)
        reader = open_index(path, mode="file", backend=backend, device="cpu")
        reader.search(data[1], k=5, b=8)  # warm caches + in-memory state
        with ref_open(path, mode="file", backend=backend) as writer:
            writer.insert(data[:1] + 0.4, [N])
            writer.delete([7])
            writer.compact()
        reader.refresh()
        assert reader.info.n_items == N  # N + 1 inserted - 1 deleted
        assert N in reader.search(data[0] + 0.4, k=3, b=8).row_ids(0)
        assert 7 not in reader.search(data[7], k=10, b=32).row_ids(0)
        reader.close()


def test_resurrect_purges_old_row_and_default_ids_stay_fresh(base, tmp_path):
    data, _, _ = base
    path = _copy(base, tmp_path / "idx", "fstore")
    far = np.full(DIM, 40.0, np.float32)
    with open_index(path, mode="file", device="cpu") as idx:
        idx.delete([5])
        idx.insert(far[None, :], [5])
        assert 5 not in idx.search(data[5], k=10, b=64).row_ids(0)
        assert _live_ids(idx).count(5) == 1
        idx.delete([999_999])                # phantom: never existed
        idx.insert(data[:1] + 0.5, [999_999])
        assert idx.info.n_items == N + 1
        idx.delete([3])
        idx.compact()
        r = idx.insert(data[:1] + 0.7)       # default id: past every id ever issued
        assert r["inserted"] == 1 and idx.info.next_id == 1_000_001
        assert len(_live_ids(idx)) == len(set(_live_ids(idx)))
    assert not os.path.exists(os.path.join(path, "query_states"))
