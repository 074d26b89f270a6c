"""The port's shard federation (``repro_torch.core.federation``) against the
JAX package's (the twins of ``tests/test_federation.py``), ``device="cpu"``.

Files: a federation built by either package is the other's byte for byte
(manifest, fstore and blob shards, int8 companions), and each package opens
and searches the other's.  Host paths are held bit for bit: the effort
split (``allocate_effort``, the reference's edge cases included), the
scatter-gather ``search`` and ``next(k)`` (single and batch, fp and
quantized shards), the allocations and the per-shard ``SearchStats`` /
``IOStats``.  Mutations applied to copies of one federation in each package
leave equal files and route to the same shards; snapshots, topology
changes (adopt, evict, refresh against the other package as the external
writer), the ``Server``, ``MultiIndexSession`` (counters step for step with
the reference's) and ``open_store``'s missing-manifest error follow the
reference.  The port's own additions: its aggregate ``SearchStats`` sums
``kernel_launches`` (the reference's leaves it at 0), and a blob header
read torn by a concurrent rewrite is read again instead of failing.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from repro.core import ECPBuildConfig as RefCfg
from repro.core import FederatedIndex as RefFed
from repro.core import MultiIndexSession as RefSession
from repro.core import build_federation as ref_build_federation
from repro.core import convert as ref_convert
from repro.core.federation import FederationManifest as RefManifest
from repro.core.federation import allocate_effort as ref_allocate
from repro.core.store import open_store as ref_open_store
from repro.data import clustered_vectors
from repro_torch.core import (
    ECPBuildConfig,
    FederatedIndex,
    FederatedSnapshot,
    MultiIndexSession,
    build_federation,
    build_index,
    convert,
    open_index,
)
from repro_torch.core import store as store_mod
from repro_torch.core.federation import (
    MANIFEST_FILENAME,
    FederationManifest,
    allocate_effort,
    discover_shards,
    find_manifest,
)
from repro_torch.core.store import BlobStore, open_store

DIM, N = 24, 3000
CFG = ECPBuildConfig(levels=2, cluster_cap=80, metric="l2")
REF_CFG = RefCfg(levels=2, cluster_cap=80, metric="l2")
STAT_FIELDS = ("node_loads", "nodes_opened", "leaves_opened", "distance_calcs", "increments",
               "rounds", "dedup_hits", "kernel_launches")
IO_FIELDS = ("bytes_read", "files_opened", "reads_issued", "prefetch_issued", "prefetch_hits",
             "prefetch_wasted_bytes", "internal_reads")


def _files(root) -> dict:
    """Every file under ``root`` (relative path -> bytes)."""
    p = Path(root)
    return {str(f.relative_to(p)): f.read_bytes() for f in sorted(p.rglob("*")) if f.is_file()}


def _quantized(src_root: Path, dst: Path, conv, manifest_cls) -> Path:
    """A federation of int8 v3 blobs converted from ``src_root``'s fstore
    shards, joined by a manifest (the shards' names kept)."""
    dst.mkdir()
    entries = []
    for e in manifest_cls.load(src_root).shards:
        blob = conv(str(src_root / e["path"]), dst / f"{e['name']}.blob", quant="int8")
        entries.append({"name": e["name"], "path": Path(blob).name, "backend": "blob"})
    manifest_cls(metric="l2", dim=DIM, dtype="float16", shards=entries).save(dst)
    return dst


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The same 4-shard federation built by each package (blob shards, and
    fstore shards with int8 blob copies), and the collection as one blob."""
    td = tmp_path_factory.mktemp("torch_fed")
    data, _ = clustered_vectors(0, n=N, dim=DIM, n_clusters=24)
    out = {"td": td, "data": data}
    out["root"] = build_federation(data, td / "fed", n_shards=4, cfg=CFG, device="cpu")
    out["ref_root"] = ref_build_federation(data, td / "ref_fed", n_shards=4, cfg=REF_CFG)
    out["fs_root"] = build_federation(data, td / "fed_fs", n_shards=4, cfg=CFG, backend="fstore",
                                      device="cpu")
    out["ref_fs_root"] = ref_build_federation(data, td / "ref_fed_fs", n_shards=4, cfg=REF_CFG,
                                              backend="fstore")
    out["q_root"] = _quantized(out["fs_root"], td / "qfed", convert, FederationManifest)
    out["ref_q_root"] = _quantized(out["ref_fs_root"], td / "ref_qfed", ref_convert, RefManifest)
    build_index(data, str(td / "single"), CFG, device="cpu")
    out["single_blob"] = str(convert(str(td / "single"), td / "single.blob"))
    rng = np.random.default_rng(11)
    out["Q"] = data[rng.integers(0, N, 8)] + 0.05 * rng.normal(size=(8, DIM)).astype(np.float32)
    return out


@pytest.fixture()
def pair(built, tmp_path):
    """Two copies of the reference-built federation: one for the port to
    mutate, one for the reference."""
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    shutil.copytree(built["ref_root"], mine)
    shutil.copytree(built["ref_root"], ref)
    return mine, ref


def _fed(root, **kw) -> FederatedIndex:
    return FederatedIndex(root, device="cpu", **kw)


def _same(a, b, msg=""):
    np.testing.assert_array_equal(a.ids, np.asarray(b.ids), err_msg=f"{msg}: ids")
    np.testing.assert_array_equal(a.dists, np.asarray(b.dists), err_msg=f"{msg}: dists")


def _counters(st) -> dict:
    return {**{f: getattr(st, f) for f in STAT_FIELDS}, **{f: getattr(st.io, f) for f in IO_FIELDS}}


def _same_query(q, rq, msg=""):
    """Allocations and per-shard stats of two federated query handles."""
    assert q.allocation == rq.allocation, msg
    mine = q.shard_stats if isinstance(q.shard_stats, list) else [q.shard_stats]
    ref = rq.shard_stats if isinstance(rq.shard_stats, list) else [rq.shard_stats]
    for row, (a, b) in enumerate(zip(mine, ref)):
        assert {n: _counters(s) for n, s in a.items()} == {n: _counters(s) for n, s in b.items()}, \
            f"{msg}: row {row}"


def _same_run(fed, ref, Q, *, k=10, b=12, nexts=2, counters=True, **kw):
    """search then ``nexts`` continuations, single and batch, bit for bit;
    with ``counters``, the per-shard counters too (the bytes read depend on
    what the caches hold, so both sides must have the same history)."""
    for what, q in (("batch", Q), ("single", Q[0])):
        rs, rrs = fed.search(q, k, b=b, **kw), ref.search(q, k, b=b, **kw)
        _same(rs, rrs, f"{what} search b={b}")
        assert rs.query.allocation == rrs.query.allocation
        for i in range(nexts):
            _same(rs.query.next(k), rrs.query.next(k), f"{what} next {i} b={b}")
        if counters:
            _same_query(rs.query, rrs.query, f"{what} b={b}")
        rs.query.close()
        rrs.query.close()


# ------------------------------------------------------------------- files
def test_build_federation_writes_the_reference_files(built):
    """Manifest and shards byte for byte: blob shards, fstore shards, and
    the int8 companions converted from them."""
    for mine, ref in (("root", "ref_root"), ("fs_root", "ref_fs_root"), ("q_root", "ref_q_root")):
        a, b = _files(built[mine]), _files(built[ref])
        assert sorted(a) == sorted(b), mine
        for rel in a:
            assert a[rel] == b[rel], f"{mine}/{rel} differs from the reference's"
    m = json.loads((built["root"] / MANIFEST_FILENAME).read_text())
    assert m["format"] == "ecp-federation/1" and len(m["shards"]) == 4
    assert sum(e["n_items"] for e in m["shards"]) == N


def test_each_package_opens_the_others_federation(built):
    Q = built["Q"]
    with _fed(built["ref_root"]) as mine, RefFed(built["root"]) as ref:
        _same_run(mine, ref, Q)
        assert mine.info.n_items == ref.info.n_items == N
        assert mine.shard_names == ref.shard_names


def test_manifest_roundtrip_and_discovery(built, tmp_path):
    root = built["root"]
    m = FederationManifest.load(root)
    assert m.to_json() == RefManifest.load(root).to_json()
    assert FederationManifest.from_json(m.to_json()).to_json() == m.to_json()
    p = m.save(tmp_path)
    assert p.name == MANIFEST_FILENAME and RefManifest.load(tmp_path).to_json() == m.to_json()
    assert find_manifest(root) == root / MANIFEST_FILENAME
    assert find_manifest(root / MANIFEST_FILENAME) == root / MANIFEST_FILENAME
    assert find_manifest(built["single_blob"]) is None
    assert [e["name"] for e in discover_shards(root)] == [f"shard_{i:04d}" for i in range(4)]
    assert {e["backend"] for e in discover_shards(built["fs_root"])} == {"fstore"}
    with pytest.raises(ValueError, match="not a federation manifest"):
        FederationManifest.from_json({"format": "x"})


def test_open_errors_as_reference(built, tmp_path):
    with pytest.raises(FileNotFoundError, match=MANIFEST_FILENAME):
        _fed(tmp_path)
    FederationManifest(metric="l2", dim=DIM, dtype="float32", shards=[]).save(tmp_path)
    with pytest.raises(ValueError, match="no shards"):
        _fed(tmp_path)
    with pytest.raises(ValueError, match="no shards"):
        RefFed(tmp_path)


def test_open_index_opens_a_federation(built):
    root = built["root"]
    for mode in ("auto", "file"):
        with open_index(root, mode=mode, device="cpu") as f:
            assert isinstance(f, FederatedIndex) and len(f.shard_names) == 4
            assert f.device.type == "cpu"
    with pytest.raises(ValueError, match="mode='file'"):
        open_index(root, mode="packed", device="cpu")
    # the default device is the card, with no fallback to the CPU
    import torch

    if torch.cuda.is_available():
        with open_index(root) as f:
            assert isinstance(f, FederatedIndex) and f.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            open_index(root)


# ------------------------------------------------------------ effort split
def test_allocate_effort_matches_reference():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(12):
        n = int(rng.integers(1, 80))
        cases.append((rng.random(n), rng.integers(0, int(rng.integers(1, 7)), n)))
    cases.append((np.array([0.01, 0.02, 0.03, 0.04, 5.0, 6.0, 7.0, 8.0]),
                  np.array([0, 0, 0, 0, 1, 2, 3, 3])))
    cases.append((np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]),
                  np.array([0, 0, 1, 1, 2, 2, 3, 3])))
    cases.append((np.full(8, 0.5), np.array([3, 2, 1, 0, 3, 2, 1, 0])))  # every distance tied
    n_calls = 0
    for d, owner in cases:
        for b in (0, 1, 2, 3, 5, 7, 8, 13, 16, 24, 64, 100):
            for b_min in (0, 1, 2, 4):
                for top_m in (None, 1, 2):
                    for probe_m in (1, 2, 3):
                        kw = dict(b_min=b_min, top_m=top_m, probe_m=probe_m)
                        probe, alloc = allocate_effort(d, owner, b, **kw)
                        rp, ra = ref_allocate(d, owner, b, **kw)
                        np.testing.assert_array_equal(probe, rp)
                        np.testing.assert_array_equal(alloc, ra)
                        assert alloc.sum() == max(1, b)
                        n_calls += 1
    assert n_calls == len(cases) * 12 * 4 * 3 * 3
    # the reference test's edge cases, with their answers
    d = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8])
    owner = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    probe, alloc = allocate_effort(d, owner, 3, b_min=2)
    assert alloc.tolist() == [3] and probe.tolist() == [0]
    assert allocate_effort(d, owner, 1)[1].tolist() == [1]
    probe, alloc = allocate_effort(d, owner, 16, b_min=4)
    assert alloc.sum() == 16 and (alloc >= 4).all() and len(alloc) == 4
    probe, alloc = allocate_effort(d, owner, 7, b_min=2, top_m=2)
    assert alloc.sum() == 7 and len(alloc) <= 2 and (alloc >= 2).all()
    for args, kw in (((np.array([]), np.array([]), 4), {}), ((d, owner[:4], 4), {}),
                     ((d, owner, 4), {"b_min": -1})):
        with pytest.raises(ValueError):
            allocate_effort(*args, **kw)
        with pytest.raises(ValueError):
            ref_allocate(*args, **kw)


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("b,probe_m", [(3, 1), (12, 1), (24, 1), (12, 2)])
def test_search_and_next_match_reference(built, b, probe_m):
    """fp shards on the host engine: results, allocations (conserved,
    floored) and per-shard counters bit for bit, batch and single."""
    with _fed(built["root"]) as mine, RefFed(built["ref_root"]) as ref:
        _same_run(mine, ref, built["Q"], b=b, probe_m=probe_m)
        rs = mine.search(built["Q"], 10, b=b, probe_m=probe_m)
        for alloc in rs.query.allocation:
            assert sum(alloc.values()) == b and all(v >= mine.b_min for v in alloc.values())
        for row, (tot, per) in enumerate(zip(rs.stats, rs.query.shard_stats)):
            for f in STAT_FIELDS:
                assert getattr(tot, f) == sum(getattr(s, f) for s in per.values()), (row, f)
            for f in IO_FIELDS:
                assert getattr(tot.io, f) == sum(getattr(s.io, f) for s in per.values()), (row, f)


def test_quantized_federation_matches_reference(built, tmp_path):
    """int8 shards scored through the grouped kernel's plain version: the
    reference's quantized federation bit for bit (search and two
    ``next``), joined by a manifest or one ``adopt_shard`` at a time; the
    aggregate counts the kernel's launches, which the reference's sum
    leaves at 0."""
    Q = built["Q"]
    with _fed(built["q_root"], quantized=True) as mine, RefFed(built["ref_q_root"], quantized=True) as ref:
        _same_run(mine, ref, Q, b=12)
        _same_run(mine, ref, Q, b=6, nexts=3)
    # cold caches: a leaf whose fp node a shard's cache holds is scanned on
    # the fp path, without the kernel
    with _fed(built["q_root"], quantized=True) as mine, RefFed(built["ref_q_root"], quantized=True) as ref:
        rs, rrs = mine.search(Q[1], 10, b=12), ref.search(Q[1], 10, b=12)
        launches = sum(s.kernel_launches for s in rs.query.shard_stats.values())
        assert launches >= len(rs.query.allocation) and rs.stats.kernel_launches == launches
        assert rrs.stats.kernel_launches == 0 and rs.stats.leaves_opened == rrs.stats.leaves_opened
        # joined one shard at a time: a one-shard manifest, then adopt_shard
        for pkg, root, man in (("mine", tmp_path / "adopt", FederationManifest),
                               ("ref", tmp_path / "ref_adopt", RefManifest)):
            root.mkdir()
            src = built["q_root"] if pkg == "mine" else built["ref_q_root"]
            for i in range(4):
                shutil.copyfile(src / f"shard_{i:04d}.blob", root / f"shard_{i:04d}.blob")
            man(metric="l2", dim=DIM, dtype="float16",
                shards=[{"name": "shard_0000", "path": "shard_0000.blob", "backend": "blob"}]).save(root)
        with _fed(tmp_path / "adopt", quantized=True) as a, RefFed(tmp_path / "ref_adopt", quantized=True) as ra:
            for i in (1, 2, 3):
                assert a.adopt_shard(tmp_path / "adopt" / f"shard_{i:04d}.blob") == f"shard_{i:04d}"
                ra.adopt_shard(tmp_path / "ref_adopt" / f"shard_{i:04d}.blob")
            assert a.shard_names == ra.shard_names == mine.shard_names
            _same_run(a, ra, Q, b=12)
        a_files, r_files = _files(tmp_path / "adopt"), _files(tmp_path / "ref_adopt")
        assert a_files == r_files


def test_single_shard_federation_matches_plain_index(built, tmp_path):
    data = built["data"]
    root = build_federation(data, tmp_path / "fed1", n_shards=1, cfg=CFG, device="cpu")
    with open_index(root, device="cpu") as f, open_index(
        built["single_blob"], mode="file", backend="blob", device="cpu"
    ) as single:
        assert len(f.shard_names) == 1
        for q in list(data[::700]) + [built["Q"]]:
            rs_f, rs_s = f.search(q, k=10, b=12), single.search(q, k=10, b=12)
            _same(rs_f, rs_s, "one shard")
            _same(rs_f.query.next(10), rs_s.query.next(10), "one shard next")


# --------------------------------------------------------------- mutation
@pytest.mark.parametrize("balance", [2.0, 1.05])
def test_insert_routes_as_reference(pair, balance):
    """The same shards take the same rows (spilling past ``balance_factor``
    to the emptiest shard), leaving the reference's files."""
    mine_root, ref_root = pair
    rng = np.random.default_rng(3)
    q = rng.normal(size=DIM).astype(np.float32)
    vecs = np.concatenate([
        rng.normal(size=(32, DIM)).astype(np.float32),
        np.repeat(q[None, :], 300, axis=0) + 0.01 * rng.normal(size=(300, DIM)).astype(np.float32),
    ])
    with _fed(mine_root, balance_factor=balance) as f, RefFed(ref_root, balance_factor=balance) as r:
        out, rout = f.insert(vecs), r.insert(vecs)
        assert out == rout
        assert sum(out["per_shard"].values()) == len(vecs)
        if balance < 2:
            counts = [f.shard(n).info.n_items for n in f.shard_names]
            assert max(counts) <= balance * (sum(counts) / len(counts)) + 1, counts
        assert vars(f.info) == vars(r.info)
        for i in (0, 13, 31):
            rs = f.search(vecs[i], k=1, b=8)
            _same(rs, r.search(vecs[i], k=1, b=8))
            assert int(rs.ids[0]) == N + i
        _same_run(f, r, vecs[::41])
        with pytest.raises(ValueError, match="vectors must be"):
            f.insert(np.zeros((2, DIM + 1), np.float32))
        with pytest.raises(ValueError, match="ids must be"):
            f.insert(np.zeros((2, DIM), np.float32), ids=np.arange(3))
    assert _files(mine_root) == _files(ref_root)


def test_delete_and_compact_leave_reference_files(pair):
    mine_root, ref_root = pair
    victims = np.arange(0, 300, 7)
    with _fed(mine_root) as f, RefFed(ref_root) as r:
        assert f.delete(victims) == r.delete(victims) == len(victims)
        assert f.tombstones == r.tombstones
        assert _files(mine_root) == _files(ref_root)
        _same_run(f, r, np.zeros((2, DIM), np.float32), k=50, b=24)
        name = f.shard_names[0]
        assert f.compact_shard(name) == r.compact_shard(name)
        assert _files(mine_root) == _files(ref_root)
        with pytest.raises(KeyError):
            f.compact_shard("nope")
        out, rout = f.compact(), r.compact()
        assert out == rout and set(out["shards"]) == set(f.shard_names)
        assert not f.tombstones and f.info.n_items == N - len(victims)
        assert _files(mine_root) == _files(ref_root)
        _same_run(f, r, np.zeros((2, DIM), np.float32), k=5, b=8)


def test_snapshot_stable_under_live_writes(pair):
    mine_root, _ = pair
    with _fed(mine_root) as f:
        q = np.zeros(DIM, np.float32)
        snap = f.snapshot()
        assert isinstance(snap, FederatedSnapshot) and not snap.supports_snapshot
        rs0 = snap.search(q, k=10, b=16)
        ids0, d0 = rs0.ids.copy(), rs0.dists.copy()
        rng = np.random.default_rng(4)
        f.insert(0.01 * rng.normal(size=(64, DIM)).astype(np.float32))
        f.delete(ids0[:3])
        rs1 = snap.search(q, k=10, b=16)
        np.testing.assert_array_equal(rs1.ids, ids0)
        np.testing.assert_array_equal(rs1.dists, d0)
        snap.close()
        with pytest.raises(RuntimeError, match="released"):
            snap.acquire()
        assert set(f.search(q, k=10, b=16).ids) != set(ids0)


# ---------------------------------------------------------------- topology
def test_adopt_and_evict_as_reference(pair, tmp_path):
    mine_root, ref_root = pair
    rng = np.random.default_rng(5)
    extra = rng.normal(size=(300, DIM)).astype(np.float32)
    build_index(extra, str(tmp_path / "x"), CFG, item_ids=np.arange(N, N + 300), device="cpu")
    blob = convert(str(tmp_path / "x"), tmp_path / "extra.blob")
    shutil.copyfile(blob, tmp_path / "ref_extra.blob")
    with _fed(mine_root) as f, RefFed(ref_root) as r:
        assert f.adopt_shard(blob, name="extra") == r.adopt_shard(tmp_path / "ref_extra.blob", name="extra")
        rs = f.search(extra[0], k=1, b=32)
        _same(rs, r.search(extra[0], k=1, b=32))
        assert "extra" in rs.query.allocation and int(rs.ids[0]) == N
        _same_run(f, r, np.concatenate([extra[:3], _near_mean(extra)]), b=32)
        assert len(FederationManifest.load(mine_root).shards) == 5
        info, rinfo = f.evict_shard("extra"), r.evict_shard("extra")
        assert vars(info) == vars(rinfo) and info.n_items == 300
        with pytest.raises(KeyError):
            f.evict_shard("extra")
        data, _ = clustered_vectors(9, n=200, dim=DIM + 8, n_clusters=4)
        build_index(data, str(tmp_path / "bad"), CFG, device="cpu")
        bad = convert(str(tmp_path / "bad"), tmp_path / "bad.blob")
        with pytest.raises(ValueError, match="dim"):
            f.adopt_shard(bad)
        assert "bad" not in f.shard_names
    assert _files(mine_root) == _files(ref_root)


def _near_mean(x):
    """Rows near ``x``'s mean (queries that vote for the adopted shard)."""
    return x.mean(0, keepdims=True) + 0.1 * x[:2]


def test_evict_last_shard_refused(built, tmp_path):
    root = build_federation(built["data"][:500], tmp_path / "f1", n_shards=1, cfg=CFG, device="cpu")
    with _fed(root) as f:
        with pytest.raises(ValueError, match="last shard"):
            f.evict_shard(f.shard_names[0])


def test_refresh_sees_the_reference_as_external_writer(pair):
    """The reference writes, the port's reader refreshes: it sees the new
    generation and the inserted rows, and then answers as a fresh open."""
    mine_root, _ = pair
    reader, writer = _fed(mine_root), RefFed(mine_root)
    try:
        gen0 = reader.info.generation
        vecs = np.random.default_rng(6).normal(size=(16, DIM)).astype(np.float32)
        writer.insert(vecs)
        writer.delete([5, 6])
        assert reader.info.generation == gen0
        reader.refresh()
        assert reader.info.generation == writer.info.generation > gen0
        assert reader.info.next_id == N + 16 and reader.tombstones == {5, 6}
        assert int(reader.search(vecs[0], k=1, b=8).ids[0]) == N
        with _fed(mine_root) as fresh:
            _same_run(reader, fresh, vecs[:4], counters=False)
    finally:
        reader.close()
        writer.close()


# ------------------------------------------------------- torn blob headers
class _TornOS:
    """The ``os`` module for ``repro_torch.core.store``, whose header-length
    reads (16 bytes at offset 0) return ``length`` the first ``times``
    times: the old length beside the new JSON, as a reader racing a
    writer's header rewrite sees it."""

    def __init__(self, length: int, times: int = 1):
        self.length, self.left, self.torn = length, times, 0

    def pread(self, fd, n, offset):
        data = os.pread(fd, n, offset)
        if n == 16 and offset == 0 and self.left > 0:
            self.left -= 1
            self.torn += 1
            data = data[:8] + int(self.length).to_bytes(8, "little")
        return data

    def __getattr__(self, name):
        return getattr(os, name)


@pytest.mark.parametrize("delta", [-40, 40])
def test_torn_blob_header_is_read_again(pair, monkeypatch, delta):
    """A header read with a length shorter than its JSON (truncated JSON) or
    longer (the JSON, then blanks) is retried; the open, and a federation's
    ``refresh`` that reopens every shard, succeed with the whole header.
    A header torn on every read still fails the open."""
    mine_root, _ = pair
    blob = mine_root / "shard_0001.blob"
    whole = BlobStore(blob)
    header, hlen = whole._header, len(json.dumps(whole._header, sort_keys=True))
    whole.close()
    torn = _TornOS(hlen + delta)
    monkeypatch.setattr(store_mod, "os", torn)
    st = BlobStore(blob)
    assert torn.torn == 1 and st._header == header
    assert st.io.files_opened == 1 and st.io.reads_issued == 4
    st.close()
    with _fed(mine_root) as f:
        torn.left = 1
        f.refresh()
        assert torn.torn == 2 and f.info.n_items == N
        f.search(np.zeros(DIM, np.float32), k=5, b=8)
    torn.left = store_mod._HEADER_READS
    with pytest.raises(ValueError, match="did not read whole"):
        BlobStore(blob)
    monkeypatch.undo()
    BlobStore(blob).close()  # the failed open closed its descriptor: the file is fine


# ------------------------------------------------------------- serving stack
def test_server_over_a_federation(pair, built):
    from repro_torch.launch.serve import Server

    mine_root, ref_root = pair
    fed = _fed(mine_root)
    q = built["data"][1]
    with RefFed(ref_root) as ref, Server(fed, workers=2, queue_depth=16) as srv:
        rs, sid = srv.search(q, k=10, b=12)
        rrs = ref.search(q, k=10, b=12)
        _same(rs, rrs, "served")
        _same(srv.more(sid, 10), rrs.query.next(10), "more")
        srv.close(sid)
        base = int(fed.info.next_id)
        srv.insert(np.random.default_rng(8).normal(size=(24, DIM)).astype(np.float32),
                   np.arange(base, base + 24))
        assert fed.info.next_id == base + 24
        out = fed.compact_async(scheduler=srv.scheduler).result(timeout=60)
        assert set(out["shards"]) == set(fed.shard_names)
        st = srv.scheduler.stats.as_dict()
        assert st["submitted"] == st["completed"] + st["rejected"] + st["failed"]
    fed.close()


# ------------------------------------------- MultiIndexSession on a federation
def _fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_session_on_a_federation_as_reference(pair, built):
    """One shared budget over the federation's shards: the counters step for
    step with the reference's, ``per_index`` rolling the shards up, resize,
    invalidate after an external writer, and every fd released."""
    mine_root, ref_root = pair
    base = _fds()
    sess, rsess = MultiIndexSession(cache_bytes=2 << 20), RefSession(cache_bytes=2 << 20)
    f = sess.open(str(mine_root), "fed", backend="blob", device="cpu")
    rsess.open(str(ref_root), "fed", backend="blob")
    assert isinstance(f, FederatedIndex)
    for q in built["Q"][:4]:
        _same(sess.search("fed", q, k=10, b=12), rsess.search("fed", q, k=10, b=12), "session")
    st = sess.stats()
    assert st == rsess.stats()
    assert st["per_index"]["fed"]["bytes"] > 0, "federation shards bypassed the shared cache"
    assert st["per_index"]["fed"]["bytes"] == st["resident_bytes"]
    one = st["per_index"]["fed"]["bytes"]
    sess.resize(cache_bytes=one // 3)
    rsess.resize(cache_bytes=one // 3)
    assert sess.stats() == rsess.stats() and sess.stats()["resident_bytes"] <= one // 3
    _same(sess.search("fed", built["Q"][5], k=10, b=12), rsess.search("fed", built["Q"][5], k=10, b=12))
    assert sess.stats() == rsess.stats()
    gen0 = f.info.generation
    with RefFed(mine_root) as writer:  # another process's writer, in effect
        writer.insert(np.random.default_rng(10).normal(size=(8, DIM)).astype(np.float32))
    assert f.info.generation == gen0
    assert sess.invalidate("fed") == 0
    assert f.info.generation > gen0 and f.info.next_id == N + 8
    assert sess.stats()["per_index"]["fed"] == {"nodes": 0, "bytes": 0}
    assert _fds() >= base + 4
    sess.close()
    rsess.close()
    assert _fds() <= base + 1, "close() leaked store fds"


# ------------------------------------------------------------- open_store
def test_open_store_without_a_manifest_raises_as_reference(built, tmp_path):
    for src in ("root", "fs_root"):
        d = tmp_path / src
        shutil.copytree(built[src], d)
        (d / MANIFEST_FILENAME).unlink()
        with pytest.raises(ValueError) as mine:
            open_store(d)
        with pytest.raises(ValueError) as ref:
            ref_open_store(d)
        assert "no federation manifest" in str(mine.value)
        assert str(mine.value).replace("repro_torch.core", "repro.core") == str(ref.value)
    empty = tmp_path / "empty"
    empty.mkdir()
    open_store(empty, create=True).close()  # an empty directory is a new fstore, as before
