"""The port's quantized blocks and quantized engine against the JAX
package's (the twins of ``tests/test_quant.py``): encode/decode and the
distance bounds equal the reference's, the port reads the reference's v3
companions (and the v2 / fstore encode-on-the-fly fallbacks) as the
reference does, companions survive the port's mutations, the quantized
engine is bit-identical to the port's fp engines and to both packages'
legacy oracles, one grouped launch serves a round, and ``pin_internal``
keeps every internal level resident.  The grouped kernel runs its plain
version on the CPU (``device="cpu"``)."""
import os
import shutil

import numpy as np
import pytest

from repro.core import ECPBuildConfig as RefCfg
from repro.core import build_index as ref_build
from repro.core import convert as ref_convert
from repro.core import open_index as ref_open
from repro.core.quant import decode_codes as ref_decode_codes
from repro.core.quant import distance_bounds as ref_bounds
from repro.core.quant import encode_node as ref_encode
from repro.core.store import BlobStore as RefBlobStore
from repro.core.store import open_store as ref_open_store
from repro_torch.core import ECPIndex, open_index
from repro_torch.core import layout
from repro_torch.core.distances import np_distances
from repro_torch.core.quant import QFORMATS, decode_codes, distance_bounds, encode_node, reconstruction_radius
from repro_torch.core.search import make_kernel_scorer
from repro_torch.core.store import BlobStore, convert, open_store
from repro_torch.kernels.distance_topk import ops

RNG = np.random.default_rng(42)


def _same_q(a, b):
    np.testing.assert_array_equal(a.codes, b.codes)
    assert (a.scale, a.offset, a.radius, a.qformat) == (b.scale, b.offset, b.radius, b.qformat)


def _same(a, b, msg=""):
    np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"{msg}: ids")
    np.testing.assert_array_equal(a.dists, b.dists, err_msg=f"{msg}: dists")


# ------------------------------------------------------------- encode/decode
@pytest.mark.parametrize("qformat", QFORMATS)
@pytest.mark.parametrize("scale_pow", [-3, 0, 4])
def test_encode_decode_error_bound_as_the_reference(qformat, scale_pow):
    emb = (RNG.standard_normal((96, 24)) * 10.0**scale_pow).astype(np.float32)
    qn = encode_node(emb, qformat)
    _same_q(qn, ref_encode(emb, qformat))
    dec = qn.decode()
    np.testing.assert_array_equal(dec, ref_encode(emb, qformat).decode())
    err = np.linalg.norm(dec.astype(np.float64) - emb.astype(np.float64), axis=1)
    assert float(err.max()) <= qn.radius
    assert qn.radius == reconstruction_radius(qn.scale, emb.shape[1])
    if qformat == "int8":
        assert qn.codes.dtype == np.int8 and qn.codes.min() >= -127 and qn.codes.max() <= 127


@pytest.mark.parametrize("case", ["f16_exact", "constant"])
def test_exact_encodings(case):
    if case == "f16_exact":
        emb, qformat = RNG.standard_normal((32, 16)).astype(np.float16).astype(np.float32), "float16"
    else:
        emb, qformat = np.full((8, 12), 3.25, np.float32), "int8"
    qn = encode_node(emb, qformat)
    _same_q(qn, ref_encode(emb, qformat))
    assert qn.scale == 0.0 and qn.radius == 0.0
    np.testing.assert_array_equal(qn.decode(), emb)


def test_encode_deterministic_vs_f32_params():
    emb = RNG.standard_normal((64, 20)).astype(np.float32)
    a, b = encode_node(emb, "int8"), encode_node(emb.copy(), "int8")
    np.testing.assert_array_equal(a.codes, b.codes)
    assert a.scale == np.float32(a.scale) and a.offset == np.float32(a.offset)
    dec = decode_codes(a.codes, a.scale, a.offset, "int8")
    np.testing.assert_array_equal(dec, b.decode())
    np.testing.assert_array_equal(dec, ref_decode_codes(a.codes, a.scale, a.offset, "int8"))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_distance_bounds_sound_and_the_reference(metric):
    q = RNG.standard_normal(24).astype(np.float32)
    emb = RNG.standard_normal((128, 24)).astype(np.float32)
    qn = encode_node(emb, "int8")
    d_approx = np_distances(q, qn.decode(), metric)
    d_exact = np_distances(q, emb, metric)
    lb, ub = distance_bounds(d_approx, qn.radius, metric, q_norm=float(np.linalg.norm(q)))
    assert np.all(lb <= d_exact + 1e-9) and np.all(d_exact <= ub + 1e-9)
    rlb, rub = ref_bounds(d_approx, qn.radius, metric, q_norm=float(np.linalg.norm(q)))
    np.testing.assert_array_equal(lb, rlb)
    np.testing.assert_array_equal(ub, rub)


# ------------------------------------------------------------ on-disk format
@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    td = tmp_path_factory.mktemp("quant_idx")
    n, dim = 900, 16
    data = np.random.default_rng(3).standard_normal((n, dim)).astype(np.float32)
    fs = os.path.join(td, "fs")
    ref_build(data, fs, RefCfg(levels=2, metric="l2", cluster_cap=48))
    v2 = os.path.join(td, "v2.bin")
    v3 = os.path.join(td, "v3.bin")
    ref_convert(fs, v2, format=2)
    ref_convert(fs, v3, format=2, quant="int8")
    return {"fs": fs, "v2": v2, "v3": v3, "data": data, "dim": dim}


def _leaf_keys(store):
    info = layout.IndexInfo.from_attrs(store.read_attrs(layout.INFO))
    return [(info.levels, j) for j in range(info.nodes_per_level[-1])]


def _assert_quant_matches_fp(store, qformat):
    for lv, nd in _leaf_keys(store):
        emb, _ = store.get_node(lv, nd)
        got = store.get_quantized(lv, nd)
        assert got.qformat == qformat
        _same_q(got, encode_node(emb, qformat))


def test_blob_v3_companions_are_the_reference_reads(small_index):
    s, r = BlobStore(small_index["v3"]), RefBlobStore(small_index["v3"])
    assert (s.format, s.quant_format, s.q_block_bytes) == (r.format, r.quant_format, r.q_block_bytes)
    assert s.format == 3 and s.quant_format == "int8" and s.q_block_bytes > 0
    _assert_quant_matches_fp(s, "int8")
    keys = _leaf_keys(s)
    for a, b in zip(s.get_nodes_quantized(keys), r.get_nodes_quantized(keys)):
        _same_q(a, b)


def test_blob_v3_partial_row_reads(small_index):
    s, r = BlobStore(small_index["v3"]), RefBlobStore(small_index["v3"])
    rng = np.random.default_rng(5)
    for lv, nd in _leaf_keys(s)[:4]:
        emb, ids = s.get_node(lv, nd)
        rows = np.unique(rng.integers(0, len(emb), size=max(1, len(emb) // 3)))
        pe, pi = s.get_node_rows(lv, nd, rows)
        np.testing.assert_array_equal(pe, emb[rows])
        np.testing.assert_array_equal(pi, ids[rows])
        re_, ri = r.get_node_rows(lv, nd, rows)
        np.testing.assert_array_equal(pe, re_)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(s.get_node_ids(lv, nd), ids)


def test_blob_v2_reads_and_upgrade(small_index, tmp_path):
    v2 = BlobStore(small_index["v2"])
    assert v2.format == 2 and v2.quant_format is None
    lv, nd = _leaf_keys(v2)[0]
    emb, _ = v2.get_node(lv, nd)
    _same_q(v2.get_quantized(lv, nd, "int8"), encode_node(emb, "int8"))
    # the port's upgrade of the reference's v2 blob is the reference's
    up, rup = tmp_path / "up.bin", tmp_path / "rup.bin"
    convert(small_index["v2"], up, quant="int8")
    ref_convert(small_index["v2"], rup, quant="int8")
    assert up.read_bytes() == rup.read_bytes()
    v3 = BlobStore(up)
    assert v3.format == 3 and v3.quant_format == "int8"
    _assert_quant_matches_fp(v3, "int8")


def test_fstore_quantized_fallback(small_index):
    s, r = open_store(small_index["fs"]), ref_open_store(small_index["fs"])
    assert s.quant_format is None
    lv, nd = _leaf_keys(s)[0]
    emb, _ = s.get_node(lv, nd)
    _same_q(s.get_quantized(lv, nd, "int8"), r.get_quantized(lv, nd, "int8"))
    (gn,) = s.get_nodes_quantized([(lv, nd)], "float16")
    np.testing.assert_array_equal(gn.decode(), emb)


# --------------------------------------------------- survival under mutation
def test_quant_blocks_survive_mutations(small_index, tmp_path):
    blob = tmp_path / "mut.bin"
    shutil.copy(small_index["v3"], blob)
    dim = small_index["dim"]
    ix = open_index(str(blob), mode="file", device="cpu")
    rng = np.random.default_rng(9)
    assert ix.insert(rng.standard_normal((300, dim)).astype(np.float32))["inserted"] == 300
    _assert_quant_matches_fp(ix.store, "int8")
    ids0 = np.concatenate([ix.store.get_node(lv, nd)[1] for lv, nd in _leaf_keys(ix.store)])
    assert ix.delete(ids0[::3][:200]) > 0
    _assert_quant_matches_fp(ix.store, "int8")
    ix.compact()
    assert ix.store.format == 3 and ix.store.quant_format == "int8"
    _assert_quant_matches_fp(ix.store, "int8")
    q = rng.standard_normal((4, dim)).astype(np.float32)
    fp = open_index(str(blob), mode="file", device="cpu").search(q, 20, b=6)
    _same(open_index(str(blob), mode="file", quantized=True, device="cpu").search(q, 20, b=6), fp)
    # and the reference reads the port's mutated blob the same way
    _same(ref_open(str(blob), mode="file", quantized=True).search(q, 20, b=6), fp)


# ------------------------------------------------------------- engine parity
@pytest.mark.parametrize("backend", ["fs", "v3"])
def test_quant_bit_parity(small_index, backend):
    dim = small_index["dim"]
    Q = np.random.default_rng(11).standard_normal((12, dim)).astype(np.float32)
    path = small_index[backend]
    flat = open_index(path, mode="file", device="cpu")
    leg = open_index(path, mode="file", engine="legacy", device="cpu")
    rleg = ref_open(path, mode="file", engine="legacy")
    qi = open_index(path, mode="file", quantized=True, device="cpu")
    for k, b in [(10, 4), (50, 8)]:
        r_flat = flat.search(Q, k, b=b)
        r_q = qi.search(Q, k, b=b)
        _same(r_q, r_flat, "quantized vs flat")
        _same(qi.search(Q, k, b=b), r_flat, "warm repeat")
        for row in range(len(Q)):
            r_leg = leg.search(Q[row], k, b=b)
            np.testing.assert_array_equal(r_leg.ids, r_q.ids[row])
            np.testing.assert_array_equal(r_leg.dists, r_q.dists[row])
            _same(r_leg, rleg.search(Q[row], k, b=b), "port legacy vs reference legacy")


def test_quant_parity_excludes_and_continuation(small_index):
    dim = small_index["dim"]
    Q = np.random.default_rng(13).standard_normal((6, dim)).astype(np.float32)
    flat = open_index(small_index["v3"], mode="file", device="cpu")
    qi = open_index(small_index["v3"], mode="file", quantized=True, rerank_depth=60, device="cpu")
    probe = flat.search(Q, 10, b=4)
    excl = set(int(i) for i in probe.ids[:, :5].ravel() if i >= 0)
    ra = flat.search(Q, 30, b=6, exclude=excl)
    rz = qi.search(Q, 30, b=6, exclude=excl)
    _same(ra, rz)
    _same(ra.query.next(30), rz.query.next(30), "next")


def test_quant_f16_tier_parity(small_index, tmp_path):
    blob = tmp_path / "f16.bin"
    convert(small_index["fs"], blob, quant="float16")
    s = BlobStore(blob)
    assert s.format == 3 and s.quant_format == "float16"
    Q = np.random.default_rng(17).standard_normal((8, small_index["dim"])).astype(np.float32)
    ra = open_index(small_index["v2"], mode="file", device="cpu").search(Q, 25, b=6)
    rz = open_index(str(blob), mode="file", quantized=True, device="cpu").search(Q, 25, b=6)
    _same(ra, rz)
    _same(rz, ref_open(str(blob), mode="file", quantized=True).search(Q, 25, b=6), "reference")


# ----------------------------------------------------- one launch per round
def test_one_device_launch_per_round(small_index, monkeypatch):
    calls = {"n": 0}
    orig = ops.grouped_distance_topk_tensors

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "grouped_distance_topk_tensors", counting)
    Q = np.random.default_rng(19).standard_normal((8, small_index["dim"])).astype(np.float32)
    r = open_index(small_index["v3"], mode="file", quantized=True, device="cpu").search(Q, 40, b=8)
    st = r.query.batch_stats
    assert calls["n"] >= 1 and calls["n"] == st.kernel_launches <= st.rounds
    rst = ref_open(small_index["v3"], mode="file", quantized=True).search(Q, 40, b=8).query.batch_stats
    assert (st.kernel_launches, st.rounds) == (rst.kernel_launches, rst.rounds)


# ------------------------------------------------------- scorer + pinning
def test_kernel_scorer_shape_bucketing():
    scorer = make_kernel_scorer(min_rows=1, bucket=128, device="cpu")
    q = RNG.standard_normal(16).astype(np.float32)
    for n in (40, 77, 100, 128):
        emb = RNG.standard_normal((n, 16)).astype(np.float32)
        np.testing.assert_allclose(scorer(q, emb, "l2"), np_distances(q, emb, "l2"), rtol=1e-5, atol=1e-5)
    assert scorer.compile_shapes == {(128, 128)}
    scorer(q, RNG.standard_normal((200, 16)).astype(np.float32), "l2")
    assert scorer.compile_shapes == {(128, 128), (256, 256)}


@pytest.mark.parametrize("quantized", [False, True])
def test_pin_internal_zero_warm_internal_reads(small_index, quantized):
    ix = open_index(small_index["v3"], mode="file", quantized=quantized, pin_internal=True, device="cpu")
    rx = ref_open(small_index["v3"], mode="file", quantized=quantized, pin_internal=True)
    assert ix.cache.n_pinned == rx.cache.n_pinned == ix.info.nodes_per_level[0]
    Q = np.random.default_rng(23).standard_normal((6, small_index["dim"])).astype(np.float32)
    first = ix.search(Q, 20, b=6)
    _same(first, rx.search(Q, 20, b=6))
    before = ix.store.io.internal_reads
    _same(ix.search(Q, 20, b=6), first)
    assert ix.store.io.internal_reads == before
    # a tight cache evicts leaves, never the pinned level
    tight = open_index(small_index["v3"], mode="file", quantized=quantized, pin_internal=True,
                       cache_max_nodes=4, device="cpu")
    tight.search(Q, 20, b=6)
    before = tight.store.io.internal_reads
    _same(tight.search(Q, 20, b=6), first)
    assert tight.store.io.internal_reads == before


def test_quantized_rejects_legacy_engine(small_index):
    with pytest.raises(ValueError, match="legacy"):
        ECPIndex(small_index["v3"], engine="legacy", quantized=True, device="cpu")
