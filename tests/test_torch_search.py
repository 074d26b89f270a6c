"""The port's file-mode search against the JAX package's, on indexes the
reference built: the host-numpy engines give bit-identical ``(dists, ids)``
and the same I/O, and the quantized engine (its grouped kernel taking the
plain version on the CPU, ``device="cpu"``) gives the reference's
``engine="legacy"`` results, launch for launch."""
import numpy as np
import pytest
import torch

from repro.core import ECPBuildConfig as RefCfg
from repro.core import build_index as ref_build
from repro.core import convert as ref_convert
from repro.core import open_index as ref_open
from repro.core.search import make_kernel_scorer as ref_make_scorer
from repro_torch.core import ECPIndex, make_kernel_scorer, open_index
from repro_torch.kernels.distance_topk import ops

D, K, B_EXP = 16, 20, 6


@pytest.fixture(scope="module", params=["l2", "ip", "cosine"])
def ref_blob(request, tmp_path_factory):
    metric = request.param
    d = tmp_path_factory.mktemp(f"idx_{metric}")
    rng = np.random.default_rng(0)
    data = rng.standard_normal((1500, D)).astype(np.float32)
    ref_build(data, str(d / "fs"), RefCfg(levels=2, metric=metric, cluster_cap=48))
    blob = ref_convert(str(d / "fs"), d / "x.blob", quant="int8")
    Q = rng.standard_normal((8, D)).astype(np.float32)
    return metric, str(blob), Q


def _same(a, b):
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)


@pytest.mark.parametrize("probe_m", [1, 2])
def test_quantized_search_is_the_reference_legacy_result(ref_blob, probe_m):
    metric, blob, Q = ref_blob
    ours = open_index(blob, mode="file", quantized=True, device="cpu")
    rs = ours.search(Q, K, b=B_EXP, probe_m=probe_m)
    nx = rs.query.next(K)
    # next(k) at a rerank depth that covers every emission (2K)
    deep = open_index(blob, mode="file", quantized=True, rerank_depth=2 * K, device="cpu")
    dnx = deep.search(Q, K, b=B_EXP, probe_m=probe_m).query.next(K)
    for r in range(len(Q)):
        leg = ref_open(blob, mode="file", engine="legacy")
        lr = leg.search(Q[r], K, b=B_EXP, probe_m=probe_m)
        assert np.array_equal(lr.ids, rs.ids[r]) and np.array_equal(lr.dists, rs.dists[r]), (metric, r)
        ln = lr.query.next(K)
        assert np.array_equal(ln.ids, dnx.ids[r]) and np.array_equal(ln.dists, dnx.dists[r]), (metric, r)
        if metric == "cosine":
            # no sound cosine bound prunes a row, so the default depth
            # (emitted + k per increment) continues exactly as well; under
            # l2/ip rows pruned by the first increment are not rescanned
            # and next(k) departs from the fp engines in both packages
            # alike (ROADMAP Queue 3)
            assert np.array_equal(ln.ids, nx.ids[r]) and np.array_equal(ln.dists, nx.dists[r])
    # the reference's own quantized engine: same results, launches, bytes
    theirs = ref_open(blob, mode="file", quantized=True)
    trs = theirs.search(Q, K, b=B_EXP, probe_m=probe_m)
    tnx = trs.query.next(K)
    _same(rs, trs)
    _same(nx, tnx)
    a, b = rs.query.batch_stats, trs.query.batch_stats
    assert a.kernel_launches == b.kernel_launches > 0
    assert a.rounds == b.rounds
    assert a.io.bytes_read == b.io.bytes_read and a.io.reads_issued == b.io.reads_issued


def test_quantized_single_query_and_excludes(ref_blob):
    metric, blob, Q = ref_blob
    ours = open_index(blob, mode="file", quantized=True, device="cpu")
    theirs = ref_open(blob, mode="file", quantized=True)
    _same(ours.search(Q[0], K, b=B_EXP), theirs.search(Q[0], K, b=B_EXP))
    excl = set(theirs.search(Q[1], 5, b=B_EXP).ids.tolist())
    a = ours.search(Q, K, b=B_EXP, exclude=excl)
    _same(a, theirs.search(Q, K, b=B_EXP, exclude=excl))
    assert not excl & set(a.ids.ravel().tolist())


@pytest.mark.parametrize("probe_m", [1, 2])
def test_flat_engine_matches_the_reference(ref_blob, probe_m):
    metric, blob, Q = ref_blob
    for path in (blob, blob.replace("x.blob", "fs")):
        ours = open_index(path, mode="file", device="cpu")
        theirs = ref_open(path, mode="file")
        a, b = ours.search(Q, K, b=B_EXP, probe_m=probe_m), theirs.search(Q, K, b=B_EXP, probe_m=probe_m)
        _same(a, b)
        _same(a.query.next(K), b.query.next(K))
        assert a.query.batch_stats.io.bytes_read == b.query.batch_stats.io.bytes_read
        _same(ours.search(Q[2], K, b=B_EXP, probe_m=probe_m), theirs.search(Q[2], K, b=B_EXP, probe_m=probe_m))


def test_spill_built_index_dedups_like_the_reference(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((1200, D)).astype(np.float32)
    ref_build(data, str(tmp_path / "fs"), RefCfg(levels=2, metric="l2", cluster_cap=40, spill_s=1))
    blob = str(ref_convert(str(tmp_path / "fs"), tmp_path / "s.blob", quant="int8"))
    Q = rng.standard_normal((6, D)).astype(np.float32)
    for quantized in (False, True):
        a = open_index(blob, mode="file", quantized=quantized, device="cpu").search(Q, K, b=B_EXP)
        b = ref_open(blob, mode="file", quantized=quantized).search(Q, K, b=B_EXP)
        _same(a, b)
        _same(a.query.next(K), b.query.next(K))
        for row in a.ids:
            row = row[row >= 0]
            assert len(set(row.tolist())) == len(row)


def test_launches_go_through_the_late_kernel_lookup(ref_blob, monkeypatch):
    """The engine resolves the grouped op at call time, so a patched op
    sees every launch, one per leaf-bearing round."""
    _, blob, Q = ref_blob
    seen = []
    real = ops.grouped_distance_topk_tensors

    def counting(*a, **kw):
        seen.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "grouped_distance_topk_tensors", counting)
    idx = open_index(blob, mode="file", quantized=True, device="cpu")
    rs = idx.search(Q, K, b=B_EXP)
    assert len(seen) == rs.query.batch_stats.kernel_launches > 0
    t = idx.quant_times
    assert t["rounds"] == len(seen) and t["h2d_bytes"] > 0 and t["stage_ms"] > 0
    assert t["h2d_ms"] == t["kernel_ms"] == 0.0  # CUDA events, on the card only


def test_code_bytes_count_the_rows_each_round_reads(ref_blob, monkeypatch):
    """quant_times["code_bytes"] is the sum over rounds of n_rows[g] * D *
    itemsize: the codes the grouped kernel reads, without the padding to
    the round's largest leaf that the staging copy carries."""
    _, blob, Q = ref_blob
    rounds = []
    real = ops.grouped_distance_topk_tensors

    def recording(*a, **kw):
        codes, n_rows = a[1], a[4]
        rounds.append((int(n_rows.sum()) * codes.shape[2] * codes.element_size(), codes.numel()))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "grouped_distance_topk_tensors", recording)
    idx = open_index(blob, mode="file", quantized=True, device="cpu")
    rs = idx.search(Q, K, b=B_EXP)
    rs.query.next(K)
    t = idx.quant_times
    assert len(rounds) == t["rounds"] > 1
    assert t["code_bytes"] == sum(r for r, _ in rounds) > 0
    assert t["code_bytes"] < sum(padded for _, padded in rounds)  # ragged leaves pad


def test_kernel_scorer_agrees_with_the_reference(ref_blob):
    metric, blob, Q = ref_blob
    ours = make_kernel_scorer(min_rows=8, bucket=32, device="cpu")
    theirs = ref_make_scorer(min_rows=8, impl="ref", bucket=32)
    emb = np.random.default_rng(2).standard_normal((45, D)).astype(np.float32)
    a, b = ours(Q[0], emb, metric), theirs(Q[0], emb, metric)
    assert a.shape == b.shape == (45,)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert ours.compile_shapes == {(64, 64)}
    sa = open_index(blob, mode="file", scorer=ours, device="cpu").search(Q, K, b=B_EXP)
    sb = ref_open(blob, mode="file", scorer=theirs).search(Q, K, b=B_EXP)
    np.testing.assert_allclose(sa.dists, sb.dists, rtol=1e-4, atol=1e-4)
    # ids equal wherever the distances are not tied within the tolerance
    for r, j in zip(*np.nonzero(sa.ids != sb.ids)):
        assert abs(sa.dists[r, j] - sb.dists[r, j]) <= 1e-4 * max(1.0, abs(sb.dists[r, j]))
        assert sa.ids[r, j] in sb.ids[r]


def test_cuda_is_asked_for_by_default(ref_blob):
    _, blob, _ = ref_blob
    if torch.cuda.is_available():
        assert ECPIndex(blob).device.type == "cuda"
        return
    for make in (lambda: ECPIndex(blob), lambda: open_index(blob, mode="file"),
                 lambda: make_kernel_scorer()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_unported_modes_say_so(ref_blob, tmp_path):
    """No file-mode entry is left unported: a federation manifest opens as a
    federation (a malformed one raises the reference's ``ValueError``), and
    the modes that used to raise here (legacy engine, prefetch, pinned
    internal levels, prefetch of levels, saved queries) work and give the
    reference's results."""
    _, blob, Q = ref_blob
    (tmp_path / "federation.json").write_text("{}")
    with pytest.raises(ValueError, match="not a federation manifest"):
        open_index(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="not a federation manifest"):
        ref_open(str(tmp_path))
    want = ref_open(blob, mode="file").search(Q, K, b=B_EXP)
    for kw in ({"engine": "legacy"}, {"prefetch": True}, {"backend": "blob+prefetch"},
               {"pin_internal": True}):
        with open_index(blob, mode="file", device="cpu", **kw) as idx:
            _same(idx.search(Q, K, b=B_EXP), want)
    idx = open_index(blob, mode="file", device="cpu")
    idx.prefetch(1)
    assert idx.load_node_count == idx.info.nodes_per_level[0]
    fs = blob.replace("x.blob", "fs")
    rs = open_index(fs, mode="file", device="cpu").search(Q[0], K, b=B_EXP)
    token = rs.query.save()
    _same(open_index(fs, mode="file", device="cpu").load_query(token).next(K),
          ref_open(fs, mode="file").load_query(token).next(K))
