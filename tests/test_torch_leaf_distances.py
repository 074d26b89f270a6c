"""Packed mode's leaf scoring (``repro_torch.kernels.leaf_distances``) on the
CPU: the plain version against the unique-and-blocks scoring that
``BatchedSearcher._leaf_dists`` ran before the op existed (copied below as
the oracle), the kernel's work list decoded as the kernel decodes it, the
wrapper's argument checks, and ``BatchedSearcher``'s row counts.  The
kernel itself runs in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core.batched import BatchedSearcher, _prefix_rows, _prep_queries, _Rows
from repro_torch.core.packed import load_packed
from repro_torch.kernels import _build
from repro_torch.kernels import leaf_distances as ld
from repro_torch.kernels.leaf_distances.ref import SCAN_BUDGET_BYTES

METRICS = ["l2", "ip", "cosine"]


def _old_distances(qp, q_sq, emb, sq, metric):
    dot = qp @ emb.T
    if metric == "ip":
        return -dot
    if metric == "l2":
        return q_sq[:, None] + sq[None, :] - 2.0 * dot
    return 1.0 - dot


def _old_leaf_dists(qp, q_sq, emb, sq, leaf_c, metric, budget):
    """``BatchedSearcher._leaf_dists`` before the op, its tracing left out."""
    B, b = leaf_c.shape
    cap, D = emb.shape[1], emb.shape[2]
    u, inv = torch.unique(leaf_c, return_inverse=True)
    ub = max(1, budget // (cap * (D + B) * 4))
    rows_b = torch.arange(B)[:, None]
    out = None
    for lo in range(0, u.numel(), ub):
        blk = u[lo : lo + ub]
        s = None if sq is None else sq[blk].reshape(-1)
        d = _old_distances(qp, q_sq, emb[blk].reshape(-1, D), s, metric)
        d = d.view(B, -1, cap)
        if lo == 0 and blk.numel() == u.numel():
            return d[rows_b, inv]
        rel = torch.clamp(inv - lo, 0, blk.numel() - 1)
        part = d[rows_b, rel]
        inside = ((inv >= lo) & (inv < lo + blk.numel()))[..., None]
        out = part if out is None else torch.where(inside, part, out)
    return out


def _case(metric, seed=0, B=9, b=5, L=13, cap=24, D=20):
    """A leaf block as ``BatchedSearcher`` holds it: ragged prefixes with
    0-row and full-cap leaves, zero padding; slots with invalid and
    repeated leaves."""
    g = torch.Generator().manual_seed(seed)
    n_rows = torch.randint(0, cap + 1, (L,), generator=g, dtype=torch.int32)
    n_rows[0], n_rows[1], n_rows[2] = 0, cap, 1
    emb = torch.randn(L, cap, D, generator=g)
    emb *= (torch.arange(cap)[None, :] < n_rows[:, None])[..., None]
    rows = _Rows(emb, metric)
    qp, q_sq = _prep_queries(torch.randn(B, D, generator=g), metric)
    leaf_c = torch.randint(0, L, (B, b), generator=g)
    leaf_c[0, :2] = 1                 # the same leaf twice in one query
    leaf_c[1, 0] = 0                  # a leaf with no rows
    lvalid = torch.rand(B, b, generator=g) > 0.2
    lvalid[2, :] = False              # a query with no valid slot
    lvalid[0, :2] = True
    return qp, q_sq, rows.emb, rows.sq, n_rows, leaf_c, lvalid


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("budget_leaves", [None, 1, 3])
def test_plain_version_is_the_old_scoring_on_real_rows(metric, budget_leaves):
    """Bit for bit, padding and invalid slots included; with one block of
    leaves (the wrapper, at the default budget) and with blocks of 1 and 3."""
    qp, q_sq, emb, sq, n_rows, leaf_c, lvalid = _case(metric)
    B, (L, cap, D) = qp.shape[0], emb.shape
    args = (qp, q_sq, emb, sq, n_rows, leaf_c, lvalid, metric)
    ld.reset_launches()
    if budget_leaves is None:
        budget = SCAN_BUDGET_BYTES
        got = ld.leaf_distances(*args)
    else:
        budget = budget_leaves * cap * (D + B) * 4
        got = ld.leaf_distances_ref(*args, budget)
    assert ld.launches["leaf_distances"] == 0  # CPU tensors launch nothing
    old = _old_leaf_dists(qp, q_sq, emb, sq, leaf_c, metric, budget)
    real = (torch.arange(cap) < n_rows[leaf_c][..., None]) & lvalid[..., None]
    assert got.shape == (B, leaf_c.shape[1], cap) and got.dtype == torch.float32
    assert torch.equal(got, old)
    # and each real row is its query's distance to that row
    i, j, r = real.nonzero(as_tuple=True)
    x = emb[leaf_c[i, j], r]
    direct = {"ip": -(qp[i] * x).sum(-1), "cosine": 1.0 - (qp[i] * x).sum(-1)}.get(metric)
    if metric == "l2":
        direct = ((qp[i] - x) ** 2).sum(-1)
    torch.testing.assert_close(got[i, j, r], direct, rtol=1e-5, atol=1e-4)


def _decode(w, n_rows, first, ends):
    """Work item w as the kernel finds it: (leaf, first row, rows, pairs)."""
    ends = ends.tolist()
    u = next(i for i, e in enumerate(ends) if e > w)
    pairs_u = int(first[u + 1] - first[u])
    groups = -(-pairs_u // ld.QUERY_GROUP)
    tiles = -(-int(n_rows[u]) // ld.ROW_TILE)
    local = w - (ends[u] - groups * tiles)
    tile, grp = divmod(local, groups)
    r0 = tile * ld.ROW_TILE
    nr = min(ld.ROW_TILE, int(n_rows[u]) - r0)
    cnt = min(ld.QUERY_GROUP, pairs_u - grp * ld.QUERY_GROUP)
    p0 = int(first[u]) + grp * ld.QUERY_GROUP
    return u, r0, nr, list(range(p0, p0 + cnt))


@pytest.mark.parametrize(
    "B,b,L,seed",
    [(9, 5, 13, 0), (128, 64, 40, 1), (70, 3, 2, 2), (1, 1, 1, 3)],
)
def test_work_list_covers_each_valid_pair_and_real_row_once(B, b, L, seed):
    """Pairs grouped by leaf (ascending pair ids within a leaf, invalid ones
    last); every item holds 1-32 pairs of one leaf and 1-128 of its rows;
    together they cover each valid pair's real rows exactly once, rows of
    leaves past 128 rows and leaves chosen by more than 32 pairs
    included."""
    g = torch.Generator().manual_seed(seed)
    cap = 300
    n_rows = torch.randint(0, cap + 1, (L,), generator=g, dtype=torch.int32)
    n_rows[0] = cap
    leaf_c = torch.randint(0, L, (B, b), generator=g)
    leaf_c[:, 0] = 0  # one leaf every query chose
    lvalid = torch.rand(B, b, generator=g) > 0.1
    perm, first, ends = ld.leaf_work(leaf_c, lvalid, n_rows)
    assert perm.dtype == first.dtype == ends.dtype == torch.int32
    assert first.shape == (L + 1,) and ends.shape == (L,)
    flat_c, flat_v = leaf_c.reshape(-1), lvalid.reshape(-1)
    assert int(first[-1]) == int(flat_v.sum())
    for u in range(L):
        ps = perm[first[u] : first[u + 1]].long()
        assert torch.equal(ps, torch.nonzero(flat_v & (flat_c == u)).reshape(-1))
    assert not flat_v[perm[first[-1] :].long()].any()
    seen = torch.zeros(B * b, cap, dtype=torch.int32)
    for w in range(int(ends[-1])):
        u, r0, nr, pos = _decode(w, n_rows, first, ends)
        assert 1 <= nr <= ld.ROW_TILE and 1 <= len(pos) <= ld.QUERY_GROUP
        for p in perm[pos].long():
            assert flat_c[p] == u and flat_v[p]
            seen[p, r0 : r0 + nr] += 1
    want = (torch.arange(cap) < n_rows[flat_c][:, None]) & flat_v[:, None]
    assert torch.equal(seen, want.to(torch.int32))


@pytest.mark.parametrize(
    "B,b,L,seed",
    [(9, 5, 13, 0), (128, 64, 40, 1), (70, 3, 2, 2), (1, 1, 1, 3)],
)
def test_scored_rows_count_the_products_of_the_kernels_items(B, b, L, seed):
    """``scored_rows`` (the ``rows_scored`` counter on the card) equals the
    products the kernel's items compute: ROW_TILE rows each, against the
    item's pairs rounded up to whole warps of WARP_PAIRS; and it is never
    below the valid pairs' real rows."""
    g = torch.Generator().manual_seed(seed)
    n_rows = torch.randint(0, 300, (L,), generator=g, dtype=torch.int32)
    n_rows[0] = 129
    leaf_c = torch.randint(0, L, (B, b), generator=g)
    leaf_c[:, 0] = 0
    lvalid = torch.rand(B, b, generator=g) > 0.1
    perm, first, ends = ld.leaf_work(leaf_c, lvalid, n_rows)
    want = 0
    for w in range(int(ends[-1])):
        _, _, _, pos = _decode(w, n_rows, first, ends)
        want += ld.ROW_TILE * -(-len(pos) // ld.WARP_PAIRS) * ld.WARP_PAIRS
    got = ld.scored_rows(leaf_c, lvalid, n_rows)
    assert got.dtype == torch.int64 and got.ndim == 0 and int(got) == want
    assert want >= int((n_rows[leaf_c] * lvalid).sum())


def _good(metric="l2"):
    return _case(metric, B=3, b=2, L=4, cap=8, D=4)


def _with(args, i, value):
    args = list(args)
    args[i] = value
    return args


@pytest.mark.parametrize(
    "change,metric,err,match",
    [
        (lambda a: _with(a, 0, a[0][:, :3]), "l2", ValueError, "expects q"),
        (lambda a: _with(a, 2, a[2][0]), "l2", ValueError, "expects q"),
        (lambda a: _with(a, 5, a[5][:2]), "l2", ValueError, "leaf_c and lvalid"),
        (lambda a: _with(a, 6, a[6][:, :1]), "l2", ValueError, "leaf_c and lvalid"),
        (lambda a: _with(a, 4, a[4][:3]), "l2", ValueError, "n_rows must be"),
        (lambda a: _with(a, 1, None), "l2", ValueError, "l2 takes"),
        (lambda a: _with(a, 3, a[3][:, :2]), "l2", ValueError, "l2 takes"),
        (lambda a: a, "ip", ValueError, "for l2 alone"),
        (lambda a: _with(a, 0, a[0].double()), "l2", TypeError, "must be float32"),
        (lambda a: _with(a, 2, a[2].half()), "l2", TypeError, "must be float32"),
        (lambda a: _with(a, 4, a[4].long()), "l2", TypeError, "n_rows int32"),
        (lambda a: _with(a, 5, a[5].int()), "l2", TypeError, "n_rows int32"),
        (lambda a: _with(a, 6, a[6].int()), "l2", TypeError, "n_rows int32"),
        (lambda a: _with(a, 2, a[2].transpose(0, 1).contiguous().transpose(0, 1)), "l2", ValueError, "contiguous"),
        (lambda a: _with(a, 5, a[5].to("meta")), "l2", ValueError, "different devices"),
        (lambda a: [t if t is None else t.to("meta") for t in a], "l2", ValueError, "unsupported device"),
        (lambda a: a, "hamming", ValueError, "unknown metric"),
    ],
)
def test_wrapper_rejects_bad_arguments(change, metric, err, match):
    with pytest.raises(err, match=match):
        ld.leaf_distances(*change(_good()), metric)


def test_no_slots_give_an_empty_result():
    qp, q_sq, emb, sq, n_rows, leaf_c, lvalid = _good()
    got = ld.leaf_distances(qp, q_sq, emb, sq, n_rows, leaf_c[:, :0], lvalid[:, :0], "l2")
    assert got.shape == (3, 0, 8)


def test_rows_follow_the_mask_and_a_mask_that_is_no_prefix_raises():
    mask = np.zeros((4, 8), dtype=bool)
    for u, n in enumerate((0, 3, 8, 1)):
        mask[u, :n] = True
    rows = _prefix_rows(mask)
    assert rows.dtype == np.int32 and rows.tolist() == [0, 3, 8, 1]
    mask[1, 5] = True
    with pytest.raises(ValueError, match="not a prefix"):
        _prefix_rows(mask)


@pytest.fixture(scope="module")
def searcher(tmp_path_factory):
    from repro.core import ECPBuildConfig as RefCfg
    from repro.core import build_index as ref_build

    rng = np.random.default_rng(3)
    data = rng.standard_normal((900, 12)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("leafd") / "fs")
    ref_build(data, path, RefCfg(levels=2, metric="l2", cluster_cap=32))
    packed = load_packed(path)
    return BatchedSearcher(packed, device="cpu"), rng.standard_normal((5, 12)).astype(np.float32), packed.leaf.mask


def test_searcher_holds_each_leafs_real_rows_and_its_cpu_search_launches_nothing(searcher):
    bs, Q, leaf_mask = searcher
    assert torch.equal(bs.n_rows, torch.from_numpy(leaf_mask.sum(axis=1)).to(torch.int32))
    assert bs.n_rows.dtype == torch.int32 and int(bs.n_rows.min()) >= 1
    ld.reset_launches()
    rs = bs.search(Q, 10, b=4)
    rs.query.next(10)
    assert ld.launches["leaf_distances"] == 0


def test_first_use_of_a_library_builds_its_source_alone(monkeypatch):
    """``_build.lib(name)`` compiles only ``name``'s source (packed mode's
    first scan builds ``leaf_distances.cu``, not the flash kernels);
    ``build_all`` still builds every source."""
    built = []

    class FakeLib:
        def __getattr__(self, fn):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda names=_build.SOURCES, verbose=False:
                        built.append(tuple(names)) or {n: f"/nowhere/{n}.so" for n in names})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    _build.lib("leaf_distances")
    _build.lib("leaf_distances")
    assert built == [("leaf_distances",)] and set(_build._libs) == {"leaf_distances"}
    _build.build_all()
    assert built[-1] == _build.SOURCES and "leaf_distances" in _build.SOURCES
