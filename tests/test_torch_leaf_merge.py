"""Packed mode's merge (``repro_torch.kernels.leaf_merge``) on the CPU: the
plain version against the mask, concatenation and stable sort that
``BatchedSearcher._scan_chunk`` ran inline before the op existed (copied
below as the oracle), bit for bit; the wrapper's argument checks; and the
searcher's use of the op.  The kernel itself runs in
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import batched
from repro_torch.core.batched import BatchedSearcher
from repro_torch.kernels import leaf_merge as lm


def _old_merge(buf_d, buf_i, d, leaf_mask, leaf_ids, leaf_c, lvalid):
    """``BatchedSearcher._scan_chunk``'s merge before the op, its tracing
    left out."""
    B = d.shape[0]
    mask = (leaf_mask[leaf_c] & lvalid[..., None]).reshape(B, -1)
    d = torch.where(mask, d.reshape(B, -1), torch.inf)
    i = torch.where(mask, leaf_ids[leaf_c].reshape(B, -1), -1)
    C = buf_d.shape[1]
    cat_d, cat_i = torch.cat([buf_d, d], dim=-1), torch.cat([buf_i, i], dim=-1)
    order = torch.sort(cat_d, dim=-1, stable=True).indices[..., :C]
    return torch.gather(cat_d, -1, order), torch.gather(cat_i, -1, order)


def _case(kind, C, seed=0, B=6, b=7, L=11, cap=48):
    """A scan chunk as ``_scan_chunk`` hands it over: leaves with ragged
    prefixes (leaf 0 empty, leaf 1 full), unique item ids, garbage (NaN,
    -inf, small values) past each leaf's rows and in the slots left out;
    each query's slots with a repeated leaf, a few invalid slots and, for
    query 1, the exhausted tail of its ranking (invalid, the last ranked
    leaf repeated).  The buffer: sorted, finite for a share of C, then
    (+inf, -1).  ``kind``: "ties" (distances on a coarse grid, so that the
    buffer and many rows tie), "zeros" (-0.0 and +0.0 among them, as ip
    gives) or "sparse" (few rows: fewer than C finite candidates)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "sparse":
        cap = 6
    n_rows = torch.randint(0, cap + 1, (L,), generator=g, dtype=torch.int32)
    n_rows[0], n_rows[1] = 0, cap
    leaf_mask = torch.arange(cap)[None, :] < n_rows[:, None]
    leaf_ids = torch.randperm(L * cap, generator=g).view(L, cap).long()
    leaf_c = torch.randint(0, L, (B, b), generator=g)
    leaf_c[:, 1] = 1
    leaf_c[:, 2] = leaf_c[:, 3]
    lvalid = torch.rand(B, b, generator=g) > 0.2
    lvalid[1, b - 3 :] = False
    leaf_c[1, b - 3 :] = leaf_c[1, b - 4]
    if kind == "ties":
        d = torch.randint(0, 5, (B, b, cap), generator=g).float() / 4
    elif kind == "zeros":
        d = torch.randint(-2, 3, (B, b, cap), generator=g).float() * 0.5
        d[torch.rand(B, b, cap, generator=g) < 0.3] = 0.0
        d[torch.rand(B, b, cap, generator=g) < 0.3] = -0.0
    else:
        d = torch.rand(B, b, cap, generator=g)
    junk = ~(leaf_mask[leaf_c] & lvalid[..., None])
    fill = torch.tensor([float("nan"), -float("inf"), -1.0])[torch.randint(0, 3, (B, b, cap), generator=g)]
    d = torch.where(junk, fill, d)
    n_fin = torch.randint(0, C + 1, (B,), generator=g)
    n_fin[0], n_fin[-1] = 0, C
    grid = torch.randint(0, 5, (B, C), generator=g).float() / 4 if kind != "sparse" else torch.rand(B, C, generator=g)
    if kind == "zeros":
        grid = torch.where(torch.rand(B, C, generator=g) < 0.5, -grid * 0.0, grid)
    fin = torch.arange(C)[None, :] < n_fin[:, None]
    buf_d = torch.sort(torch.where(fin, grid, torch.inf), dim=-1, stable=True).values
    buf_i = torch.where(torch.isfinite(buf_d), torch.randint(10**6, 2 * 10**6, (B, C), generator=g), -1)
    return buf_d, buf_i, d, leaf_mask, leaf_ids, n_rows, leaf_c, lvalid


def _bits_equal(x, y):
    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("C", [256, 400, 4096])
@pytest.mark.parametrize("kind", ["ties", "zeros", "sparse"])
def test_plain_version_is_the_old_inline_merge_bit_for_bit(kind, C):
    for seed in range(2):
        buf_d, buf_i, d, leaf_mask, leaf_ids, n_rows, leaf_c, lvalid = _case(kind, C, seed)
        want_d, want_i = _old_merge(buf_d, buf_i, d, leaf_mask, leaf_ids, leaf_c, lvalid)
        for fn in (lm.leaf_merge_ref, lm.leaf_merge):  # the wrapper takes the plain version on the CPU
            got_d, got_i = fn(buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid)
            assert _bits_equal(got_d, want_d), (kind, C, seed)
            assert torch.equal(got_i, want_i), (kind, C, seed)
        if kind == "sparse":  # fewer than C finite: the tail is (+inf, -1)
            fin = torch.isfinite(want_d)
            assert not bool(fin.all()) and bool((want_i[~fin] == -1).all())
        if kind == "zeros":  # both signs survive, tied in place
            z = want_d == 0
            assert bool(torch.signbit(want_d[z]).any()) and bool((~torch.signbit(want_d[z])).any())


def test_plain_version_keeps_ties_in_buffer_slot_row_order():
    """Every candidate ties: the buffer's finite entries first, then slot by
    slot, row by row, ids read from each valid slot's leaf."""
    C, cap = 8, 3
    buf_d = torch.tensor([[0.5, 0.5, torch.inf, torch.inf, torch.inf, torch.inf, torch.inf, torch.inf]])
    buf_i = torch.tensor([[70, 71, -1, -1, -1, -1, -1, -1]])
    d = torch.full((1, 3, cap), 0.5)
    leaf_ids = torch.tensor([[10, 11, 12], [20, 21, 22]])
    n_rows = torch.tensor([2, 3], dtype=torch.int32)
    leaf_c = torch.tensor([[1, 0, 1]])
    lvalid = torch.tensor([[True, True, False]])
    got_d, got_i = lm.leaf_merge(buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid)
    assert got_i.tolist() == [[70, 71, 20, 21, 22, 10, 11, -1]]
    assert got_d[0, :7].eq(0.5).all() and got_d[0, 7] == torch.inf


def test_sort_area():
    assert [lm.sort_keys(C) for C in (1, 256, 400, 2048, 2049, 4096, 20000)] == \
        [2048, 2048, 2048, 2048, 4096, 4096, 32768]
    assert lm.sort_keys(20000) > lm.SORT_SMEM >= lm.sort_keys(4096 * 4)


def _good():
    buf_d, buf_i, d, _, leaf_ids, n_rows, leaf_c, lvalid = _case("ties", 256)
    return dict(buf_d=buf_d, buf_i=buf_i, d=d, leaf_ids=leaf_ids, n_rows=n_rows, leaf_c=leaf_c, lvalid=lvalid)


@pytest.mark.parametrize(
    "change,err,match",
    [
        (lambda a: {"buf_i": a["buf_i"][:, :-1]}, ValueError, "buf_d and buf_i must be"),
        (lambda a: {"buf_d": a["buf_d"][0]}, ValueError, "buf_d and buf_i must be"),
        (lambda a: {"d": a["d"][:-1]}, ValueError, "d must be"),
        (lambda a: {"leaf_c": a["leaf_c"][:, :-1]}, ValueError, "leaf_c and lvalid must be"),
        (lambda a: {"lvalid": a["lvalid"][:-1]}, ValueError, "leaf_c and lvalid must be"),
        (lambda a: {"leaf_ids": a["leaf_ids"][:, :-1]}, ValueError, "leaf_ids must be"),
        (lambda a: {"n_rows": a["n_rows"][:-1]}, ValueError, "leaf_ids must be"),
        (lambda a: {"d": a["d"].double()}, TypeError, "float32"),
        (lambda a: {"buf_i": a["buf_i"].int()}, TypeError, "float32"),
        (lambda a: {"n_rows": a["n_rows"].long()}, TypeError, "float32"),
        (lambda a: {"lvalid": a["lvalid"].int()}, TypeError, "float32"),
        (lambda a: {"d": a["d"].transpose(1, 2).contiguous().transpose(1, 2)}, ValueError, "contiguous"),
        (lambda a: {"d": a["d"].to("meta")}, ValueError, "different devices"),
        (lambda a: {k: v.to("meta") for k, v in a.items()}, ValueError, "unsupported device"),
    ],
)
def test_wrapper_rejects_bad_inputs(change, err, match):
    a = _good()
    a.update(change(a))
    with pytest.raises(err, match=match):
        lm.leaf_merge(**a)


def test_wrapper_rejects_positions_past_31_bits():
    a = _good()
    B, b = a["leaf_c"].shape
    cap = 2**31 // b + 1
    a["d"] = torch.empty((B, b, 1)).expand(B, b, cap)  # one row of storage: the shape is checked first
    a["leaf_ids"] = torch.empty((1, 1), dtype=torch.int64).expand(1, cap)
    a["n_rows"] = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="fewer than 2\\^31"):
        lm.leaf_merge(**a)


@pytest.fixture(scope="module")
def searcher(tmp_path_factory):
    from repro_torch.core import ECPBuildConfig, build_index, load_packed

    rng = np.random.default_rng(7)
    data = rng.standard_normal((1500, 16)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("leafm") / "fs")
    build_index(data, path, ECPBuildConfig(levels=2, metric="ip", cluster_cap=30), device="cpu")
    packed = load_packed(path)
    return (BatchedSearcher(packed, device="cpu"), rng.standard_normal((7, 16)).astype(np.float32),
            torch.as_tensor(packed.leaf.mask))


def test_cpu_search_launches_no_merge_and_counts_the_old_masks_rows(searcher, monkeypatch):
    """A CPU search and its ``next`` merge through the plain version (no
    launch) and equal the old inline merge chunk for chunk; the counter
    ``ecpfs.packed.rows_needed`` is the old mask's sum over the chunks."""
    bs, Q, leaf_mask = searcher
    real = batched.leaf_merge
    seen = []

    def recording(buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid):
        out = real(buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid)
        old = _old_merge(buf_d, buf_i, d, leaf_mask, leaf_ids, leaf_c, lvalid)
        seen.append((_bits_equal(out[0], old[0]) and torch.equal(out[1], old[1]),
                     int((leaf_mask[leaf_c] & lvalid[..., None]).sum())))
        return out

    monkeypatch.setattr(batched, "leaf_merge", recording)
    lm.reset_launches()
    tracing.reset()
    try:
        with tracing.on():
            rs = bs.search(Q, 40, b=2)
            rs.query.next(40)
        snap = tracing.snapshot()
    finally:
        tracing.reset()
    assert lm.launches["leaf_merge"] == 0
    assert len(seen) == snap["spans"]["ecpfs.packed.merge"]["count"] >= 3
    assert all(same for same, _ in seen)
    assert snap["counters"]["ecpfs.packed.rows_needed"] == sum(n for _, n in seen) > 0


def test_next_past_the_buffer_keeps_merging(searcher):
    """A ``next`` of more than the buffer holds (k > C: a page of C) leaves
    the state's buffer contiguous, so a later chunk still merges."""
    bs, Q, _ = searcher
    rs = bs.search(Q, 10, b=1, buffer_cap=16)
    nx = rs.query.next(20)
    assert nx.ids.shape == (len(Q), 16)
    st = rs.query.state
    assert st.buf_d.is_contiguous() and st.buf_i.is_contiguous() and st.buf_d.shape[1] == 16
    more = rs.query.next(5)
    assert more.ids.shape == (len(Q), 5)
