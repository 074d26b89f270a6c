#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of eCP-FS (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n-items N] [--l2-items N]

Phases, none of whose failures is caught:

1. device: the card's name and power limit (``nvidia-smi``); exits non-zero
   when ``torch.cuda.is_available()`` is false.
2. kernels: builds both CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a) and holds each against its plain PyTorch version on the card at
   the main path's shapes; times kernel, plain version, a library yardstick
   (timed here only, never called by the port) and the bound.
3. main path at the paper's widths (``configs/ecpfs_paper.py``: dim 1152,
   float16 storage, cosine, cluster_cap 455, L=2, b=64, k=100, a batch of
   128, int8 companion): build on the card -> convert(quant="int8") ->
   open_index(mode="file", quantized=True) -> search -> next(100), then a
   search through make_kernel_scorer().  Launch counters are zeroed just
   before and read just after.  Asserts bit-identity with the host fp
   engine, launch counts, and prints recall@100 against brute force.
   Then holds both kernels against their plain versions at the largest
   shapes the built index gives them (its largest leaves).
4. l2: the same steps at a smaller collection with metric l2.

Prints a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Distances agree within 1e-4 relative:
|a - b| <= 1e-4 * max(1, |b|); ids agree except where two distances lie
within that tolerance of each other.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12, "float16": 989e12, "bfloat16": 989e12, "int8": 1979e12}
RTOL = 1e-4
D = 1152


def log(*a) -> None:
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events around a run)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def tol(x):
    return RTOL * np.maximum(1.0, np.abs(x))


def compare_topk(what: str, dk, ik, dp, ip) -> float:
    """Kernel (dk, ik) against plain (dp, ip), both [R, k] ascending.
    Returns the largest absolute distance error over finite entries."""
    dk, ik, dp, ip = (np.asarray(a.cpu() if hasattr(a, "cpu") else a) for a in (dk, ik, dp, ip))
    fin_k, fin_p = np.isfinite(dk), np.isfinite(dp)
    assert np.array_equal(fin_k, fin_p), f"{what}: valid entries differ"
    assert np.array_equal(ik[~fin_k], np.full((~fin_k).sum(), -1)), f"{what}: pad ids not -1"
    err = np.abs(dk[fin_k] - dp[fin_p])
    bad = err > tol(dp[fin_p])
    assert not bad.any(), f"{what}: {bad.sum()} distances off by up to {err.max()}"
    for r, j in zip(*np.nonzero(ik != ip)):
        x = ik[r, j]
        hit = np.flatnonzero(ip[r] == x)
        # an id may move only among near-equal distances (a swap of ties,
        # or across the k-th place when it sits at the boundary)
        ref_d = dp[r, hit[0]] if len(hit) else dp[r, -1]
        assert abs(dk[r, j] - ref_d) <= 2 * tol(ref_d), (
            f"{what}: row {r} pos {j}: id {x} at {dk[r, j]} vs {ref_d}"
        )
    return float(err.max()) if err.size else 0.0


# ------------------------------------------------------------------ kernels
def grouped_case(seed: int, G: int, N: int, qformat: str, *, ragged: bool):
    """G groups of N-row leaf blocks from clustered data, encoded as the blob
    does; group 0 has no rows, the others ragged up to N."""
    import torch
    from repro_torch.core.quant import encode_node, qdtype
    from repro_torch.data.synthetic import clustered_vectors

    rng = np.random.default_rng(seed)
    x, _ = clustered_vectors(seed, n=G * N + G, dim=D)
    x = x.astype(np.float16).astype(np.float32)       # storage dtype rows
    codes = np.zeros((G, N, D), qdtype(qformat))
    scales = np.zeros(G, np.float32)
    offsets = np.zeros(G, np.float32)
    n_rows = rng.integers(N // 2, N + 1, size=G) if ragged else np.full(G, N)
    n_rows[0] = 0
    n_rows[1] = N
    for g in range(G):
        qn = encode_node(x[g * N : g * N + int(n_rows[g])], qformat)
        codes[g, : qn.n_rows] = qn.codes
        scales[g], offsets[g] = qn.scale, qn.offset
    q = x[G * N :]
    t = lambda a: torch.from_numpy(a).cuda()
    return t(q), t(codes), t(scales), t(offsets), t(n_rows.astype(np.int32))


def grouped_bound_ms(G, rows, k, itemsize=1):
    """Least time for G groups holding ``rows`` valid rows in all: each code
    byte, the queries and the per-group parameters read once, the top-k
    written once; two multiply-adds (dot and norm) per code element."""
    nbytes = rows * D * itemsize + G * D * 4 + 3 * G * 4 + G * k * 8
    ops = 4 * rows * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["int8" if itemsize == 1 else "float16"] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def topk_bound_ms(B, N, k, dtype="float32", itemsize=4):
    nbytes = (B + N) * D * itemsize + B * k * 8
    ops = 2 * B * N * D + 2 * N * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def phase_kernels(res: dict) -> None:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.distance_topk import ops, ref

    t0 = time.time()
    _build.build_all(verbose=True)
    log(f"[kernels] built both sources in {time.time() - t0:.1f} s")

    # ---- grouped_distance_topk at the quantized round's shapes
    gerr = 0.0
    for N in (455, 2048):
        for qformat in ("int8", "float16"):
            args = grouped_case(11 + N, 128, N, qformat, ragged=True)
            for metric in ("l2", "ip", "cosine"):
                for k in (128, N):
                    dk, ik = ops.grouped_distance_topk_tensors(*args, k, metric, qformat)
                    dp, ip = ref.grouped_distance_topk_ref(*args, k, metric, qformat)
                    torch.cuda.synchronize()
                    e = compare_topk(f"grouped N={N} {qformat} {metric} k={k}", dk, ik, dp, ip)
                    gerr = max(gerr, e)
            log(f"[kernels] grouped_distance_topk G=128 N={N} {qformat}: l2/ip/cosine, k=128 and k=N agree (max abs err so far {gerr:.3g})")
    res["grouped_err"] = gerr

    # timing at the main path's shape: G=128, a 455-row leaf, int8, cosine
    G, N, k = 128, 455, 128
    args = grouped_case(5, G, N, "int8", ragged=False)
    q, codes, scales, offsets, n_rows = args
    kern = lambda: ops.grouped_distance_topk_tensors(*args, k, "cosine", "int8")
    plain = lambda: ref.grouped_distance_topk_ref(*args, k, "cosine", "int8")
    # yardstick: decode, one batched product (inner-product scores), top-k
    lib = lambda: torch.topk(torch.bmm(codes.float() * scales[:, None, None] + offsets[:, None, None],
                                       q[:, :, None])[..., 0], k, dim=1)
    host = torch.empty(codes.numel(), dtype=torch.int8, pin_memory=True)
    dev = torch.empty_like(codes).view(-1)
    h2d = lambda: dev.copy_(host, non_blocking=True)
    g = {
        "ms": cuda_ms(kern, 50), "plain_ms": cuda_ms(plain, 20),
        "library_ms": cuda_ms(lib, 20), "h2d_ms": cuda_ms(h2d, 20),
    }
    g["bound_ms"], g["bound_by"] = grouped_bound_ms(G, int(n_rows.sum()), k)
    g["h2d_bytes"] = codes.numel()
    res["grouped"] = g
    log(f"[kernels] grouped_distance_topk G={G} N={N} D={D} int8 cosine k={k}: "
        + json.dumps({a: round(b, 6) if isinstance(b, float) else b for a, b in g.items()}))

    # ---- distance_topk: the scorer's full selection, then the merge path
    terr = 0.0
    rng = np.random.default_rng(3)
    for n_pad in (512, 1024):
        c = torch.from_numpy(rng.standard_normal((n_pad, D)).astype(np.float32)).cuda()
        c[n_pad - 57 :] = 0  # the scorer's zero pad rows
        qv = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32)).cuda()
        for metric in ("l2", "ip", "cosine"):
            dk, ik = ops.distance_topk(qv, c, n_pad, metric)
            dp, ip = ref.distance_topk_ref(qv, c, n_pad, metric)
            terr = max(terr, compare_topk(f"distance_topk full N={n_pad} {metric}", dk, ik, dp, ip))
    log(f"[kernels] distance_topk B=1 N_pad=512/1024 k=N_pad: l2/ip/cosine agree (max abs err {terr:.3g})")
    B, N, k = 128, 65536, 100
    qb = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).cuda()
    cb = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).cuda()
    for metric, dt in (("l2", torch.float32), ("ip", torch.float32), ("cosine", torch.float32),
                       ("l2", torch.float16), ("l2", torch.bfloat16)):
        qq, cc = qb.to(dt), cb.to(dt)
        dk, ik = ops.distance_topk(qq, cc, k, metric)
        dp, ip = ref.distance_topk_ref(qq, cc, k, metric)
        terr = max(terr, compare_topk(f"distance_topk merge {metric} {dt}", dk, ik, dp, ip))
    log(f"[kernels] distance_topk B={B} N={N} k={k}: l2/ip/cosine f32, l2 f16/bf16 agree (max abs err {terr:.3g})")
    res["topk_err"] = terr
    mk = lambda: ops.distance_topk(qb, cb, k, "l2")
    merge = {"ms": cuda_ms(mk, 5, 1),
             "plain_ms": cuda_ms(lambda: ref.distance_topk_ref(qb, cb, k, "l2"), 5, 1),
             "library_ms": cuda_ms(lambda: torch.topk(torch.mm(qb, cb.T), k, dim=1), 5, 1)}
    merge["bound_ms"], merge["bound_by"] = topk_bound_ms(B, N, k)
    res["topk_merge"] = merge
    log(f"[kernels] distance_topk merge path B={B} N={N} D={D} f32 l2 k={k}: {json.dumps(merge)}")

    # timing at the scorer's shape: B=1, N_pad=512, k=512, float32, cosine
    c = torch.from_numpy(rng.standard_normal((512, D)).astype(np.float32)).cuda()
    qv = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32)).cuda()
    t = {
        "ms": cuda_ms(lambda: ops.distance_topk(qv, c, 512, "cosine"), 100),
        "plain_ms": cuda_ms(lambda: ref.distance_topk_ref(qv, c, 512, "cosine"), 50),
        "library_ms": cuda_ms(lambda: torch.topk(torch.mm(qv, c.T), 512, dim=1), 50),
    }
    t["bound_ms"], t["bound_by"] = topk_bound_ms(1, 512, 512)
    res["topk"] = t
    log(f"[kernels] distance_topk B=1 N_pad=512 D={D} f32 cosine k=512: {json.dumps(t)}")


# ---------------------------------------------------------------- main path
def run_path(tag: str, work: Path, data, Q, cfg, res: dict, *, scorer_rows: int) -> dict:
    import torch
    from repro_torch.core import build_index, convert, make_kernel_scorer, open_index
    from repro_torch.configs.ecpfs_paper import build_cfg
    from repro_torch.core.layout import derive_shape
    from repro_torch.kernels.distance_topk import ops

    out = {}
    fs, blob = work / f"{tag}_fs", work / f"{tag}.blob"
    ops.reset_launches()
    # ---------------- the main path, through the user's entry points
    t0 = time.perf_counter()
    st = build_index(data, str(fs), build_cfg(cfg))
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    n_leaves = derive_shape(len(data), cfg.cluster_cap, cfg.levels)[2][-1]
    largest = max(st.node_rows([(cfg.levels, j) for j in range(n_leaves)]))
    log(f"[{tag}] built in {out['build_s']:.3f} s: {n_leaves} leaves, largest {largest} rows "
        "(the blob gives every slot the largest leaf's stride)")
    t0 = time.perf_counter()
    convert(str(fs), blob, quant="int8")
    out["convert_s"] = time.perf_counter() - t0
    idx = open_index(str(blob), mode="file", quantized=True)
    t0 = time.perf_counter()
    rs = idx.search(Q, cfg.k, b=cfg.b)
    out["search_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nx = rs.query.next(cfg.k)
    out["next_s"] = time.perf_counter() - t0
    sc_idx = open_index(str(blob), mode="file", scorer=make_kernel_scorer())
    t0 = time.perf_counter()
    srs = sc_idx.search(Q[:scorer_rows], cfg.k, b=cfg.b)
    out["scorer_search_s"] = time.perf_counter() - t0
    launches = dict(ops.launches)
    # ---------------- checks
    bs = rs.query.batch_stats
    out["launches"] = launches
    out["kernel_launches"] = bs.kernel_launches
    out["rounds"] = bs.rounds
    out["bytes_read"] = bs.io.bytes_read
    qt = idx.quant_times
    out["quant_times"] = dict(qt)
    n = max(1, qt["rounds"])
    out["per_round_ms"] = {
        "search": out["search_s"] * 1e3 / max(1, bs.rounds),
        "stage": qt["stage_ms"] / n, "h2d": qt["h2d_ms"] / n, "kernel": qt["kernel_ms"] / n,
        "rerank": qt["rerank_ms"] / n, "h2d_mb": qt["h2d_bytes"] / 1e6 / n,
    }
    assert bs.kernel_launches == launches["grouped_distance_topk"] > 0, (bs.kernel_launches, launches)
    assert launches["distance_topk"] > 0, launches
    fp = open_index(str(blob), mode="file", quantized=False)
    t0 = time.perf_counter()
    frs = fp.search(Q, cfg.k, b=cfg.b)
    out["fp_search_s"] = time.perf_counter() - t0
    fnx = frs.query.next(cfg.k)
    out["fp_bytes_read"] = frs.query.batch_stats.io.bytes_read
    same = (np.array_equal(rs.ids, frs.ids) and np.array_equal(rs.dists, frs.dists)
            and np.array_equal(nx.ids, fnx.ids) and np.array_equal(nx.dists, fnx.dists))
    out["bit_identical"] = bool(same)
    assert rs.ids.shape == (len(Q), cfg.k) and np.isfinite(rs.dists).all()
    compare_topk(f"{tag} scorer vs fp engine", srs.dists, srs.ids,
                 frs.dists[:scorer_rows], frs.ids[:scorer_rows])
    # recall@k against brute force over the stored (float16) collection
    xs = torch.from_numpy(data.astype(np.float16).astype(np.float32)).cuda()
    qs = torch.from_numpy(Q).cuda()
    if cfg.metric == "cosine":
        xs = xs / xs.norm(dim=1, keepdim=True).clamp_min(1e-12)
        qs = qs / qs.norm(dim=1, keepdim=True).clamp_min(1e-12)
        gt = torch.topk(qs @ xs.T, cfg.k, dim=1).indices.cpu().numpy()
    else:
        d = (qs * qs).sum(1)[:, None] + (xs * xs).sum(1)[None, :] - 2 * (qs @ xs.T)
        gt = torch.topk(d, cfg.k, dim=1, largest=False).indices.cpu().numpy()
    del xs
    out["recall_at_k"] = float(np.mean([len(set(gt[r]) & set(rs.ids[r])) / cfg.k for r in range(len(Q))]))
    from repro_torch.core.store import BlobStore

    bst = BlobStore(blob)
    out["leaves"] = len(bst._n_rows[-1])
    out["largest_leaf"] = int(max(bst._n_rows[-1]))
    out["blob_bytes"] = blob.stat().st_size
    out["fstore_bytes"] = sum(p.stat().st_size for p in fs.rglob("*") if p.is_file())
    res[tag] = out
    log(f"[{tag}] " + json.dumps(out))
    return {"blob": blob, "store": bst}


def grouped_on_index(bst, Q, res) -> None:
    """The grouped kernel against its plain version on the built index's own
    leaves, at the largest leaf size."""
    import torch
    from repro_torch.kernels.distance_topk import ops, ref

    L = len(bst._n_rows) - 1
    order = np.argsort(bst._n_rows[L])[::-1][:128]
    qns = [bst.get_quantized(L, int(j)) for j in order]
    N = max(q.n_rows for q in qns)
    codes = np.zeros((len(qns), N, D), np.int8)
    for g, qn in enumerate(qns):
        codes[g, : qn.n_rows] = qn.codes
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    args = (t(Q[: len(qns)]), t(codes), t(np.array([q.scale for q in qns], np.float32)),
            t(np.array([q.offset for q in qns], np.float32)),
            t(np.array([q.n_rows for q in qns], np.int32)))
    err = 0.0
    for k in (128, N):
        dk, ik = ops.grouped_distance_topk_tensors(*args, k, "cosine", "int8")
        dp, ip = ref.grouped_distance_topk_ref(*args, k, "cosine", "int8")
        err = max(err, compare_topk(f"grouped on the index's leaves N={N} k={k}", dk, ik, dp, ip))
    res["grouped_err"] = max(res["grouped_err"], err)
    log(f"[main] grouped_distance_topk on the index's 128 largest leaves (N={N}): agree, max abs err {err:.3g}")


def scorer_on_index(bst, Q, res) -> None:
    """distance_topk against its plain version at the largest shape the leaf
    scorer gives it on the built index: the largest leaf's full-precision
    rows, zero-padded to the scorer's bucket, full selection."""
    import torch
    from repro_torch.kernels.distance_topk import ops, ref

    L = len(bst._n_rows) - 1
    emb, _ = bst.get_node(L, int(np.argmax(bst._n_rows[L])))
    n = emb.shape[0]
    n_pad = -(-n // 512) * 512  # make_kernel_scorer's default bucket
    block = torch.zeros((n_pad, D), dtype=torch.float32)
    block[:n] = torch.from_numpy(np.asarray(emb, np.float32))
    block, qv = block.cuda(), torch.from_numpy(Q[:1]).cuda()
    err = 0.0
    for metric in ("l2", "ip", "cosine"):
        dk, ik = ops.distance_topk(qv, block, n_pad, metric)
        dp, ip = ref.distance_topk_ref(qv, block, n_pad, metric)
        err = max(err, compare_topk(f"distance_topk on the index's largest leaf N_pad={n_pad} {metric}",
                                    dk, ik, dp, ip))
    res["topk_err"] = max(res["topk_err"], err)
    log(f"[main] distance_topk on the index's largest leaf ({n} rows, N_pad={n_pad}, k=N_pad): "
        f"l2/ip/cosine agree, max abs err {err:.3g}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-items", type=int, default=200_000)
    ap.add_argument("--l2-items", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device

    resolve_device("cuda")  # full float32 matmul, TF32 off
    smi = gpu_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    res: dict = {}
    t_all = time.time()
    phase_kernels(res)
    log(f"[kernels] phase done at {time.time() - t_all:.1f} s")
    from repro_torch.configs.ecpfs_paper import ECPFSPaperConfig, ecpfs_paper_full
    from repro_torch.data.synthetic import clustered_vectors

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="smoke_", dir=ROOT / "build"))
    try:
        cfg = ecpfs_paper_full()
        if args.n_items != cfg.n_items:
            log(f"reduced: n_items {cfg.n_items} -> {args.n_items} (depth of the collection; "
                "widths, dtype, metric, cluster_cap, L, b, k and batch as the paper's)")
        cfg = ECPFSPaperConfig(**{**cfg.__dict__, "n_items": args.n_items})
        t0 = time.time()
        x, _ = clustered_vectors(args.seed, n=cfg.n_items + cfg.serve_batch, dim=cfg.dim)
        data, Q = x[: cfg.n_items], x[cfg.n_items :]
        log(f"[main] data {data.shape} in {time.time() - t0:.1f} s")
        built = run_path("main", work, data, Q, cfg, res, scorer_rows=32)
        grouped_on_index(built["store"], Q, res)
        scorer_on_index(built["store"], Q, res)
        assert res["main"]["bit_identical"], "quantized search differs from the fp engine"
        log(f"[main] phase done at {time.time() - t_all:.1f} s")
        shutil.rmtree(work / "main_fs")
        (work / "main.blob").unlink()
        cfg2 = ECPFSPaperConfig(**{**cfg.__dict__, "n_items": args.l2_items, "metric": "l2"})
        x, _ = clustered_vectors(args.seed + 1, n=cfg2.n_items + cfg2.serve_batch, dim=cfg2.dim)
        run_path("l2", work, x[: cfg2.n_items], x[cfg2.n_items :], cfg2, res, scorer_rows=16)
        assert res["l2"]["bit_identical"], "l2: quantized search differs from the fp engine"
        log(f"[l2] phase done at {time.time() - t_all:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    main_launches = res["main"]["launches"]
    g, t = res["grouped"], res["topk"]
    kernels = [
        {"name": "grouped_distance_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/grouped_distance_topk.cu",
         "replaces": "src/repro/kernels/distance_topk/grouped.py:88",
         "launches": main_launches["grouped_distance_topk"],
         "max_abs_err": res["grouped_err"], "ms": g["ms"], "plain_ms": g["plain_ms"],
         "bound_ms": g["bound_ms"], "bound_by": g["bound_by"], "library_ms": g["library_ms"]},
        {"name": "distance_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/distance_topk.cu",
         "replaces": "src/repro/kernels/distance_topk/distance_topk.py:101",
         "launches": main_launches["distance_topk"],
         "max_abs_err": res["topk_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.time() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
