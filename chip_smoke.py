#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of eCP-FS (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n-items N] [--l2-items N]

Phases, none of whose failures is caught:

1. device: the card's name and power limit (``nvidia-smi``); exits non-zero
   when ``torch.cuda.is_available()`` is false.
2. kernels: builds the four CUDA sources in ``src/repro_torch/csrc`` (nvcc,
   sm_90a; prints the registers, shared memory and spills of the wgmma
   flash kernel and of the two distance kernels' main-path instantiations)
   and holds the distance kernels against their plain PyTorch versions on
   the card at the main path's shapes, then at the edges of their designs:
   grouped n_rows of 0, 1, T-1, T, T+1 and 5360 (T the row tile) at k of 1,
   128, 224 and N; rows repeated across tiles (ties keep the lower row
   first); full selection at N_pad 512, 1024 and 5632 with zero pad rows;
   back-to-back calls on one stream; every finish counter back at 0.  Two
   faults planted in copies of the grouped kernel (its merge breaking ties
   by distance alone, its work list skipping a group's last tile) must make
   these checks fail.  Times each distance kernel four ways: the wrapper
   call under CUDA events (``ms``), its kernels' own time from
   ``torch.profiler`` (``device_ms``), the same two for a library
   yardstick (timed here only, never called by the port), beside the
   bound; the grouped kernel also at the main path's skew (one leaf of
   5360 rows among 455-row ones, padded to 5360).
3. main path at the paper's widths (``configs/ecpfs_paper.py``: dim 1152,
   float16 storage, cosine, cluster_cap 455, L=2, b=64, k=100, a batch of
   128, int8 companion): build on the card -> convert(quant="int8") ->
   open_index(mode="file", quantized=True) -> search -> next(100), then a
   search through make_kernel_scorer().  Launch counters are zeroed just
   before and read just after.  Asserts bit-identity with the host fp
   engine, launch counts, and prints recall@100 against brute force, and
   the grouped kernel's time a round beside its bound (the codes of the
   rows it reads, ``quant_times["code_bytes"]``, at the memory rate).
   Then holds both kernels against their plain versions at the largest
   shapes the built index gives them (its largest leaves), and traces one
   leaf-scorer call: one CUDA kernel launch.
   Then, before the main phase's files go:
3b. serve: the serving path (``launch/serve.py``'s ``Server``) on the same
   200k collection.  (a) Interactive: the int8 v3 blob opened
   ``quantized=True``, 16 single-query searches (k=100, b=64) and 8
   ``more(100)``, each bit-identical to the fp engine; the grouped
   kernel's launches counted from 0.  (b) The write path: insert 2000
   near-duplicates of the items of 8 leaves (each found at rank 0 for its
   own vector by packed mode over the mutated blob), delete 1000 ids (none
   comes back from the fp engine), compact; every search after it is
   bit-identical to a fresh build (fstore) of the live items; prints the
   bytes written.  (c) ``Server(workers=4, queue_depth=32)``: 32 requests
   with a deadline (four times (a)'s p99 behind a full queue), 12 before,
   12 while and 8 after a writer inserts 100 near-duplicates into one
   leaf; all run at b=64, at least two generations are served (the first
   request's and, after the commit, the last 8), and each result equals a
   single-threaded search of its snapshot at the effort the scheduler
   chose.  (d) ``open_index(fstore)`` with no mode is packed mode on the
   card: 128 queries (k=100, b=64, b_internal the root's width) then
   ``more(100)``, held against a host scan of the same ranked leaves (32
   queries), ``next(100)`` against ranks 100-199 of a k=200 search, and,
   with every leaf scanned, against the file-mode fp engine (8 queries; at
   b=64 the two traversals open different leaves); asserts the scan's
   peak device memory beyond the resident index.  A packed searcher on an
   index of repeated rows keeps ties in index order; a copy whose top-k
   puts ties against index order (planted) must fail that check, and a
   copy on ``torch.topk`` (no promised tie order) is reported.
4. l2: the same steps at a smaller collection with metric l2.
5. flash: holds the flash-attention kernels against their plain version
   on the card, by element and by row (the six cases of
   tests/test_kernels.py, every head width and logits of 30, in float32
   and bf16; batch rows with kv_len = 0; the wgmma kernel's edges: Sq and
   kv_len off its 128-row tiles, one query over 32768 keys, v past kv_len
   set to 1e4; the prefill's heads in bf16 at S=4096, and at S=32768 three
   blocks of rows of the prefill's own call) and times the wgmma kernel
   against the mma.sync kernel it replaced, in turns, at S=4096 and
   S=32768.  Then plants each of FAULTS in a copy of the wgmma kernel's
   source (built alongside the real sources, in a temporary directory)
   and asserts that these checks see it.
6. lm: phi4-mini-3.8b at full width and depth (``configs/lm_archs.py``),
   random weights from a seeded generator on the card: prefill of
   ``prefill_32k``'s 32768 tokens at batch 1 with ``attn_impl="flash"``
   (32 launches of the wgmma kernel, none of the others), 16
   ``decode_step`` tokens, then the same tokens
   through the chunked plain-torch attention; asserts that the two agree at
   every step (relative L2 error of the logits, and the argmax).  The same
   run with each planted fault prints how far its logits move.

Prints a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Distances agree within 1e-4 relative:
|a - b| <= 1e-4 * max(1, |b|); ids agree except where two distances lie
within that tolerance of each other.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12, "float16": 989e12, "bfloat16": 989e12, "int8": 1979e12}
RTOL = 1e-4
D = 1152
# flash attention: the kernels against their plain version, whose p is
# float32 as the TPU kernel's.  Every kernel keeps p in float32 (the bf16
# ones feed it to the tensor cores as two bf16 parts), so one tolerance
# holds both dtypes.  By element |o - p| <= FLASH_TOL * max(1, |p|): the reference
# holds its own kernel at 2e-5, the card sums in another order.  By row
# |o - p|_2 <= FLASH_ROW_TOL * |p|_2: a late row's values are ~sqrt(e /
# keys), ~0.01 at 32768 keys, far below the elementwise bound, and one key
# more or less moves such a row by ~1/sqrt(keys / e), 9e-3 relative.
FLASH_TOL = 1e-4
# A row's error grows about in proportion to its keys, as an accumulation
# that truncates (the tensor cores' float32 adder) would make it: 1.4e-5 at
# 4096, 9.3e-5 at 32768 measured on the H100, with the mma.sync and the
# wgmma kernel alike; the planted faults give
# 2.9e-2 and more in every block checked.
FLASH_ROW_TOL = 1e-3
# faults planted in a copy of one source (library, file changed, text, its
# replacement), built beside the real ones: the checks must see each.  The
# flash ones go into the kernel the prefill runs, the distance ones into the
# grouped kernel's second level (the merge of its tiles' lists, in
# common.cuh) and its tile grid.
FAULTS = {
    "causal_off_by_one": ("flash_attention_wgmma", "flash_attention_wgmma.cu",
                          "kj <= qi + off);", "kj <= qi + off + 1);"),
    "scale_x1.01": ("flash_attention_wgmma", "flash_attention_wgmma.cu",
                    "p.scale * kLog2e", "p.scale * 1.01f * kLog2e"),
    "merge_ties_by_distance": ("grouped_distance_topk", "common.cuh",
                               "return a < b;", "return (a >> 32) <= (b >> 32);"),
    "skip_last_tile": ("grouped_distance_topk", "grouped_distance_topk.cu",
                       "return (n + kTile - 1) / kTile;", "return (n - 1) / kTile + (n <= kTile);"),
}
FLASH_CASES = [  # tests/test_kernels.py:146-153
    (2, 4, 2, 128, 128, 64, True, None),
    (2, 4, 4, 128, 128, 64, False, None),
    (1, 8, 2, 64, 256, 32, True, None),      # chunked prefill
    (2, 4, 2, 1, 192, 64, True, (100, 192)),  # ragged decode
    (2, 2, 1, 100, 100, 64, True, None),      # non-divisible seq
    (1, 2, 2, 256, 256, 128, True, None),     # d = 128
]
# lm: flash prefill + decode against the chunked plain-torch attention, by
# the relative L2 error of the logits at every step.  In bf16 chunked
# rounds p / sum to bf16 for its p v product, where the kernel keeps p in
# float32, and 32 layers carry the difference through the residual stream.
# Readings on the H100 at full depth: 1.82-2.13e-2 with the mma.sync
# kernel, 1.76-2.09e-2 with the wgmma one; with the kernel's causal mask off
# by one 0.149-0.158, with its scale off by 1% 2.3-2.9e-2 (inside the
# limit: the kernel checks above see that fault, this one does not).
LOGIT_REL_TOL = 3e-2
# The argmax may differ only between logits at most this far apart in the
# chunked run.  The logits are bf16, 1/32 apart at the top (values 4 to 8),
# so this admits three steps; random weights leave such near-ties.
# Readings on the H100: one flip in 17 steps, three steps apart (mma.sync
# kernel), two or three flips each one step (1/32) apart (wgmma kernel);
# with the causal mask off by one, five to ten flips, up to 0.38 apart.
ARGMAX_GAP = 0.1
N_DECODE = 16


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
def grouped_case(seed: int, G: int, N: int, qformat: str, *, ragged: bool, n_rows=None):
    """G groups of N-row leaf blocks from clustered data, encoded as the blob
    does; group 0 has no rows, the others ragged up to N (or ``n_rows``)."""
    import torch
    from repro_torch.core.quant import encode_node, qdtype
    from repro_torch.data.synthetic import clustered_vectors

    rng = np.random.default_rng(seed)
    x, _ = clustered_vectors(seed, n=G * N + G, dim=D)
    x = x.astype(np.float16).astype(np.float32)       # storage dtype rows
    codes = np.zeros((G, N, D), qdtype(qformat))
    scales = np.zeros(G, np.float32)
    offsets = np.zeros(G, np.float32)
    if n_rows is None:
        n_rows = rng.integers(N // 2, N + 1, size=G) if ragged else np.full(G, N)
        n_rows[0] = 0
        n_rows[1] = N
    n_rows = np.asarray(n_rows)
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


def device_time(fn, iters: int = 20, tries: int = 8) -> tuple[float, float]:
    """(ms on the card per call, summed over the call's kernels; kernels per
    call), from torch.profiler with CUDA activity around ``iters`` calls.
    Copies and memsets are not kernels and are left out.  The profiler now
    and then drops the records of kernels launched from the port's own
    libraries (seen on the H100: 3 of 5 scorer calls' kernels, late in a
    run), so a trace whose kernel count is not a positive multiple of
    ``iters`` is taken again, up to ``tries`` times."""
    import torch

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(tries):
        ks = traced_kernels(fn, iters)
        counts.append(len(ks))
        if ks and len(ks) % iters == 0:
            return sum(e.time_range.elapsed_us() for e in ks) / 1e3 / iters, len(ks) / iters
    raise AssertionError(f"torch.profiler saw {counts} kernels in {tries} traces of {iters} calls")


def traced_kernels(fn, iters: int) -> list:
    """The kernel records (no copies, no memsets) of ``iters`` calls under
    torch.profiler with CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # The calls sit 50 ms inside the trace at both ends: the records the
    # profiler dropped on the H100 were of kernels near a trace's start.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def four_ways(kern, lib, iters: int) -> dict:
    """The wrapper call and the library yardstick, each under CUDA events
    (``ms``) and by the profiler's kernel time (``device_ms``)."""
    out = {"ms": cuda_ms(kern, iters), "library_ms": cuda_ms(lib, iters)}
    out["device_ms"], out["kernels_per_call"] = device_time(kern)
    out["library_device_ms"], out["library_kernels_per_call"] = device_time(lib)
    return out


def counters_at_rest() -> None:
    """Every finish counter of the distance kernels' workspaces is back at 0."""
    import torch
    from repro_torch.kernels.distance_topk import ops

    torch.cuda.synchronize()
    for key, (_, counters) in ops.workspaces.items():
        left = int(torch.count_nonzero(counters))
        assert left == 0, f"{left} finish counters of workspace {key} are not 0 after the launches"


def edge_rows(tile: int) -> tuple:
    """n_rows around the grouped kernel's row tile, and the largest leaf."""
    return (0, 1, tile - 1, tile, tile + 1, 5360)


def tie_case(seed: int, tile: int):
    """Two int8 groups whose rows repeat across tile boundaries: group 0 is
    one tile of rows twice over (rows r and r + tile equal), group 1 has
    2 * tile + 88 rows whose last tile - 56 repeat its first ones, across
    the boundary at 2 * tile."""
    import torch

    n1 = 2 * tile + 88
    L = tile - 56
    q, codes, scales, offsets, _ = grouped_case(seed, 2, n1 + 40, "int8", ragged=False, n_rows=(2 * tile, n1))
    codes[0, tile : 2 * tile] = codes[0, :tile]
    codes[1, n1 - L : n1] = codes[1, :L]
    n_rows = torch.tensor([2 * tile, n1], dtype=torch.int32, device="cuda")
    return q, codes, scales, offsets, n_rows


def ties_in_order(what: str, dk, ik) -> None:
    """Of two entries at an equal distance, the lower index comes first."""
    dk, ik = np.asarray(dk.cpu()), np.asarray(ik.cpu())
    same = (dk[:, 1:] == dk[:, :-1]) & np.isfinite(dk[:, 1:])
    assert same.any(), f"{what}: the case has no tie"
    bad = same & (ik[:, 1:] <= ik[:, :-1])
    assert not bad.any(), f"{what}: {int(bad.sum())} ties out of index order, e.g. {np.argwhere(bad)[:3].tolist()}"


def distance_edges(tag: str) -> list[str]:
    """The distance kernels against their plain versions at the edges of
    their designs; returns what failed (empty when everything agrees).
    Launch errors are not caught."""
    import torch
    from repro_torch.kernels.distance_topk import ops, ref

    fails = []

    def check(what, fn):
        try:
            fn()
        except AssertionError as e:
            fails.append(f"{tag} {what}: {e}")

    # grouped: n_rows of 0, 1, T-1, T, T+1 and 5360 in one launch (T the
    # row tile), k of 1, 128, 224 and N, both code formats
    rows = edge_rows(ops.GROUPED_TILE)
    for qformat in ("int8", "float16"):
        args = grouped_case(21, len(rows), 5360, qformat, ragged=False, n_rows=rows)
        for k in (1, 128, 224, 5360):
            dk, ik = ops.grouped_distance_topk_tensors(*args, k, "cosine", qformat)
            dp, ip = ref.grouped_distance_topk_ref(*args, k, "cosine", qformat)
            check(f"grouped n_rows={rows} {qformat} k={k}", lambda: compare_topk("", dk, ik, dp, ip))
    # ties across tile boundaries: lower row first, whatever the k
    args = tie_case(22, ops.GROUPED_TILE)
    for k in (128, 224, 512):
        dk, ik = ops.grouped_distance_topk_tensors(*args, k, "l2", "int8")
        dp, ip = ref.grouped_distance_topk_ref(*args, k, "l2", "int8")
        check(f"grouped ties k={k}", lambda: (compare_topk("", dk, ik, dp, ip), ties_in_order("", dk, ik)))
    # full selection at the scorer's buckets, zero pad rows, and rows that
    # repeat across the blocks' lists
    rng = np.random.default_rng(23)
    for n_pad in (512, 1024, 5632):
        c = torch.from_numpy(rng.standard_normal((n_pad, D)).astype(np.float32)).cuda()
        c[n_pad - 57:] = 0
        c[n_pad // 2 : n_pad // 2 + 40] = c[:40]
        qv = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32)).cuda()
        for metric in ("l2", "cosine"):
            dk, ik = ops.distance_topk(qv, c, n_pad, metric)
            dp, ip = ref.distance_topk_ref(qv, c, n_pad, metric)
            check(f"distance_topk full N_pad={n_pad} {metric}",
                  lambda: (compare_topk("", dk, ik, dp, ip), ties_in_order("", dk, ik)))
    # back to back on one stream, no synchronisation between: a counter or a
    # list left over from one call would show in the next
    g455 = grouped_case(24, 128, 455, "int8", ragged=True)
    edge = grouped_case(25, len(rows), 5360, "int8", ragged=False, n_rows=rows)
    c512 = torch.from_numpy(rng.standard_normal((512, D)).astype(np.float32)).cuda()
    c5632 = torch.from_numpy(rng.standard_normal((5632, D)).astype(np.float32)).cuda()
    qv = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32)).cuda()
    seq = [("grouped 455 k=128", ops.grouped_distance_topk_tensors, ref.grouped_distance_topk_ref, (*g455, 128, "cosine")),
           ("grouped edges k=5360", ops.grouped_distance_topk_tensors, ref.grouped_distance_topk_ref, (*edge, 5360, "cosine")),
           ("full 512", ops.distance_topk, ref.distance_topk_ref, (qv[:1], c512, 512, "cosine")),
           ("grouped 455 k=1", ops.grouped_distance_topk_tensors, ref.grouped_distance_topk_ref, (*g455, 1, "l2")),
           ("full 5632 B=3", ops.distance_topk, ref.distance_topk_ref, (qv, c5632, 5632, "l2")),
           ("grouped edges k=224", ops.grouped_distance_topk_tensors, ref.grouped_distance_topk_ref, (*edge, 224, "ip")),
           ("full 512 B=3", ops.distance_topk, ref.distance_topk_ref, (qv, c512, 600, "ip"))]
    outs = [kern(*a) for _, kern, _, a in seq]
    torch.cuda.synchronize()
    for (what, _, plain, a), (dk, ik) in zip(seq, outs):
        dp, ip = plain(*a)
        check(f"back to back: {what}", lambda: compare_topk("", dk, ik, dp, ip))
    check("finish counters", counters_at_rest)
    return fails


def threads_on_one_stream() -> int:
    """4 threads launch both distance kernels on the default stream they
    share (as the serving scheduler's workers do), at shapes that grow the
    one (device, stream) workspace while other threads hold it: each result
    must be bit-identical to the same call run alone.  Returns the number of
    threaded calls compared."""
    import threading

    import torch
    from repro_torch.kernels.distance_topk import ops

    g = torch.Generator(device="cuda").manual_seed(7)
    calls = []
    for G, N, k in ((128, 455, 128), (128, 5360, 128), (256, 2048, 256), (1500, 300, 64)):
        args = (torch.randn(G, D, generator=g, device="cuda"),
                torch.randint(-128, 128, (G, N, D), generator=g, device="cuda", dtype=torch.int8),
                torch.rand(G, generator=g, device="cuda") * 0.01 + 1e-3,
                torch.randn(G, generator=g, device="cuda") * 0.01,
                torch.randint(0, N + 1, (G,), generator=g, device="cuda", dtype=torch.int32))
        calls.append((ops.grouped_distance_topk_tensors, (*args, k, "cosine", "int8")))
    for B, N, k in ((1, 5632, 5632), (2048, 512, 512), (16, 4096, 100)):
        calls.append((ops.distance_topk, (torch.randn(B, D, generator=g, device="cuda"),
                                          torch.randn(N, D, generator=g, device="cuda"), k, "l2")))
    ops.workspaces.clear()
    alone = [fn(*a) for fn, a in calls]
    torch.cuda.synchronize()
    ops.workspaces.clear()  # small again: the threads grow it under each other
    got, errors = {}, []

    def worker(t):
        try:
            for rep in range(3):
                for i in range(t, len(calls), 4):
                    fn, a = calls[i]
                    got[(rep, i)] = fn(*a)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads), "a kernel thread did not finish in 300 s"
    assert not errors, errors
    assert len(got) == 3 * len(calls), len(got)
    for (rep, i), (d, idx) in got.items():
        assert torch.equal(d, alone[i][0]) and torch.equal(idx, alone[i][1]), \
            f"threaded call {i} (rep {rep}) differs from the same call run alone"
    assert len(ops.workspaces) == 1, list(ops.workspaces)
    counters_at_rest()
    return len(got)


def phase_kernels(res: dict, fault_builds: dict) -> None:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.distance_topk import ops, ref

    t0 = time.time()
    _build.build_all(verbose=True)
    log(f"[kernels] built all sources in {time.time() - t0:.1f} s")
    if "flash_attention_wgmma" in _build.build_logs:
        res["wgmma_ptxas"] = ptxas_report(_build.build_logs["flash_attention_wgmma"], "flash_fwd_wgmma_kernel")
        res["wgmma_ptxas"]["smem_dynamic_bytes"] = _build.lib("flash_attention_wgmma").flash_attention_wgmma_smem_bytes()
        log(f"[kernels] flash_fwd_wgmma_kernel, ptxas: {json.dumps(res['wgmma_ptxas'])}")
    # the instantiations on the main path: int8 codes through the ring, float32 rows with 16-byte loads
    for name, kern in (("grouped_distance_topk", "grouped_tile_kernelIaLb1E"),
                       ("distance_topk", "full_select_kernelIfLb1E")):
        if name in _build.build_logs:
            res[f"{name}_ptxas"] = ptxas_report(_build.build_logs[name], kern)
            log(f"[kernels] {kern}, ptxas: {json.dumps(res[f'{name}_ptxas'])}")

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
    del qb, cb

    # ---- the edges of both designs, then the planted distance faults
    fails = distance_edges("real kernels")
    assert not fails, "distance kernels disagree at their edges:\n" + "\n".join(fails)
    log(f"[kernels] edges agree: grouped n_rows {edge_rows(ops.GROUPED_TILE)} at k=1/128/224/N (int8, float16), "
        "ties across tiles in row order, full selection at N_pad 512/1024/5632 with zero pads and repeated "
        "rows, back-to-back calls, finish counters at 0")
    n_thr = threads_on_one_stream()
    log(f"[kernels] 4 threads on the default stream, one shared workspace grown under them: {n_thr} calls "
        "bit-identical to the same calls run alone")
    for name, fault in load_faults(fault_builds, "grouped_distance_topk").items():
        with planted(fault):
            seen = distance_edges(name)
        counters_at_rest()
        assert seen, f"the distance checks do not see the planted fault {name}"
        log(f"[kernels] planted fault {name}: {len(seen)} checks fail, first: {seen[0][:300]}")

    # ---- timing, four ways: G=128 units at a 455-row leaf, int8, cosine
    G, N, k = 128, 455, 128
    args = grouped_case(5, G, N, "int8", ragged=False)
    q, codes, scales, offsets, n_rows = args
    kern = lambda: ops.grouped_distance_topk_tensors(*args, k, "cosine", "int8")
    # yardstick: decode, one batched product (inner-product scores), top-k
    lib = lambda: torch.topk(torch.bmm(codes.float() * scales[:, None, None] + offsets[:, None, None],
                                       q[:, :, None])[..., 0], k, dim=1)
    g = four_ways(kern, lib, 50)
    g["plain_ms"] = cuda_ms(lambda: ref.grouped_distance_topk_ref(*args, k, "cosine", "int8"), 20)
    host = torch.empty(codes.numel(), dtype=torch.int8, pin_memory=True)
    dev = torch.empty_like(codes).view(-1)
    g["h2d_ms"] = cuda_ms(lambda: dev.copy_(host, non_blocking=True), 20)
    g["bound_ms"], g["bound_by"] = grouped_bound_ms(G, int(n_rows.sum()), k)
    g["h2d_bytes"] = codes.numel()
    res["grouped"] = g
    log(f"[kernels] grouped_distance_topk G={G} N={N} D={D} int8 cosine k={k}: " + json.dumps(g))
    del host, dev
    # the main path's skew: one leaf of 5360 rows, 127 of 455, all padded to
    # 5360 as the search pads a round
    NS = 5360
    big = torch.zeros((G, NS, D), dtype=torch.int8, device="cuda")
    big[:, :N] = codes
    big[0] = torch.randint(-128, 128, (NS, D), dtype=torch.int8, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(6))
    nr = torch.full((G,), N, dtype=torch.int32, device="cuda")
    nr[0] = NS
    sargs = (q, big, scales, offsets, nr)
    dk, ik = ops.grouped_distance_topk_tensors(*sargs, k, "cosine", "int8")
    dp, ip = ref.grouped_distance_topk_ref(*sargs, k, "cosine", "int8")
    res["grouped_err"] = max(res["grouped_err"], compare_topk("grouped skew", dk, ik, dp, ip))
    slib = lambda: torch.topk(torch.bmm(big.float() * scales[:, None, None] + offsets[:, None, None],
                                        q[:, :, None])[..., 0], k, dim=1)
    sk = four_ways(lambda: ops.grouped_distance_topk_tensors(*sargs, k, "cosine", "int8"), slib, 20)
    sk["bound_ms"], sk["bound_by"] = grouped_bound_ms(G, int(nr.sum()), k)
    res["grouped_skew"] = sk
    log(f"[kernels] grouped_distance_topk skew G={G} n_rows 5360 + 127 x 455 (padded to {NS}) int8 cosine k={k}: "
        + json.dumps(sk))
    del big, sargs, dp, ip
    torch.cuda.empty_cache()

    # ---- timing, four ways: the scorer's full selection, B=1, k=N_pad, f32, cosine
    res["topk_by_n"] = {}
    for n_pad in (512, 1024, 5632):
        c = torch.from_numpy(rng.standard_normal((n_pad, D)).astype(np.float32)).cuda()
        qv = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32)).cuda()
        t = four_ways(lambda: ops.distance_topk(qv, c, n_pad, "cosine"),
                      lambda: torch.topk(torch.mm(qv, c.T), n_pad, dim=1), 100)
        t["plain_ms"] = cuda_ms(lambda: ref.distance_topk_ref(qv, c, n_pad, "cosine"), 50)
        t["bound_ms"], t["bound_by"] = topk_bound_ms(1, n_pad, n_pad)
        assert t["kernels_per_call"] == 1.0, f"distance_topk makes {t['kernels_per_call']} launches a call"
        res["topk_by_n"][n_pad] = t
        log(f"[kernels] distance_topk B=1 N_pad={n_pad} D={D} f32 cosine k={n_pad}: {json.dumps(t)}")
    res["topk"] = res["topk_by_n"][512]
    counters_at_rest()


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
        # the kernel's least time: the codes it reads (valid rows only) at the memory rate
        "kernel_bound": qt["code_bytes"] / HBM_BYTES_PER_S * 1e3 / n,
        "rerank": qt["rerank_ms"] / n, "h2d_mb": qt["h2d_bytes"] / 1e6 / n,
        "code_mb": qt["code_bytes"] / 1e6 / n,
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
    pr = out["per_round_ms"]
    log(f"[{tag}] grouped kernel a round: {pr['kernel']:.6f} ms against its bound {pr['kernel_bound']:.6f} ms "
        f"({pr['code_mb']:.3f} MB of codes a round at {HBM_BYTES_PER_S / 1e12} TB/s; "
        f"{pr['h2d_mb']:.3f} MB staged with the padding), {qt['rounds']} rounds")
    return {"blob": blob, "store": bst, "fs": fs, "fp_ids": frs.ids}


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
    ops_args = (qv, block, n_pad, "cosine")
    err = 0.0
    for metric in ("l2", "ip", "cosine"):
        dk, ik = ops.distance_topk(qv, block, n_pad, metric)
        dp, ip = ref.distance_topk_ref(qv, block, n_pad, metric)
        err = max(err, compare_topk(f"distance_topk on the index's largest leaf N_pad={n_pad} {metric}",
                                    dk, ik, dp, ip))
    res["topk_err"] = max(res["topk_err"], err)
    log(f"[main] distance_topk on the index's largest leaf ({n} rows, N_pad={n_pad}, k=N_pad): "
        f"l2/ip/cosine agree, max abs err {err:.3g}")
    # one call of the leaf scorer, as the search makes it, under the profiler
    from repro_torch.core import make_kernel_scorer

    scorer = make_kernel_scorer()
    call = lambda: scorer(Q[0], emb, "cosine")
    call()
    seen = []
    for _ in range(16):
        n0 = ops.launches["distance_topk"]
        ks = bracketed_kernels(call, lambda: ops.distance_topk(*ops_args), "ecp::")
        assert ops.launches["distance_topk"] - n0 == 4, "a scorer call is not one wrapper call"
        if ks is None:
            seen.append("markers lost")
            continue
        seen.append([e.name.split("(")[0] for e in ks])
        # a dropped record can only hide a launch, never add one: no trace
        # may show more than one, and one must show exactly one
        assert len(ks) <= 1, f"one scorer call launched {len(ks)} kernels: {seen[-1]}"
        if len(ks) == 1:
            break
    assert ks, f"no trace of a scorer call kept its kernel: {seen}"
    res["scorer_call"] = {"kernels": len(ks), "kernel": seen[-1][0], "traces": len(seen),
                          "device_ms": ks[0].time_range.elapsed_us() / 1e3, "rows": n}
    log(f"[main] one leaf-scorer call on the largest leaf under torch.profiler: {len(ks)} CUDA kernel "
        f"launch ({seen[-1][0]}, {res['scorer_call']['device_ms']:.6f} ms; {len(seen)} trace(s))")


def bracketed_kernels(call, warm, prefix: str):
    """The kernel records named ``prefix``... of one ``call``, from a trace
    in which three ``warm`` calls come first (the profiler dropped records
    of the port's kernels early in a trace on the H100) and one of
    PyTorch's own kernels marks each side of the call; None if the trace
    lost a marker."""
    import torch

    marker = torch.zeros(1, device="cuda")

    def traced():
        for _ in range(3):
            warm()
        marker.add_(1)
        call()
        marker.add_(1)

    ks = sorted(traced_kernels(traced, 1), key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(ks) if prefix not in e.name]
    if len(marks) != 2:
        return None
    return ks[marks[0] + 1 : marks[1]]


# ------------------------------------------------------------------ serve
def bytes_written() -> int | None:
    """Bytes this process has passed to write calls (``wchar`` of
    ``/proc/self/io``: every ``write``/``pwrite``, page cache or not; the
    storage layer's own ``write_bytes`` reads 0 on the chip machine)."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("wchar:"):
                return int(line.split()[1])
    except OSError:
        return None
    return None


def same_rs(what: str, a, b) -> None:
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists), f"{what}: results differ"


def ties_in_index_order(what: str, rs, copies: int) -> None:
    """Equal distances keep index order: in every run of equal distances
    the ids ascend (each vector's ``copies`` copies hold consecutive ids,
    next to each other in one leaf, and tie exactly)."""
    d, ids = rs.dists, rs.ids
    for r in range(len(d)):
        for j in range(1, d.shape[1]):
            if d[r, j] == d[r, j - 1]:
                assert ids[r, j] > ids[r, j - 1], f"{what}: row {r} pos {j}: tie out of index order"


def topk_by_distance(d, ids, k):
    """``torch.topk``: a top-k by distance alone, whose order among ties
    PyTorch does not promise."""
    import torch

    v, order = torch.topk(d, k, dim=-1, largest=False, sorted=True)
    return v, torch.gather(ids, -1, order)


def planted_topk(d, ids, k):
    """The planted fault: a top-k whose ties come out against index order
    (the last index first), by a stable sort of the reversed row."""
    import torch

    n = d.shape[-1]
    order = (n - 1) - torch.sort(d.flip(-1), dim=-1, stable=True).indices[..., :k]
    return torch.gather(d, -1, order), torch.gather(ids, -1, order)


def packed_tie_check(work: Path, seed: int, res: dict) -> None:
    """The packed searcher keeps equal distances in index order on an index
    of repeated rows at the paper's width; a copy whose top-k breaks ties
    by distance alone (the planted fault) must fail the same check."""
    from repro_torch.configs.ecpfs_paper import ECPFSPaperConfig, build_cfg
    from repro_torch.core import BatchedSearcher, build_index, load_packed
    from repro_torch.data.synthetic import clustered_vectors

    copies = 4
    base, _ = clustered_vectors(seed + 5, n=1024 + 16, dim=D)
    data = np.repeat(base[:1024], copies, axis=0)
    fs = work / "ties_fs"
    build_index(data, str(fs), build_cfg(ECPFSPaperConfig(n_items=len(data))))
    packed = load_packed(str(fs))
    Qt = base[1024:]
    good = BatchedSearcher(packed)
    rs = good.search(Qt, 40, b=4)
    groups = rs.dists.reshape(len(Qt), -1, copies)
    exact = float(np.mean(np.all(groups == groups[..., :1], axis=-1)))
    assert exact == 1.0, f"the copies' distances do not tie exactly ({exact:.3f} of groups do)"
    ties_in_index_order("packed ties", rs, copies)
    found = {}
    for name, topk in (("torch.topk", topk_by_distance), ("planted", planted_topk)):
        other = BatchedSearcher(packed)
        other._topk = topk
        try:
            ties_in_index_order(name, other.search(Qt, 40, b=4), copies)
            found[name] = False
        except AssertionError as e:
            found[name] = str(e)
        del other
    assert found["planted"], "the planted tie fault (ties against index order) passed the tie check"
    res["serve"]["ties"] = {"groups_tied": exact, **found}
    log(f"[serve] packed tie check on {len(data)} rows ({copies} copies each, dim {D}): ties in index "
        f"order; planted fault (ties against index order) seen: {found['planted']}; a copy on "
        f"torch.topk (no promised tie order) broke it here: {found['torch.topk']}")
    shutil.rmtree(fs)


def phase_serve(work: Path, data, Q, cfg, res: dict, built: dict, seed: int) -> None:
    """The serving path of ``launch/serve.py`` on the main phase's 200k
    collection, through ``Server``: (a) interactive quantized file mode,
    (b) the write path, (c) the 4-worker scheduler over snapshots while a
    writer inserts, (d) the batched server, packed mode on the card."""
    import threading

    import torch
    from repro_torch.configs.ecpfs_paper import build_cfg
    from repro_torch.core import BatchedSearcher, build_index, open_index
    from repro_torch.kernels.distance_topk import ops
    from repro_torch.launch.serve import Server

    out = res.setdefault("serve", {})
    blob, fs, bst = built["blob"], built["fs"], built["store"]
    L, k, b = cfg.levels, cfg.k, cfg.b
    w0 = bytes_written()
    rng = np.random.default_rng(seed + 7)
    t_phase = time.perf_counter()

    # ---------------- (a) interactive: single requests, quantized, on the card
    fp = open_index(str(blob), mode="file")          # the port's fp engine, same file
    srv = Server(open_index(str(blob), mode="file", quantized=True))
    ops.reset_launches()
    sess = []
    for r in range(16):
        rs, sid = srv.search(Q[r], k=k, b=b)
        sess.append((sid, rs))
    more = [srv.more(sid, k) for sid, _ in sess[:8]]
    out["interactive_launches"] = dict(ops.launches)
    for r, (sid, rs) in enumerate(sess):
        f = fp.search(Q[r], k, b=b)
        same_rs(f"serve (a) search {r}", rs, f)
        if r < 8:
            same_rs(f"serve (a) more {r}", more[r], f.query.next(k))
        srv.close(sid)
    assert out["interactive_launches"]["grouped_distance_topk"] > 0, out["interactive_launches"]
    out["interactive"] = srv.stats.summary()
    out["part_s"] = {"a": time.perf_counter() - t_phase}
    log(f"[serve] (a) 16 searches + 8 more(100), bit-identical to the fp engine; launches "
        f"{out['interactive_launches']}; {json.dumps(out['interactive'])}")

    # ---------------- (b) the write path: insert, delete, compact
    n0 = len(data)
    rows = bst._n_rows[L]
    pick = rng.choice([j for j in range(len(rows)) if rows[j] >= 250], 8, replace=False)
    src_ids = np.concatenate([bst.get_node_ids(L, int(j))[:250] for j in pick])
    # near-duplicates close enough to route to their originals' 8 leaves:
    # every node write rewrites a whole slot of the blob (the largest
    # leaf's stride, 24.8 MB), so an insert spread over the index writes
    # 5-6 MB an item (190 leaves and 261 splits for 2000 items at 0.01)
    new = (data[src_ids] + 0.001 * rng.standard_normal((len(src_ids), D))).astype(np.float32)
    new_ids = np.arange(n0, n0 + len(new))
    steps = {}  # seconds of each step of (b)
    t0 = time.perf_counter()
    ins = srv.insert(new, new_ids)
    out["insert_s"] = steps["insert"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # each at rank 0 for its own vector: packed mode over the mutated blob
    # (no tombstones yet), 128 queries a call, b and b_internal as in (d);
    # the host engines take 1-2 minutes for 2000 queries at b=64
    pk = open_index(str(blob), mode="packed")
    top = np.concatenate([
        pk.search(new[i : i + 128], k=1, b=b, b_internal=pk.info.nodes_per_level[0]).ids
        for i in range(0, len(new), 128)
    ])
    del pk
    torch.cuda.empty_cache()
    found = float(np.mean(top[:, 0] == new_ids))
    assert found == 1.0, f"only {found:.4f} of the inserted items come back at rank 0 for their own vector"
    steps["rank0_check"] = time.perf_counter() - t0
    del_ids = np.concatenate([rng.choice(new_ids, 500, replace=False),
                              rng.choice(np.setdiff1d(np.arange(n0), src_ids), 500, replace=False)])
    t0 = time.perf_counter()
    n_del = srv.delete(del_ids)
    out["delete_s"] = steps["delete"] = time.perf_counter() - t0
    assert n_del == 1000, n_del
    t0 = time.perf_counter()
    vecs = np.concatenate([data, new])
    reader = open_index(str(blob), mode="file")  # the fp engine, a reader of the same file
    rs = reader.search(vecs[del_ids], k=10, b=8)
    assert not np.isin(rs.ids, del_ids).any(), "a deleted id came back"
    reader.close()
    steps["deleted_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    comp = srv.compact()
    out["compact_s"] = steps["compact"] = time.perf_counter() - t0
    live = np.ones(n0 + len(new), bool)
    live[del_ids] = False
    stored = vecs.astype(np.float16).astype(np.float32)
    fresh = work / "fresh_fs"
    t0 = time.perf_counter()
    build_index(stored[live], str(fresh), build_cfg(cfg), item_ids=np.flatnonzero(live))
    out["fresh_build_s"] = steps["fresh_build"] = time.perf_counter() - t0
    del stored
    t0 = time.perf_counter()
    ffp = open_index(str(fresh), mode="file")
    for r in range(16):
        rs, sid = srv.search(Q[r], k=k, b=b)
        f = ffp.search(Q[r], k, b=b)
        same_rs(f"serve (b) after compact, search {r}", rs, f)
        if r < 4:
            same_rs(f"serve (b) after compact, more {r}", srv.more(sid, k), f.query.next(k))
        srv.close(sid)
    steps["after_compact_check"] = time.perf_counter() - t0
    w1 = bytes_written()
    out["write_path"] = {"insert": ins, "deleted": n_del, "compact": comp, "rank0_found": found,
                         "bytes_written": None if w0 is None else w1 - w0, "step_s": steps}
    log(f"[serve] (b) insert {len(new)} ({out['insert_s']:.3f} s, {ins['splits']} splits, {ins['leaves']} leaves), "
        f"each at rank 0 for its own vector; delete 1000 ({out['delete_s']:.3f} s), none comes back; "
        f"compact {out['compact_s']:.3f} s {comp}; 16 searches + 4 more after it bit-identical to a fresh "
        f"build of the live items ({out['fresh_build_s']:.3f} s); bytes written by (a)-(b): "
        f"{out['write_path']['bytes_written']}; seconds by step {json.dumps(steps)}")
    srv.shutdown()
    shutil.rmtree(fresh)
    out["part_s"]["b"] = time.perf_counter() - t_phase - sum(out["part_s"].values())

    # ---------------- (c) concurrent: 4 workers over snapshots while a writer inserts
    csrv = Server(open_index(str(blob), mode="file", quantized=True), workers=4, queue_depth=32)
    # 100 near-duplicates of the items of one leaf of the compacted tree
    st = csrv.searcher.store
    rows = st.node_rows([(L, j) for j in range(csrv.searcher.info.nodes_per_level[-1])])
    fits = [j for j, n in enumerate(rows) if 100 <= n <= cfg.cluster_cap - 100]
    j0 = fits[0] if fits else int(np.argmax(rows))
    more_new = (vecs[st.get_node_ids(L, j0)[:100]] + 0.001 * rng.standard_normal((100, D))).astype(np.float32)
    base_id = int(csrv.searcher.info.next_id)
    gen0 = int(csrv.searcher.info.generation)
    # a deadline that (a)'s slowest request fits into four times over behind
    # a full queue (32 requests on 4 workers): every request runs at b
    deadline_ms = 4.0 * out["interactive"]["search_p99_ms"] * (32 // 4 + 1)
    ops.reset_launches()
    t0 = time.perf_counter()
    submit = lambda r: csrv.scheduler.submit(Q[r], k, b=b, deadline_ms=deadline_ms)
    futs = [submit(r) for r in range(12)]
    futs[0].result(timeout=300)  # one request has leased generation gen0 before the insert starts
    writer = threading.Thread(target=lambda: csrv.insert(more_new, np.arange(base_id, base_id + 100)))
    writer.start()
    futs += [submit(r) for r in range(12, 24)]  # while the insert runs
    writer.join(timeout=300)
    assert not writer.is_alive(), "the insert under the workers did not finish in 300 s"
    futs += [submit(r) for r in range(24, 32)]  # after it committed
    got = [f.result(timeout=300) for f in futs]
    out["concurrent_s"] = time.perf_counter() - t0
    out["concurrent_launches"] = dict(ops.launches)
    gen1 = int(csrv.searcher.info.generation)
    gens = {}
    for r, g in enumerate(got):
        again = g.lease.search(Q[r], k, b=g.b_effective)
        same_rs(f"serve (c) request {r} (generation {g.lease.generation}, b {g.b_effective})", g.rs, again)
        gens[g.lease.generation] = gens.get(g.lease.generation, 0) + 1
        g.lease.release()
    assert out["concurrent_launches"]["grouped_distance_topk"] > 0, out["concurrent_launches"]
    assert all(g.b_effective == b for g in got), f"requests ran below b={b}: {[g.b_effective for g in got]}"
    assert gen1 > gen0 and got[0].lease.generation == gen0, (gen0, gen1, gens)
    assert all(g.lease.generation == gen1 for g in got[24:]), gens
    out["concurrent"] = {"scheduler": csrv.scheduler.stats.as_dict(), "generations": gens,
                         "deadline_ms": deadline_ms, "b_effective": sorted({g.b_effective for g in got}),
                         "latency_ms": [g.queue_wait_ms for g in got]}
    log(f"[serve] (c) 32 requests on 4 workers in {out['concurrent_s']:.3f} s while 100 items were inserted "
        f"(12 before, 12 during, 8 after the insert), deadline {deadline_ms:.1f} ms: all at b={b}; each equals "
        f"a single-threaded search of its snapshot; generations {gens} (before {gen0}, after {gen1}); launches "
        f"{out['concurrent_launches']}; scheduler {json.dumps(out['concurrent']['scheduler'])}")
    csrv.shutdown()
    out["part_s"]["c"] = time.perf_counter() - t_phase - sum(out["part_s"].values())

    # ---------------- (d) batched: open_index(fs) with no mode is packed mode on the card
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs = open_index(str(fs))
    torch.cuda.synchronize()
    out["packed_load_s"] = time.perf_counter() - t0
    assert isinstance(bs, BatchedSearcher) and bs.device.type == "cuda", type(bs)
    w = bs.info.nodes_per_level[0]
    n_leaves = bs.info.nodes_per_level[-1]
    bsrv = Server(bs)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rs, sid = bsrv.search(Q, k=k, b=b, b_internal=w)
    out["batched_search_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nx = bsrv.more(sid, k)
    out["batched_more_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - resident
    cap = bs.leaf.emb.shape[1]
    C = max(4 * k, 256)
    # the scan's own memory: one leaf block (the budget), the chunk's
    # distances, ids and mask, and the merge's inputs, sort and outputs
    limit = bs.scan_budget_bytes + 8 * len(Q) * (C + b * cap) * 8
    out["batched_launches"] = dict(ops.launches)
    assert peak <= limit, f"the packed scan took {peak} B beyond the resident index (limit {limit})"
    state = rs.query.state
    r200 = bs.search(Q, 2 * k, b=b, b_internal=w)
    assert np.array_equal(nx.ids, r200.ids[:, k:]) and np.array_equal(nx.dists, r200.dists[:, k:]), \
        "next(100) is not ranks 100-199 of a k=200 search"
    # the function: each query's top k of the rows of its first b ranked
    # leaves, scanned on the host (np_distances) in the same order; 32 of
    # the queries, to keep the host's share of the phase small
    from repro_torch.core.distances import np_distances

    ranked = state.leaf_rank[:, :b].cpu().numpy()
    fsi = open_index(str(fs), mode="file")
    err = 0.0
    for r in range(32):
        nodes = fsi.get_nodes([(L, int(j)) for j in ranked[r] if j >= 0])
        emb = np.concatenate([e for e, _ in nodes])
        ids = np.concatenate([i for _, i in nodes])
        d = np_distances(Q[r], emb, cfg.metric)
        o = np.argsort(d, kind="stable")[:k]
        err = max(err, compare_topk(f"serve (d) packed row {r} vs host scan of its leaves",
                                    rs.dists[r:r + 1], rs.ids[r:r + 1], d[o][None], ids[o][None]))
    # against the file-mode fp engine: both exhaustive (every leaf), so the
    # two traversals see the same rows
    pe = bs.search(Q[:8], k, b=n_leaves, b_internal=w)
    fe = fsi.search(Q[:8], k, b=n_leaves)
    compare_topk("serve (d) packed vs file mode, every leaf", pe.dists, pe.ids, fe.dists, fe.ids)
    overlap = float(np.mean([len(set(rs.ids[r]) & set(built["fp_ids"][r])) / k for r in range(len(Q))]))
    bsrv.close(sid)
    out["batched"] = {"summary": bsrv.stats.summary(), "device_bytes": bs.device_bytes,
                      "scan_peak_bytes": int(peak), "scan_peak_limit": int(limit),
                      "leaves": n_leaves, "cap_padded": cap, "max_abs_err": err,
                      "overlap_with_file_mode_at_b": overlap}
    log(f"[serve] (d) packed: resident {bs.device_bytes / 1e9:.3f} GB ({n_leaves} leaves padded to {cap} rows), "
        f"loaded in {out['packed_load_s']:.3f} s; 128 queries k={k} b={b} b_internal={w}: "
        f"{out['batched_search_s'] * 1e3:.3f} ms, more({k}) {out['batched_more_s'] * 1e3:.3f} ms; scan peak "
        f"{peak / 1e9:.3f} GB beyond the index (limit {limit / 1e9:.3f}); host scan of the same leaves agrees "
        f"(32 queries) "
        f"(max abs err {err:.3g}); next = ranks {k}-{2 * k - 1} of k={2 * k}; with every leaf scanned, ids agree "
        f"with file mode (8 queries); at b={b} the two traversals share {overlap:.4f} of their top {k}; launches "
        f"{out['batched_launches']}")
    bsrv.shutdown()
    del bs, state
    torch.cuda.empty_cache()
    out["part_s"]["d"] = time.perf_counter() - t_phase - sum(out["part_s"].values())
    packed_tie_check(work, seed, res)
    out["part_s"]["ties"] = time.perf_counter() - t_phase - sum(out["part_s"].values())
    w2 = bytes_written()
    out["bytes_written"] = None if w0 is None else w2 - w0
    log(f"[serve] seconds by part {json.dumps(out['part_s'])}; bytes written by this process in the "
        f"phase: {out['bytes_written']}; in the run so far: {w2}")


# ------------------------------------------------------------ flash kernel
def flash_ops(B, Hq, Sq, Skv, d, lens, causal) -> int:
    """Operations one call needs: 4*d (two multiply-adds) per live (query
    head, query, key) triple, counted from this call's kv_lens and mask."""
    i = np.arange(Sq)
    pairs = 0
    for L in (lens if lens is not None else [Skv] * B):
        valid = min(max(int(L), 0), Skv)
        pairs += int(np.clip(i + int(L) - Sq + 1, 0, valid).sum()) if causal else Sq * valid
    return 4 * Hq * d * pairs


def flash_bound_ms(B, Hq, Hkv, Sq, Skv, d, lens, causal, itemsize):
    """Least time for one call: ``flash_ops`` at the bf16 tensor-core rate,
    against q, k, v read once and the float32 output written once at the
    memory rate."""
    ops = flash_ops(B, Hq, Sq, Skv, d, lens, causal)
    nbytes = (B * Hq * Sq * d + 2 * B * Hkv * Skv * d) * itemsize + B * Hq * Sq * d * 4
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["bfloat16"] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def flash_turns(new, old, iters: int, warmup: int) -> dict:
    """The wgmma kernel and the mma.sync one it replaced, timed in turns
    (new, old, old, new) on the same inputs; means of each pair."""
    t = [cuda_ms(f, iters, warmup) for f in (new, old, old, new)]
    return {"ms": (t[0] + t[3]) / 2, "mma_sync_ms": (t[1] + t[2]) / 2, "turns_ms": t}


def tflops(n_ops: int, ms: float) -> float:
    return n_ops / (ms * 1e-3) / 1e12


def ptxas_report(log_text: str, kernel: str) -> dict:
    """Registers, shared memory and spills of one kernel from nvcc's -Xptxas -v output."""
    import re

    blocks = log_text.split("Compiling entry function")
    hit = [b for b in blocks[1:] if kernel in b.splitlines()[0]]
    assert hit, f"ptxas said nothing of {kernel}"
    b = hit[0]
    num = lambda pat: int(m.group(1)) if (m := re.search(pat, b)) else None
    # ptxas names the kernel in its warnings (e.g. C7512, wgmma serialized) before the entry's block
    notes = [ln.strip() for ln in log_text.splitlines()
             if kernel in ln and ("warning" in ln.lower() or "Performance" in ln or "(C7" in ln)]
    return {"registers_at_entry": num(r"Used (\d+) registers"), "smem_static_bytes": num(r"(\d+) bytes smem") or 0,
            "spill_stores": num(r"(\d+) bytes spill stores"), "spill_loads": num(r"(\d+) bytes spill loads"),
            "stack_bytes": num(r"(\d+) bytes stack frame"), "notes": notes}


def flash_inputs(seed, B, Hq, Hkv, Sq, Skv, d, dtype):
    """q as the model hands it over (a [B, Sq, Hq, d] projection viewed as
    [B, Hq, Sq, d]), k and v contiguous; numpy normals from ``seed``."""
    import torch

    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hq, d), dtype=np.float32)).cuda().to(dtype)
    k = torch.from_numpy(rng.standard_normal((B, Hkv, Skv, d), dtype=np.float32)).cuda().to(dtype)
    v = torch.from_numpy(rng.standard_normal((B, Hkv, Skv, d), dtype=np.float32)).cuda().to(dtype)
    return q.transpose(1, 2), k, v


def flash_errs(o, p) -> tuple[float, float]:
    """Largest absolute error, and largest error of a row (last axis) in L2
    relative to the plain row's norm; a row of 0 in the plain version must
    be 0 (its relative error is then 0, else inf)."""
    import torch

    diff = (o - p).float()
    num, den = diff.norm(dim=-1), p.float().norm(dim=-1)
    rel = torch.where(num == 0, torch.zeros_like(num), num / den)
    return float(diff.abs().max()) if o.numel() else 0.0, float(rel.max()) if o.numel() else 0.0


def flash_check(what, o, p) -> tuple[float, float]:
    """The kernel's output o against the plain version's p, by element and
    by row; returns (max abs err, max row relative err)."""
    import torch

    assert torch.isfinite(o).all(), f"flash {what}: non-finite output"
    err, row = flash_errs(o, p)
    bad = (o - p).abs() > FLASH_TOL * torch.clamp_min(p.abs(), 1.0)
    assert not bad.any(), f"flash {what}: {int(bad.sum())} entries off, max abs err {err}"
    assert row <= FLASH_ROW_TOL, f"flash {what}: a row is off by {row} relative (L2)"
    return err, row


def flash_pair(q, k, v, lens=None, causal=True):
    """The kernel's and the plain version's output on the same inputs."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    o = ops.flash_attention(q, k, v, kv_lens=kv_lens, causal=causal)
    return o, ref.flash_attention_ref(q, k, v, kv_lens=kv_lens, causal=causal)


# rows of a causal Sq = Skv = S call held against the plain version: a block
# [i0, i0 + n) of queries against the first i0 + n keys is exactly the
# plain version's rows i0.. of the whole call (the last query aligns with
# the last key), with [1, Hq, n, i0 + n] scores instead of [1, Hq, S, S]
def row_blocks(S: int, n: int = 256) -> list[int]:
    return [0, S // 2 - n // 2, S - n]


def causal_rows(o, q, k, v, i0: int, n: int):
    from repro_torch.kernels.flash_attention import ref

    e = i0 + n
    return o[:, :, i0:e], ref.flash_attention_ref(q[:, :, i0:e], k[:, :, :e], v[:, :, :e], causal=True)


def phase_flash(res: dict, fault_libs: dict) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    err = row = 0.0
    checks = 0

    def check(what, o, p):
        nonlocal err, row, checks
        e, r = flash_check(what, o, p)
        err, row, checks = max(err, e), max(row, r), checks + 1

    for dt in (torch.float32, torch.bfloat16):
        for c, (B, Hq, Hkv, Sq, Skv, d, causal, lens) in enumerate(FLASH_CASES):
            q, k, v = flash_inputs(100 + c, B, Hq, Hkv, Sq, Skv, d, dt)
            check(f"{dt} case {c}", *flash_pair(q, k, v, lens, causal))
        for d in (16, 32, 48, 80, 96, 112):  # every other head width the kernels take
            q, k, v = flash_inputs(d, 2, 4, 2, 70, 130, d, dt)
            check(f"{dt} d={d}", *flash_pair(q, k, v, (130, 90), True))
        for dl in (32, 128):  # logits of 30 (scores near 5000 and 10000)
            q = torch.full((1, 1, 64, dl), 30.0, device="cuda", dtype=dt)
            v = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 1, 64, dl), dtype=np.float32)).cuda().to(dt)
            check(f"{dt} logits of 30 d={dl}", *flash_pair(q, q.clone(), v))
        for causal in (True, False):  # a row with no live key is 0; its neighbour is unaffected
            for Sq in (1, 64):
                q, k, v = flash_inputs(7 + Sq, 2, 4, 2, Sq, 300, 128, dt)
                o, p = flash_pair(q, k, v, (0, 300), causal)
                assert bool((o[0] == 0).all()), "flash: a row with kv_len 0 is not 0"
                check(f"{dt} kv_len 0 Sq={Sq} causal={causal}", o, p)
    log(f"[flash] the six reference cases, d=16..128, logits of 30 and rows with kv_len 0 (which are 0) "
        f"agree in float32 and bf16 ({checks} checks; max abs err {err:.3g}, max row err {row:.3g}; "
        f"limits {FLASH_TOL} by element, {FLASH_ROW_TOL} by row)")

    # the wgmma kernel's edges (bf16, d = 128, phi4-mini's heads): Sq and
    # kv_len not multiples of its 128-row tiles, one query over 32768 keys,
    # and v rows past kv_len set to 1e4, where only an exact p = 0 keeps
    # the rows right
    Hq, Hkv, d = 24, 8, 128  # phi4-mini's attention
    n0 = ops.launches["flash_attention_wgmma"]
    edges = [(2, 4173, 4173, (4173, 1000), True), (2, 4173, 4173, (4173, 1000), False),
             (1, 1, 32768, None, True), (2, 1, 32768, (32768, 20001), True)]
    for c, (B, Sq, Skv, lens, causal) in enumerate(edges):
        q, k, v = flash_inputs(40 + c, B, Hq, Hkv, Sq, Skv, d, torch.bfloat16)
        for b, L in enumerate(lens or ()):
            v[b, :, L:] = 1e4
        check(f"bf16 edge B={B} Sq={Sq} Skv={Skv} kv_lens={lens} causal={causal}", *flash_pair(q, k, v, lens, causal))
    assert ops.launches["flash_attention_wgmma"] - n0 == len(edges), ops.launches
    del q, k, v
    log(f"[flash] wgmma kernel edges agree: S=4173 with kv_lens (4173, 1000) causal and not, Sq=1 over "
        f"32768 keys, v past kv_len = 1e4 (max abs err so far {err:.3g}, max row err {row:.3g})")

    q, k, v = flash_inputs(11, 1, Hq, Hkv, 4096, 4096, d, torch.bfloat16)
    o4, p4 = flash_pair(q, k, v)
    check("bf16 1x24x4096x128", o4, p4)
    check("bf16 1x24x4096x128, the mma.sync kernel", ops.flash_attention_mma(q, k, v), p4)
    qc = q.contiguous()
    lib = lambda: F.scaled_dot_product_attention(qc, k, v, is_causal=True, enable_gqa=True)
    lib_err = float((lib().float() - o4).abs().max())
    log(f"[flash] bf16 [1,24,4096,128] x [1,8,4096,128] causal agrees, wgmma and mma.sync kernels (max abs "
        f"err so far {err:.3g}, max row err {row:.3g}; the library yardstick differs by {lib_err:.3g})")
    t4 = flash_turns(lambda: ops.flash_attention(q, k, v), lambda: ops.flash_attention_mma(q, k, v), 10, 2)
    t4["plain_ms"] = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 5, 1)
    t4["library_ms"] = cuda_ms(lib, 10, 2)
    t4["bound_ms"], t4["bound_by"] = flash_bound_ms(1, Hq, Hkv, 4096, 4096, d, None, True, 2)
    n4 = flash_ops(1, Hq, 4096, 4096, d, None, True)
    t4["tflops_counted"], t4["tflops_issued"] = tflops(n4, t4["ms"]), 1.5 * tflops(n4, t4["ms"])
    t4["mma_sync_tflops_counted"] = tflops(n4, t4["mma_sync_ms"])
    log(f"[flash] S=4096 bf16 causal: {json.dumps(t4)}")
    del o4, p4, qc
    S = 32768
    q32, k32, v32 = flash_inputs(12, 1, Hq, Hkv, S, S, d, torch.bfloat16)
    o32 = ops.flash_attention(q32, k32, v32)
    for i0 in row_blocks(S):
        check(f"bf16 S={S} rows {i0}..{i0 + 255}", *causal_rows(o32, q32, k32, v32, i0, 256))
    log(f"[flash] S={S} bf16 causal, the prefill's call: rows {row_blocks(S)} (+256 each) against the "
        f"plain version agree (max abs err so far {err:.3g}, max row err {row:.3g})")
    res["flash_err"], res["flash_row_err"] = err, row
    del o32
    qc = q32.contiguous()
    t32 = flash_turns(lambda: ops.flash_attention(q32, k32, v32), lambda: ops.flash_attention_mma(q32, k32, v32), 3, 1)
    # the plain version of the whole call would hold [1, 24, S, S] float32 scores: 103 GB
    t32["plain_ms"] = None
    t32["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qc, k32, v32, is_causal=True, enable_gqa=True), 5, 1)
    t32["bound_ms"], t32["bound_by"] = flash_bound_ms(1, Hq, Hkv, S, S, d, None, True, 2)
    n32 = flash_ops(1, Hq, S, S, d, None, True)
    t32["tflops_counted"], t32["tflops_issued"] = tflops(n32, t32["ms"]), 1.5 * tflops(n32, t32["ms"])
    t32["mma_sync_tflops_counted"] = tflops(n32, t32["mma_sync_ms"])
    log(f"[flash] S={S} bf16 causal: {json.dumps(t32)}")
    res["flash_4k"], res["flash_32k"] = t4, t32
    del qc

    # the planted faults: each must break the S=4096 check and the S=32768 row blocks
    for name, flib in fault_libs.items():
        with planted(flib):
            o4 = ops.flash_attention(q, k, v)
            o32 = ops.flash_attention(q32, k32, v32)
        reading = {"S=4096": flash_errs(o4, ref.flash_attention_ref(q, k, v))}
        for i0 in row_blocks(S):
            reading[f"S={S} rows {i0}"] = flash_errs(*causal_rows(o32, q32, k32, v32, i0, 256))
        del o4, o32
        log(f"[flash] planted fault {name}: (max abs err, max row err) {json.dumps(reading)}")
        for where, (_, r) in reading.items():
            assert r > FLASH_ROW_TOL, f"flash: the check does not see {name} at {where} (row err {r})"
    del q, k, v, q32, k32, v32
    torch.cuda.empty_cache()


# ---------------------------------------------------------- planted faults
def start_fault_builds(out: Path) -> dict:
    """One nvcc process for each of FAULTS, on a copy of its library's source
    and of csrc/common.cuh in a directory of its own, with the one change,
    all started at once."""
    from repro_torch.kernels import _build

    procs = {}
    for name, (source, changed, old, new) in FAULTS.items():
        d = out / name
        d.mkdir()
        for f in (f"{source}.cu", "common.cuh"):
            text = (_build.CSRC / f).read_text()
            if f == changed:
                assert text.count(old) == 1, f"fault {name}: {old!r} is not once in {f}"
                text = text.replace(old, new)
            (d / f).write_text(text)
        so = d / f"{source}.so"
        cmd = [_build.nvcc_path(), *_build.FLAGS, "-o", str(so), str(d / f"{source}.cu")]
        procs[name] = (source, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def load_faults(procs: dict, source: str) -> dict:
    """Waits for the builds of ``source``'s faults; name -> (source, the
    loaded library)."""
    from repro_torch.kernels import _build

    libs = {}
    for name, (src, so, p) in procs.items():
        if src != source:
            continue
        out, _ = p.communicate()
        assert p.returncode == 0, f"nvcc of the planted fault {name} failed:\n{out}"
        cdll = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES[src].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = (src, cdll)
    return libs


@contextlib.contextmanager
def planted(fault):
    """The wrapper of the fault's library launches its planted kernel
    instead of the real one."""
    from repro_torch.kernels import _build

    source, flib = fault
    real = _build.lib
    _build.lib = lambda name: flib if name == source else real(name)
    try:
        yield
    finally:
        _build.lib = real


# ------------------------------------------------------------------ LM path
def lm_run(params, tokens, cfg, decode_tokens=None) -> dict:
    """prefill then N_DECODE decode steps through the user's entry points;
    greedy next tokens unless ``decode_tokens`` are given.  Returns the
    logits of every step (on the host) and the times."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as T

    S = tokens.shape[1]
    kernel_events = []
    real = ops.flash_attention

    def timed(*a, **kw):  # CUDA events around each kernel call of the prefill
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*a, **kw)
        e1.record()
        kernel_events.append((e0, e1))
        return out

    out = {"impl": cfg.attn_impl}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention = timed
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, tokens, cfg, max_seq=S + N_DECODE)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
    finally:
        ops.flash_attention = real
    out["launches"] = ops.launches["flash_attention_wgmma"]
    out["other_flash_launches"] = ops.launches["flash_attention"]
    out["kernel_s"] = sum(a.elapsed_time(b) for a, b in kernel_events) / 1e3
    out["prefill_tok_s"] = tokens.numel() / out["prefill_s"]
    steps = [logits.cpu()]
    toks, step_ms = [], []
    for i in range(N_DECODE):
        nxt = (torch.argmax(logits, dim=-1) if decode_tokens is None else decode_tokens[i]).to(tokens.device)
        toks.append(nxt.cpu())
        t0 = time.perf_counter()
        logits, cache = T.decode_step(params, cache, nxt, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(logits.cpu())
    out["decode_ms"] = float(np.mean(step_ms))
    out["decode_ms_first_last"] = [step_ms[0], step_ms[-1]]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del cache
    torch.cuda.empty_cache()
    return out, steps, toks


def logit_errs(f_steps, c_steps) -> list[float]:
    """Relative L2 error of the logits, step by step."""
    return [float((a - b).norm() / b.norm()) for a, b in zip(f_steps, c_steps)]


def argmax_flips(f_steps, c_steps) -> list:
    """(step, gap) where the argmax differs: the gap between the chunked
    run's logits at the two places."""
    out = []
    for i, (a, b) in enumerate(zip(f_steps, c_steps)):
        ia, ib = int(a.argmax()), int(b.argmax())
        if ia != ib:
            out.append((i, float(b[0, ib] - b[0, ia])))
    return out


def phase_lm(res: dict, seed: int, fault_libs: dict) -> None:
    import torch
    from repro_torch.configs import lm_archs, shapes
    from repro_torch.models import transformer as T
    from repro_torch.models.base import param_count

    cfg = lm_archs.get("phi4-mini-3.8b")
    pre, dec = shapes.LM_SHAPES["prefill_32k"], shapes.LM_SHAPES["decode_32k"]
    S = pre["seq"]
    log(f"reduced: lm batch {pre['batch']} -> 1 for prefill (prefill_32k), {dec['batch']} -> 1 for decode "
        f"(decode_32k; {N_DECODE} steps after the {S}-token prompt); width and depth "
        f"({cfg.n_layers} layers) as phi4-mini-3.8b's")
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = T.init_params(cfg, g, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=g, device="cuda")
    torch.cuda.synchronize()
    log(f"[lm] {cfg.name}: {param_count(T.param_specs(cfg)) / 1e9:.3f} B parameters in {cfg.dtype}, "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    flash_cfg = replace(cfg, attn_impl="flash")
    fl, f_steps, f_toks = lm_run(params, tokens, flash_cfg)
    log(f"[lm] flash: {json.dumps(fl)}")
    assert fl["launches"] == cfg.n_layers and fl["other_flash_launches"] == 0, (
        f"flash prefill launched the wgmma kernel {fl['launches']} times and the others "
        f"{fl['other_flash_launches']} times")
    ch, c_steps, _ = lm_run(params, tokens, replace(cfg, attn_impl="chunked"), decode_tokens=f_toks)
    log(f"[lm] chunked: {json.dumps(ch)}")
    assert ch["launches"] == ch["other_flash_launches"] == 0, ch
    for i, (a, b) in enumerate(zip(f_steps, c_steps)):
        assert a.shape == (1, cfg.vocab) and torch.isfinite(a).all() and torch.isfinite(b).all(), i
    rel, flips = logit_errs(f_steps, c_steps), argmax_flips(f_steps, c_steps)
    log(f"[lm] flash vs chunked logits, relative L2 error by step (prefill, then decode): "
        f"{json.dumps([round(r, 6) for r in rel])}; argmax differs at {len(flips)} of {len(rel)} steps "
        f"(step, chunked gap): {flips}")
    res["lm"] = {"flash": fl, "chunked": ch, "logit_rel_err": rel, "argmax_flips": flips}
    for name, flib in fault_libs.items():  # how far a planted kernel fault moves the logits
        with planted(flib):
            _, p_steps, _ = lm_run(params, tokens, flash_cfg, decode_tokens=f_toks)
        fr, ff = logit_errs(p_steps, c_steps), argmax_flips(p_steps, c_steps)
        log(f"[lm] planted fault {name}: logits against chunked, relative L2 error by step "
            f"{json.dumps([round(r, 6) for r in fr])}; argmax differs at {len(ff)} of {len(fr)} steps: {ff}")
    del params
    torch.cuda.empty_cache()
    assert max(rel) < LOGIT_REL_TOL, f"flash and chunked logits differ by {max(rel)} (tolerance {LOGIT_REL_TOL})"
    for i, gap in flips:
        assert gap <= ARGMAX_GAP, f"step {i}: the argmax moved between logits {gap} apart"


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
    (ROOT / "build").mkdir(exist_ok=True)
    fault_dir = Path(tempfile.mkdtemp(prefix="faults_", dir=ROOT / "build"))
    fault_builds = start_fault_builds(fault_dir)
    try:
        kernels = run_phases(res, args, fault_builds, t_all)
    finally:
        for _, _, p in fault_builds.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(fault_dir, ignore_errors=True)
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.time() - t_all:.1f} s; bytes written by this process (wchar): {bytes_written()}")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(res: dict, args, fault_builds: dict, t_all: float) -> list:
    """Every phase in order; returns the kernels line's entries."""
    phase_kernels(res, fault_builds)
    log(f"[kernels] phase done at {time.time() - t_all:.1f} s")
    from repro_torch.configs.ecpfs_paper import ECPFSPaperConfig, ecpfs_paper_full
    from repro_torch.data.synthetic import clustered_vectors

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
        phase_serve(work, data, Q, cfg, res, built, args.seed)
        log(f"[serve] phase done at {time.time() - t_all:.1f} s")
        shutil.rmtree(work / "main_fs")
        (work / "main.blob").unlink()
        cfg2 = ECPFSPaperConfig(**{**cfg.__dict__, "n_items": args.l2_items, "metric": "l2"})
        x, _ = clustered_vectors(args.seed + 1, n=cfg2.n_items + cfg2.serve_batch, dim=cfg2.dim)
        run_path("l2", work, x[: cfg2.n_items], x[cfg2.n_items :], cfg2, res, scorer_rows=16)
        assert res["l2"]["bit_identical"], "l2: quantized search differs from the fp engine"
        log(f"[l2] phase done at {time.time() - t_all:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    fault_libs = load_faults(fault_builds, "flash_attention_wgmma")
    phase_flash(res, fault_libs)
    log(f"[flash] phase done at {time.time() - t_all:.1f} s")
    phase_lm(res, args.seed, fault_libs)
    log(f"[lm] phase done at {time.time() - t_all:.1f} s")
    main_launches = res["main"]["launches"]
    g, t, f32k = res["grouped"], res["topk"], res["flash_32k"]
    four = ("device_ms", "library_device_ms", "kernels_per_call")
    pr = res["main"]["per_round_ms"]
    kernels = [
        {"name": "grouped_distance_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/grouped_distance_topk.cu",
         "replaces": "src/repro/kernels/distance_topk/grouped.py:88",
         "launches": main_launches["grouped_distance_topk"],
         "max_abs_err": res["grouped_err"], "ms": g["ms"], "plain_ms": g["plain_ms"],
         "bound_ms": g["bound_ms"], "bound_by": g["bound_by"], "library_ms": g["library_ms"],
         **{a: g[a] for a in four}, "shape": "G=128 N=455 D=1152 int8 cosine k=128",
         "skew": {**res["grouped_skew"], "shape": "G=128, n_rows 5360 + 127 x 455 padded to 5360, else the same"},
         "main_path_per_round": {"kernel_ms": pr["kernel"], "bound_ms": pr["kernel_bound"],
                                 "code_mb": pr["code_mb"], "rounds": res["main"]["quant_times"]["rounds"]},
         "serve_launches": {p: res["serve"][f"{p}_launches"]["grouped_distance_topk"]
                            for p in ("interactive", "concurrent")}},
        {"name": "distance_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/distance_topk.cu",
         "replaces": "src/repro/kernels/distance_topk/distance_topk.py:101",
         "launches": main_launches["distance_topk"],
         "max_abs_err": res["topk_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
         **{a: t[a] for a in four}, "shape": "B=1 N_pad=512 D=1152 f32 cosine k=512",
         "by_n_pad": {n: {a: v[a] for a in ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms")}
                      for n, v in res["topk_by_n"].items()},
         "scorer_call": res["scorer_call"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100",
         "launches": res["lm"]["flash"]["launches"],
         "max_abs_err": res["flash_err"], "ms": f32k["ms"], "plain_ms": res["flash_4k"]["plain_ms"],
         "bound_ms": f32k["bound_ms"], "bound_by": f32k["bound_by"], "library_ms": f32k["library_ms"],
         "shape": "B=1 Hq=24 Hkv=8 S=32768 d=128 bf16 causal", "plain_shape": "S=4096 (else the same)",
         "max_row_rel_err": res["flash_row_err"], "mma_sync_ms": f32k["mma_sync_ms"],
         "tflops_counted": f32k["tflops_counted"], "tflops_issued": f32k["tflops_issued"],
         "ms_4k": res["flash_4k"]["ms"], "mma_sync_ms_4k": res["flash_4k"]["mma_sync_ms"],
         "ptxas": res.get("wgmma_ptxas")},
    ]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
