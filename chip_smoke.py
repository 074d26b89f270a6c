#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of eCP-FS (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n-items N] [--l2-items N]

Phases, none of whose failures is caught:

1. device: the card's name and power limit (``nvidia-smi``); exits non-zero
   when ``torch.cuda.is_available()`` is false.
2. kernels: builds the six CUDA sources in ``src/repro_torch/csrc`` (nvcc,
   sm_90a; prints the registers, shared memory and spills of the wgmma
   flash kernel, of the three distance kernels' main-path
   instantiations and of the merge kernel)
   and holds the distance kernels against their plain PyTorch versions on
   the card at the main path's shapes, then at the edges of their designs:
   grouped n_rows of 0, 1, T-1, T, T+1 and 5360 (T the row tile) at k of 1,
   128, 224 and N; rows repeated across tiles (ties keep the lower row
   first); full selection at N_pad 512, 1024 and 5632 with zero pad rows;
   back-to-back calls on one stream; every finish counter back at 0.  Two
   faults planted in copies of the grouped kernel (its merge breaking ties
   by distance alone, its work list skipping a group's last tile) must make
   these checks fail.  Then distance_topk's k < N path at its caller's
   shape (B=1 against 1M candidates, k=100, d = 32, 18 and 16: ip, l2 and
   cosine in float32, ip in bf16 at d = 32) and at its edges (k of 1, 100
   and N - 1, N = 1000 and 1 000 003, B = 4, equal rows across blocks,
   unaligned candidates), with two faults planted in copies of it (the
   last block dropping one list; the tail chunk a row short) that must
   make these checks fail.  Times each distance kernel four ways: the wrapper
   call under CUDA events (``ms``), its kernels' own time from
   ``torch.profiler`` (``device_ms``), the same two for a library
   yardstick (timed here only, never called by the port), beside the
   bound; the grouped kernel also at the main path's skew (one leaf of
   5360 rows among 455-row ones, padded to 5360).  Packed mode's leaf
   scoring (``leaf_distances``) at the benchmark's scan chunk (B=128
   queries, b=64 leaves each, 1099 leaves padded to 5248 rows of 1152, a
   median of 250 real rows and 500k in all): within 1e-5 of its plain version under l2,
   ip and cosine, a second launch bit-identical; timed, cosine and l2,
   against the plain version, ``torch.mm`` of the same real rows, and the
   kernel's own bytes bound.  Packed mode's merge (``leaf_merge``) at the
   same chunk (C=400): bit for bit the plain version's into an empty and a
   full buffer, one kernel a call; timed against the plain version,
   ``torch.topk`` of the masked keys, and its bytes bound.
2a. recsys: the four architectures of ``configs/recsys_archs.py`` at full
   width, random parameters from a seeded generator on the card:
   ``serve_p99`` (a ``ctr_batch`` of 512; sigmoid(forward) on the card
   within 1e-4 of the CPU's) and ``retrieval_cand`` (``user_tower`` of one
   request, then ``candidate_scores`` over 1M candidate embeddings drawn on
   the card, k=100: one ``distance_topk`` launch counted from 0, held
   against its plain version and against ``torch.mm`` + ``torch.topk``).
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
3a. read: the rest of the paper's read path on the same 200k index, each
   result held against the main phase's.  (a) 32 of its queries through
   ``open_index(blob, mode="file", backend="blob+prefetch",
   quantized=True)``, search and ``next(100)`` bit-identical; then the same
   through an ``AsyncPrefetchStore`` whose byte cap admits nodes of this
   index (the default cap is below one node's slot estimate, so it
   suppresses every key), asserting prefetches were issued; prints issued,
   hits, wasted bytes and suppressed keys, and the grouped kernel's
   launches.  (b) ``pin_internal=True``: every internal node pinned at
   open, 8 searches read none.  (c) ``engine="legacy"``: as many queries as
   fit ``LEGACY_S`` (timed on the first), search and ``next(100)``
   bit-identical.  (d) ``Query.save`` on the fstore, ``load_query`` in a
   fresh ``ECPIndex``, ``next(100)`` (the main phase's results) and then a
   continuation past the saved candidates, fp and quantized (4 queries
   each), identical to an fp engine's of its own on the blob; the unsaved
   fp query's continuation is identical to it too, the unsaved quantized
   one's equal up to the order of exactly equal distances (ROADMAP Queue 3).  (e), after the l2 phase: a ``MultiIndexSession`` over the
   200k fstore (quantized) and the l2 phase's blob (fp, leaves through
   ``make_kernel_scorer()``) under ``SESSION_BYTES``, below either index's
   leaves: evictions above 0, results those of the phases that opened each
   index alone (the kernel scorer's within the kernel tolerance); both
   kernels' launches counted from 0.
3b. federation: the 200k collection as 4 shards (contiguous 50k slices,
   ``build_federation``), each built on the card, converted
   ``quant="int8"`` and joined by a manifest; ``open_index(root,
   quantized=True)`` with no mode is a ``FederatedIndex`` on the card, not
   packed mode.  32 queries, search and ``next(100)``: identical to the
   same shards opened fp on the host engine (``next`` up to the order of
   equal distances, ROADMAP Queue 3, counted and printed), each row's
   allocation summing to b=64 with every probed shard at ``b_min`` or above,
   each row's aggregate counters the sum of its shards', the grouped kernel
   launched in every shard (counted per shard).  A one-shard manifest over
   the main phase's own blob answers as the main phase.  Prints recall@100
   beside the single index's and the bytes written; the shard files go.
3c. baselines: ``BruteForce`` over the stored collection (its batch's
   distance block on the card) held against the main phase's ground truth
   but for ties; the k-means assignment on the card against the host's on a
   sample; ``IVFIndex`` with 440 lists and 6 iterations (assignment on the
   card and update on the host timed apart), searched at nprobe=64 with
   ``next(100)``; packed mode's batch; one line of recall@100 and batch
   time for eCP-FS file mode (quantized) and packed mode, the federation
   and IVF, against BruteForce.  BruteForce and IVF launch no
   hand-written kernel; packed mode's batch launches ``leaf_distances``.
   ``HNSWLite`` and ``VamanaLite`` do no device work and take minutes to
   build at these widths: the CPU tests hold them.
3d. serve: the serving path (``launch/serve.py``'s ``Server``) on the same
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
   peak device memory beyond the resident index; ``leaf_distances``
   and ``leaf_merge`` launches counted from 0, one of each a chunk.  A
   packed searcher on an index of repeated rows keeps ties in index order
   (and launches both); with a copy of the merge kernel that puts ties in
   reverse position order (planted) that check must fail, and a copy
   whose rank stage runs on ``torch.topk`` (no promised tie order) is
   reported.
4. l2: the same steps at a smaller collection with metric l2.
5. flash: holds the flash-attention kernels against their plain version
   on the card, by element and by row (the six cases of
   tests/test_kernels.py, every head width and logits of 30, in float32
   and bf16; batch rows with kv_len = 0; the wgmma kernel's edges: Sq and
   kv_len off its 128-row tiles, one query over 32768 keys, v past kv_len
   set to 1e4; the prefill's heads in bf16 at S=4096, llama4-scout's (40
   over 8, a GQA group of 5) at S=4096, and at S=32768 three blocks of
   rows of the prefill's own call) and times the wgmma kernel
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
7. long500k: eCP retrieval attention (``retrieval_decode_step``) for
   phi4-mini at full width and depth over ``long_500k``'s 524288-token
   clustered cache (1024 clusters of 512, top 32; 64 GiB of k and v),
   filled from the seeded generator up to 300 tokens before its end, then
   16 steps in place.  Asserts finite logits, each token's k and v at its
   slot, the current centroid the mean of its keys, retrieval over every
   cluster of a 32768-token sub-cache equal to chunked attention, and
   retrieval at top 32 over a whole layer equal to exact attention masked
   to the same clusters; prints ms a step beside the bytes a step must
   read and the exact decode's.  No kernel launches.
8. moe: llama4-scout (12 of 48 layers, 16 experts) and llama4-maverick (2
   of 48 layers: one dense + MoE block, 128 experts) at full width, random
   weights: prefill of 32768 tokens with flash (one wgmma launch a layer)
   and decode steps; scout again through chunked attention, its logits
   held as phi4-mini's, with the share of tokens the two runs route to
   other experts by layer; ``moe_ffn`` on one MoE layer of each at 32768
   tokens (as drawn, and skewed past capacity) held against an
   independent reading of its dispatch.
9. train: the training path, no kernel on it (launch counters zeroed
   around each part, each must read 0).  Checks at phi4-mini's full width
   and 2 layers, seq 512: gradients with remat equal those without it bit
   for bit; bf16 compute against float32 on the same float32 master
   weights (loss within 1e-2, every leaf's gradient cosine >= 0.99); one
   AdamW update of three leaves on the card within 1e-6 of the CPU's.
   (a) ``make_lm_trainer`` at phi4-mini's full width and TRAIN_LAYERS
   layers on ``train_4k``'s 4096 tokens at batch 1: TRAIN_STEPS steps of
   ``StepLoader(lm_batch)`` batches (forward+backward and optimizer ms
   from CUDA events, tokens/s, the model FLOPs' share of the bf16 peak,
   peak memory against the state's bytes), then one batch TRAIN_REPEAT
   times: the loss falls at every step.  (b) ``TrainSupervisor`` on the
   reduced phi4 config: 20 steps, a checkpoint every 5 (async), failures
   at steps 7 and 13: 2 restarts, final weights equal to a failure-free
   run's, the last checkpoint equal to the final state, and one leaf read
   back with ``numpy.fromfile`` and its ``.zarray``.  (c) GraphSAGE
   (graphsage-reddit) at each of its shapes: ``minibatch_lg`` (a
   232965-node, 114.6M-edge ``random_graph``, ``CSRGraph``,
   ``sample_hops`` of 1024 seeds at fanouts 15-10), ``full_graph_sm``,
   ``molecule``, and ``ogb_products`` full batch when its reckoned peak
   fits; step 0's loss and gradients on the card against the CPU's within
   1e-4 (all but ogb_products), then AdamW steps.  (d) The four recsys
   architectures at ``train_batch`` (65536 rows, full vocabularies): step
   0's updated parameters on the card against the CPU's at a 4096-row
   slice, then 3 AdamW steps through ``make_train_step``.
10. cells: the 40 (arch x shape) cells of ``launch/cells.py``.  Their dry
   run (``launch/dryrun.py``: the traced peak and FLOPs on fake tensors)
   runs in a child process started with the smoke.  First the custom ops'
   cost a call (each kernel's wrapper against its launching body, in
   turns).  (a) The 40 cells reduced, one step each on the card and on the
   CPU from the same ``example_inputs`` (drawn on the CPU and copied),
   held within the CELL_* tolerances: finite outputs, loss > 0, step 1,
   parameters moved.  (b) The 20 GraphSAGE and recsys cells at their
   shapes, uncut, one step each.  (c) qwen2-7b at full width and depth:
   ``prefill_32k`` at batch 1 through chunked attention and again with
   ``attn_impl="flash"`` (28 wgmma launches, a GQA group of 7; logits held
   to the chunked run's within LOGIT_REL_TOL and ARGMAX_GAP),
   ``decode_32k`` at the dry run's fit batch, ``long_500k``; then
   phi4-mini's ``decode_32k`` at its fit batch.  (d) phi4-mini's prefill,
   train and long_500k, which [lm], [train] and [long500k] ran: their
   traces at batch 1 beside those phases' peaks.  Every cell run at full
   size prints its traced peak beside ``torch.cuda.max_memory_allocated()``
   (reset once its inputs exist) and their ratio; the launches of each part
   are counted from 0 (``distance_topk`` once a retrieval cell, the wgmma
   flash kernel once a qwen2 layer).

11. mesh: the distribution layer on the host mesh (NCCL at world size 1,
   ``make_host_mesh()``: (1, 1) over ("data", "model")), the real sharded
   code and its collectives on one rank.  phi4-mini at full width: (a) the
   sequence-parallel ``prefill`` of 4096 tokens at 32 layers through flash
   (32 launches) against the one-device prefill, chunked and flash; (b) 16
   ``decode_step``s through ``flash_decode_sharded``, (c) 4
   ``retrieval_decode_step``s through ``retrieval_update_and_attend_sharded``
   over a 32768-token clustered cache, each against the one-device step in
   float32; (d) the sequence-parallel loss and gradients at 4 layers
   against ``lm_loss`` without rules, then ``psum_compressed`` against
   ``compress_decompress``.  Then ``lower_cell`` on the 20 reduced LM
   cells against their one-device step, and llama4-scout at 4 layers with
   no token dropped through ``moe_ffn_ep`` against ``moe_ffn``.  Last,
   graph_recsys: ``lower_cell`` on the 20 reduced GraphSAGE and recsys
   cells (the sharded gather-scatter, the row-sharded table, the candidate
   top-k over sharded candidates) and, at full width, the four
   ``retrieval_cand`` cells at 1M candidates, GraphSAGE ``ogb_products``
   (one train step) and bst ``serve_bulk``, each against its one-device
   step from ``cells.live_inputs``; ``distance_topk`` once a
   ``retrieval_cand`` run (16), no other kernel.  Launches counted from 0
   around each part.

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
    # distance_topk's k < N path: the last block of a row reads one list
    # fewer (the last block's, which holds the tail), and the chunk that
    # holds the tail stops a row short
    "split_drops_a_list": ("distance_topk", "distance_topk.cu",
                           "const bool have = l < m;", "const bool have = l < m - 1;"),
    "split_tail_mask": ("distance_topk", "distance_topk.cu",
                        "return min(a.N, r0 + a.rpb);", "return min(a.N - 1, r0 + a.rpb);"),
    # packed mode's merge: equal distances in reverse position order (the
    # tie part of a key, which decodes back to the same position)
    "merge_ties_reversed": ("leaf_merge", "leaf_merge.cu",
                            "{ return pos; }", "{ return 0x7fffffffu - pos; }"),
}
# the recsys retrieval tower (configs/shapes.py RECSYS_SHAPES["retrieval_cand"]:
# one request against 1M candidates; k = 100 as the reference's retrieval
# cell, launch/cells.py) at the embedding widths of configs/recsys_archs.py:
# bst 32, dien 18, autoint and dcn-v2 16
SPLIT_K = 100
RECSYS_WIDTHS = (32, 18, 16)
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
# long500k: eCP retrieval attention at phi4-mini's full width and depth over
# long_500k's 524288 tokens (k and v 64 GiB in bf16, centroids 0.125 GiB in
# float32).  The steps start LONG_TAIL tokens before the cache's end, so the
# last cluster is partial and no step crosses a cluster boundary.  Retrieval
# and exact attention are compared in float32 within the CPU tests' 2e-4
# (|a - b| <= RETR_TOL * (1 + |b|)) on a sub-cache of LONG_SUB_CLUSTERS
# clusters and, at top_b, over a whole layer.
LONG_STEPS = 16
LONG_TAIL = 300
LONG_SUB_CLUSTERS = 64
RETR_TOL = 2e-4
CENTROID_RTOL = 1e-5
# moe: llama4 at full width, depth cut to what one card holds beside a
# 32768-token prefill: scout 48 -> 12 layers (54.0 GB of weights), maverick
# 48 -> 2 (one dense + MoE block, 36.9 GB); maverick decodes
# MAVERICK_DECODE steps.  moe_ffn's kept tokens, MOE_SAMPLES of them, are
# held one at a time to gate * swiglu(x; W_e) by the relative L2 error
# within MOE_TOKEN_TOL, the bf16 tolerance of tests/test_torch_lm.py.
SCOUT_LAYERS = 12
# Scout's flash and chunked logits are held as phi4-mini's (LOGIT_REL_TOL,
# ARGMAX_GAP) at every step.  Routing is a discrete choice that the two
# attention paths' rounding can tip (measured on the H100 with free
# routing: one decode token of 16 took another expert in one layer and moved
# that step's logits 3.7e-2, against 1.0-1.1e-2 at the others), so the
# chunked run dispatches each token to the expert the flash run chose and
# the logits measure attention alone; where its own router would have
# chosen another expert is reported beside them, by layer and by step.
# scout's chunked prefill in blocks of 512 queries (the config's attn_chunk
# is 1024): a block's [40, 1024, 32784] float32 scores and their softmax
# temporaries (~15 GiB) do not fit beside the 12 layers' 50.3 GiB of
# weights; each block is exact and independent, so the logits are the same
SCOUT_CHUNK = 512
MAVERICK_LAYERS = 2
MAVERICK_DECODE = 4
MOE_SAMPLES = 64
MOE_TOKEN_TOL = 2e-2
# the read path: a prefetch byte cap that admits nodes of the 200k blob
# (its slot, the largest leaf's block, is 12.4 MB; the store's default cap
# is 4 MiB), the seconds the legacy engine may take, and the shared budget
# of the session, below either index's leaves (0.92 and 0.23 GB)
PREFETCH_CAP = 256 << 20
LEGACY_S = 30.0
SESSION_BYTES = 64 << 20
# the federation: shards of the main collection (contiguous slices, as
# build_federation splits it) and the queries it answers; IVF's lists match
# the main index's 440 leaves, its iterations benchmarks/indexes.py's
FED_SHARDS = 4
FED_QUERIES = 32
IVF_LISTS = 440
IVF_ITERS = 6
# train (a): phi4-mini at full width, float32 master weights and AdamW
# moments, bf16 compute.  State: 16 bytes a parameter (weight, gradient,
# two moments); 100.66 M parameters a layer, 1.229 B in the embedding and
# lm_head: 4.451 B at 32 layers, 71.2 GB.  The optimizer works in place,
# so no second tree of them is held; the float32 logits of 4095 tokens
# (3.28 GB) and their softmax and gradient come on top at the loss.
TRAIN_LAYERS = 32
TRAIN_STEPS = 6
TRAIN_REPEAT = 8
TRAIN_LR = 3e-4
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_SEQ = 512
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_COS = 0.99
ADAMW_RTOL = 1e-6
# train (b): the supervisor
SUP_STEPS = 20
SUP_EVERY = 5
SUP_FAILS = {7: 1, 13: 1}
# train (c), (d): AdamW steps a shape, step 0's loss and gradients against
# the CPU's within GNN_RTOL (max |a - b| over the leaf's max |b|); recsys at
# a slice of train_batch's 65536 rows (see train_recsys for its checks).
# In float32 the two devices' rounding tips ReLUs at 0 and the signs of
# near-zero gradients, which AdamW's first step turns into moves of 2 lr
# (seen on the H100: bst and dcn-v2, float32 gradients 1.1e-2 and 2.7e-3 of
# a leaf's largest entry apart, 2043 and 2668 updated entries off by more
# than 1e-2 lr), so the recsys step is held in float64 (the gradients, and
# each update within lr / eps times its leaf's gradient difference).
GNN_STEPS = 3
GNN_LR = 1e-3
GNN_RTOL = 1e-4
RECSYS_STEPS = 3
RECSYS_LR = 1e-3
RECSYS_SLICE = 4096
RECSYS_GRAD_COS = 0.999
ADAMW_EPS = 1e-8
# [cells]: the 40 reduced cells on the card against the CPU (float32, the
# reduced configs' dtype; sums in another order): logits, caches, serve
# probabilities and retrieval scores within CELL_ATOL; a train step's loss
# within CELL_LOSS_RTOL; its first AdamW moment mu = 0.1 g within CELL_MU_ATOL
# + CELL_MU_RTOL |mu|.  Parameters after the step within CELL_P_ATOL +
# CELL_P_RTOL |p|, except where |g| < CELL_TINY_GRAD: AdamW's first update is
# about lr * sign(g), so a gradient that small that rounds to the other
# sign on the other device moves an entry by up to 2 lr (the first step's
# lr: 1.5e-6 for the LM schedule, 3e-3 GraphSAGE, 1e-3 recsys).
CELL_ATOL = 1e-4
CELL_LOSS_RTOL = 1e-5
CELL_MU_ATOL, CELL_MU_RTOL = 1e-6, 1e-3
CELL_P_ATOL, CELL_P_RTOL = 1e-6, 1e-5
CELL_TINY_GRAD = 1e-6
CELL_LR1 = {"lm": 3e-4 / 200, "gnn": 3e-3, "recsys": 1e-3}
# the LM cells [cells] runs at full width (arch, shape, batch: None is the
# dry run's fit_batch) and the ones earlier phases ran, traced at the batch
# they ran (phi4-mini's prefill in [lm], train in [train], long_500k in
# [long500k])
CELL_LM_RUNS = (("qwen2-7b", "prefill_32k", 1), ("qwen2-7b", "decode_32k", None), ("qwen2-7b", "long_500k", 1),
                ("phi4-mini-3.8b", "decode_32k", None))
CELL_LM_EARLIER = (("phi4-mini-3.8b", "prefill_32k", 1), ("phi4-mini-3.8b", "train_4k", 1),
                   ("phi4-mini-3.8b", "long_500k", 1))
# [mesh]: the distribution layer on the host mesh, one NCCL rank, (1, 1)
# ("data", "model").  phi4-mini at full width: (a) the sequence-parallel
# prefill of MESH_PREFILL tokens through flash against the one-device
# prefill, chunked (LOGIT_REL_TOL, the argmax as [lm]'s) and flash (the
# same computation on one rank: MESH_SAME_RTOL, the same argmax); (b)
# MESH_DECODE decode steps through flash_decode_sharded and (c)
# MESH_RETR_STEPS retrieval steps through retrieval_update_and_attend_sharded
# over a MESH_RETR_SEQ-token clustered cache, each against the one-device
# step, in float32 (in bf16 the two attentions round p at different
# points): logits within MESH_DECODE_RTOL / MESH_RETR_RTOL relative L2, the
# greedy tokens equal, the written caches within MESH_RETR_RTOL of their
# largest entry; (d) a
# sequence-parallel loss and gradients at MESH_TRAIN_LAYERS layers against
# lm_loss without rules, float32 (MESH_TRAIN_RTOL of each leaf's largest
# entry), then psum_compressed against compress_decompress (bit for bit).
# Then the 20 reduced LM cells through lower_cell against their one-device
# step on the card (CELL_ATOL), and llama4-scout at MESH_SCOUT_LAYERS
# layers, no token dropped (capacity factor = experts), prefill through
# moe_ffn_ep against moe_ffn (MESH_SAME_RTOL, the same argmax).  Last,
# graph_recsys: the 20 reduced GraphSAGE and recsys cells through
# lower_cell against their one-device step on the card from live_inputs
# (train: held_train's rules; serve CELL_ATOL; retrieval ids equal, scores
# within the kernel's tol), then at full width MESH_GR_FULL: the four
# retrieval_cand cells at 1M candidates (the same checks), a
# GraphSAGE ogb_products train step (held_train) and bst serve_bulk
# (CELL_ATOL); distance_topk launches once a retrieval_cand run.
MESH_GR_FULL = (("bst", "retrieval_cand"), ("dien", "retrieval_cand"), ("autoint", "retrieval_cand"),
                ("dcn-v2", "retrieval_cand"), ("graphsage-reddit", "ogb_products"), ("bst", "serve_bulk"))
MESH_PREFILL = 4096
MESH_DECODE = 16
MESH_RETR_SEQ = 32768
MESH_RETR_STEPS = 4
MESH_TRAIN_LAYERS = 4
MESH_SCOUT_LAYERS = 4
MESH_SAME_RTOL = 1e-3
MESH_DECODE_RTOL = 1e-4
MESH_RETR_RTOL = 1e-5
MESH_TRAIN_RTOL = 1e-5


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


def recall(ids, gt, k: int) -> float:
    """Recall@k of result rows ``ids`` against ground-truth rows ``gt``."""
    return float(np.mean([len(set(gt[r][:k]) & set(ids[r][ids[r] >= 0])) / k for r in range(len(ids))]))


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


def topk_bound_ms(B, N, k, dtype="float32", itemsize=4, d=D):
    """Least time of distance_topk: q and c read once, the top-k written
    once; a multiply-add per (query, row, element) and one for each row's
    norm."""
    nbytes = (B + N) * d * itemsize + B * k * 8
    ops = 2 * B * N * d + 2 * N * d
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def device_time(fn, iters: int = 20, tries: int = 8, *, whole: bool = True) -> tuple[float | None, float | None]:
    """(ms on the card per call, summed over the call's kernels; kernels per
    call as the profiler saw them, or None), from torch.profiler with CUDA
    activity around ``iters`` calls.  Copies and memsets are not kernels
    and are left out.  The profiler now and then drops the records of
    kernels launched from the port's own libraries (seen on the H100: 3 of
    5 scorer calls' kernels late in a run; 18 of 20 in each of 8 traces),
    so a trace whose kernel count is not a positive multiple of ``iters``
    is taken again, up to ``tries`` times; if every trace came short, the
    time is the mean of the records kept and the count is None: it was not
    measured (``captured_kernels`` counts a call's kernels without the
    profiler).  If no trace kept a single record (seen on the H100 for
    SDPA's one kernel at S=32768, in all 8 traces of one run), both are
    None: the profiler's reading is not measured, and the CUDA-event times
    beside it stand.  A library yardstick (``whole=False``) may launch a
    varying number of kernels a call (seen on the H100: 538 for 20 calls of
    decode + bmm + topk, in every trace), so any trace with kernels counts
    for it."""
    import torch

    fn()
    torch.cuda.synchronize()
    counts, best = [], []
    for _ in range(tries):
        ks = traced_kernels(fn, iters)
        counts.append(len(ks))
        if ks and (len(ks) % iters == 0 or not whole):
            return sum(e.time_range.elapsed_us() for e in ks) / 1e3 / iters, len(ks) / iters
        best = max(best, ks, key=len)
    if not best:
        log(f"torch.profiler kept no kernel record in {tries} traces of {iters} calls: device time not measured")
        return None, None
    assert len(best) < iters, f"torch.profiler saw {counts} kernels in {tries} traces of {iters} calls"
    log(f"torch.profiler kept {counts} of {iters} one-kernel calls' records; the mean of the {len(best)} kept")
    return sum(e.time_range.elapsed_us() for e in best) / 1e3 / len(best), None


def captured_kernels(fn) -> int:
    """The kernels one call of ``fn`` launches, counted without the
    profiler: the call is captured on a side stream into a CUDA graph
    (driver API, relaxed mode; the graph is never run) and its kernel nodes
    are counted.  A warm call on the same stream comes first, so the
    wrappers' per-stream workspaces and the allocator's blocks exist and
    the captured call allocates nothing.  Copies and memsets are other
    node types and are not counted."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")
    vp, ref = ctypes.c_void_p, ctypes.byref

    def ok(rc: int, what: str) -> None:
        assert rc == 0, f"{what} returned CUresult {rc}"

    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    h, graph = vp(s.cuda_stream), vp()
    ok(cu.cuStreamBeginCapture_v2(h, ctypes.c_int(2)), "cuStreamBeginCapture")  # CU_STREAM_CAPTURE_MODE_RELAXED
    try:
        with torch.cuda.stream(s):
            fn()
    finally:
        rc = cu.cuStreamEndCapture(h, ref(graph))
    ok(rc, "cuStreamEndCapture")
    try:
        n = ctypes.c_size_t(0)
        ok(cu.cuGraphGetNodes(graph, None, ref(n)), "cuGraphGetNodes")
        nodes = (vp * max(1, n.value))()
        ok(cu.cuGraphGetNodes(graph, nodes, ref(n)), "cuGraphGetNodes")
        kinds = []
        for i in range(n.value):
            t = ctypes.c_int(-1)
            ok(cu.cuGraphNodeGetType(vp(nodes[i]), ref(t)), "cuGraphNodeGetType")
            kinds.append(t.value)
    finally:
        ok(cu.cuGraphDestroy(graph), "cuGraphDestroy")
    return kinds.count(0)  # CU_GRAPH_NODE_TYPE_KERNEL


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
    out["device_ms"], out["profiled_kernels_per_call"] = device_time(kern)
    out["kernels_per_call"] = captured_kernels(kern)
    out["library_device_ms"], out["library_kernels_per_call"] = device_time(lib, whole=False)
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
                       ("distance_topk", "full_select_kernelIfLb1E"),
                       ("leaf_distances", "leaf_distances_kernelILi4EE"),
                       ("leaf_merge", "leaf_merge_kernel")):
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
    merge = {**four_ways(mk, lambda: torch.topk(torch.mm(qb, cb.T), k, dim=1), 5),
             "plain_ms": cuda_ms(lambda: ref.distance_topk_ref(qb, cb, k, "l2"), 5, 1)}
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
    # the graph count sees every kernel of a call: two of PyTorch's own here
    m = torch.zeros(1024, device="cuda")
    two = captured_kernels(lambda: (m.add_(1), m.mul_(2)))
    assert two == 2, f"a CUDA graph of two PyTorch kernels holds {two} kernel nodes"
    res["topk_by_n"] = {}
    for n_pad in (512, 1024, 5632):
        c = torch.from_numpy(rng.standard_normal((n_pad, D)).astype(np.float32)).cuda()
        qv = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32)).cuda()
        t = four_ways(lambda: ops.distance_topk(qv, c, n_pad, "cosine"),
                      lambda: torch.topk(torch.mm(qv, c.T), n_pad, dim=1), 100)
        t["plain_ms"] = cuda_ms(lambda: ref.distance_topk_ref(qv, c, n_pad, "cosine"), 50)
        t["bound_ms"], t["bound_by"] = topk_bound_ms(1, n_pad, n_pad)
        n0 = ops.launches["distance_topk"]
        ops.distance_topk(qv, c, n_pad, "cosine")
        counted = ops.launches["distance_topk"] - n0
        assert t["kernels_per_call"] == 1 and counted == 1, \
            f"distance_topk makes {t['kernels_per_call']} kernels a call in a CUDA graph and counts {counted}"
        assert t["profiled_kernels_per_call"] in (None, 1.0), f"the profiler saw {t['profiled_kernels_per_call']}"
        res["topk_by_n"][n_pad] = t
        log(f"[kernels] distance_topk B=1 N_pad={n_pad} D={D} f32 cosine k={n_pad}: {json.dumps(t)}")
    res["topk"] = res["topk_by_n"][512]
    counters_at_rest()
    leaf_part(res)
    merge_part(res)


# ------------------------------------------------ packed mode's leaf scoring
LEAF_B, LEAF_b, LEAF_L, LEAF_CAP = 128, 64, 1099, 5248  # packed.batch128's scan chunk (500k items)


def leaf_case(metric: str, seed: int):
    """A scan chunk of packed mode at the benchmark's shape, on the card:
    LEAF_L leaves padded to LEAF_CAP rows of D float32 (26.6 GB), unit rows
    near one direction (dots about 0.8, as the benchmark's collection),
    ragged prefixes, log-normal around a median of 250 rows with a mean
    near 455 (500k rows in all, as the benchmark's 500k items; leaf 0
    full, leaf 1 empty), zero padding, filled 64 leaves at a time; each
    query takes
    LEAF_b distinct leaves, leaf 0 first, and a few slots are invalid."""
    import torch

    B, b, L, cap = LEAF_B, LEAF_b, LEAF_L, LEAF_CAP
    g = torch.Generator(device="cuda").manual_seed(seed)
    unit = lambda x: x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    mu = unit(torch.randn(D, device="cuda", generator=g))
    n_rows = (torch.exp(torch.randn(L, device="cuda", generator=g) * 1.1) * 250).clamp(1, cap).to(torch.int32)
    n_rows[0], n_rows[1] = cap, 0
    emb = torch.empty(L, cap, D, device="cuda")
    sq = torch.empty(L, cap, device="cuda") if metric == "l2" else None
    for lo in range(0, L, 64):
        x = unit(2 * mu + torch.randn(min(64, L - lo), cap, D, device="cuda", generator=g) / D ** 0.5)
        x *= (torch.arange(cap, device="cuda")[None, :] < n_rows[lo : lo + 64, None])[..., None]
        emb[lo : lo + 64] = x
        if sq is not None:
            sq[lo : lo + 64] = torch.sum(x * x, dim=-1)
        del x
    q = unit(2 * mu + torch.randn(B, D, device="cuda", generator=g) / D ** 0.5)
    leaf_c = torch.argsort(torch.rand(B, L - 1, device="cuda", generator=g), dim=1)[:, : b - 1] + 1
    leaf_c = torch.cat([torch.zeros(B, 1, dtype=torch.long, device="cuda"), leaf_c], dim=1).contiguous()
    lvalid = torch.ones(B, b, dtype=torch.bool, device="cuda")
    lvalid[1:4, -b // 6 :] = False
    q_sq = torch.sum(q * q, dim=-1) if metric == "l2" else None
    return q, q_sq, emb, sq, n_rows, leaf_c, lvalid


def leaf_bound_ms(args, metric: str) -> tuple[float, str, dict]:
    """Least time of the leaf kernel alone on these inputs: each distinct
    visited leaf's real rows read once (their squared norms too for l2),
    the queries and the work list read once, each valid slot's real rows
    written once (no other entry is written); two
    operations per element of each valid slot's real rows."""
    import torch

    q, _, _, _, n_rows, leaf_c, lvalid = args
    B, b = leaf_c.shape
    L = n_rows.shape[0]
    visited = torch.zeros(L, dtype=torch.bool, device=leaf_c.device)
    visited[leaf_c[lvalid]] = True
    rows = int(n_rows[visited].sum())
    needed = int((n_rows[leaf_c] * lvalid).sum())
    per_row = D * 4 + (4 if metric == "l2" else 0)
    nbytes = rows * per_row + needed * 4 + B * (D + 1) * 4 + (B * b + 3 * L + 1) * 4
    ops = 2 * D * needed
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["float32"] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), {
        "distinct_leaves": int(visited.sum()), "real_rows_read": rows, "outputs_written": needed,
        "bytes": nbytes, "ops": ops}


def named_device_ms(fn, name: str, iters: int = 20, tries: int = 8) -> float | None:
    """ms on the card per call of the kernels whose name holds ``name``,
    from torch.profiler; None if no trace kept one record a call."""
    for _ in range(tries):
        ks = [e for e in traced_kernels(fn, iters) if name in e.name]
        if len(ks) == iters:
            return sum(e.time_range.elapsed_us() for e in ks) / 1e3 / iters
    log(f"torch.profiler did not keep {iters} records of {name} in {tries} traces: not measured")
    return None


def leaf_part(res: dict) -> None:
    """``leaf_distances`` at the benchmark's scan chunk: the wrapper on the
    card against its plain version on the same inputs within 1e-5 (l2, ip,
    cosine), a second launch bit-identical, one launch counted a call;
    timed under cosine (the benchmark's metric) and l2: the wrapper call
    (``ms``), the kernel alone and the whole op on the profiler's clock
    (``device_ms``; ``op_device_ms``, the kernels it kept), the plain version, ``torch.mm`` of
    the visited leaves' real rows (gathered beforehand) against every
    query, and the kernel's own bound."""
    import torch
    from repro_torch.kernels import leaf_distances as ld

    err, out = 0.0, {}
    for metric in ("cosine", "l2", "ip"):
        args = leaf_case(metric, 41)
        # the entries the kernel writes: each valid slot's real rows
        real = (torch.arange(LEAF_CAP, device="cuda") < args[4][args[5]][..., None]) & args[6][..., None]
        ld.reset_launches()
        got = ld.leaf_distances(*args, metric)[real]
        again = ld.leaf_distances(*args, metric)[real]
        want = ld.leaf_distances_ref(*args, metric)[real]
        torch.cuda.synchronize()
        assert ld.launches["leaf_distances"] == 2, ld.launches
        assert torch.equal(got, again), f"leaf_distances {metric}: two launches differ"
        assert bool(torch.isfinite(got).all()), f"leaf_distances {metric}: a real row's distance is not finite"
        e = float((got - want).abs().max())
        assert e <= 1e-5, f"leaf_distances {metric}: max abs err {e} against the plain version"
        err = max(err, e)
        del got, again, want, real
        if metric != "ip":
            op = lambda: ld.leaf_distances(*args, metric)
            q, n_rows, leaf_c, lvalid = args[0], args[4], args[5], args[6]
            visited = torch.unique(leaf_c[lvalid])
            real = torch.cat([args[2][u, : int(n_rows[u])] for u in visited.tolist()])
            lib = lambda: torch.mm(q, real.T)
            t = {"ms": cuda_ms(op, 20), "plain_ms": cuda_ms(lambda: ld.leaf_distances_ref(*args, metric), 3, 1),
                 "library_ms": cuda_ms(lib, 20),
                 "device_ms": named_device_ms(op, "leaf_distances_kernel")}
            # the op's ~31 kernels a call (the work list's sort among them):
            # the profiler drops a few records of a trace (618 of 620 seen)
            t["op_device_ms"], t["op_kernels_per_call"] = device_time(op, whole=False)
            t["library_device_ms"], _ = device_time(lib, whole=False)
            t["bound_ms"], t["bound_by"], t["counted"] = leaf_bound_ms(args, metric)
            out[metric] = t
            log(f"[kernels] leaf_distances B={LEAF_B} b={LEAF_b} L={LEAF_L} cap={LEAF_CAP} D={D} f32 {metric}: "
                + json.dumps(t))
            del real
        del args
        torch.cuda.empty_cache()
    log(f"[kernels] leaf_distances at the benchmark's scan chunk: l2/ip/cosine within 1e-5 of the plain version "
        f"(max abs err {err:.3g}), second launches bit-identical")
    res["leaf"] = {**out["cosine"], "l2": out["l2"], "max_abs_err": err}


# ------------------------------------------------------ packed mode's merge
MERGE_C = 400  # packed.batch128's buffer: max(4k, 256) at k = 100


def merge_bound_ms(margs) -> tuple[float, str, dict]:
    """Least time of the merge kernel on these inputs: each valid slot's
    real rows read once (a float32 distance each), the slots (leaf id,
    valid flag, the leaf's row count) and the buffer (distance and id)
    read once, the new buffer written once and its ids from the chunk's
    rows read once; bound by bytes (a comparison or two a key)."""
    buf_d, _, _, _, n_rows, leaf_c, lvalid = margs
    B, C = buf_d.shape
    b = leaf_c.shape[1]
    rows = int((n_rows[leaf_c] * lvalid).sum())
    nbytes = rows * 4 + B * b * (8 + 1 + 4) + 2 * B * C * 12 + B * C * 8
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", {"rows": rows, "bytes": nbytes}


def merge_part(res: dict) -> None:
    """``leaf_merge`` at the benchmark's scan chunk (B=128, b=64, C=400; the
    leaf kernel's distances on ``leaf_case``'s block): the kernel against
    its plain version on the card (the merge as the searcher ran it before
    the kernel) bit for bit, into an empty buffer (a search's first chunk,
    as the benchmark's) and into that result (a later chunk), a second
    launch identical, one launch counted a call and one kernel in a CUDA
    graph; timed: the wrapper call (``ms``), the kernel on the profiler's
    clock (``device_ms``), the plain version, ``torch.topk`` of the masked
    [B, C + b * cap] keys (made beforehand) as the library yardstick, and
    the kernel's bytes bound."""
    import torch
    from repro_torch.kernels import leaf_distances as ld
    from repro_torch.kernels import leaf_merge as lm

    args = leaf_case("cosine", 43)
    q, _, emb, _, n_rows, leaf_c, lvalid = args
    d = ld.leaf_distances(*args, "cosine")
    g = torch.Generator(device="cuda").manual_seed(44)
    leaf_ids = torch.randperm(LEAF_L * LEAF_CAP, device="cuda", generator=g).view(LEAF_L, LEAF_CAP)
    B, C = LEAF_B, MERGE_C
    empty = (torch.full((B, C), torch.inf, device="cuda"), torch.full((B, C), -1, dtype=torch.long, device="cuda"))
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    lm.reset_launches()
    first = (*empty, d, leaf_ids, n_rows, leaf_c, lvalid)
    got = lm.leaf_merge(*first)
    leaf_c2 = torch.roll(leaf_c, 5, dims=1).contiguous()
    d2 = ld.leaf_distances(q, None, emb, None, n_rows, leaf_c2, lvalid, "cosine")
    second = (*got, d2, leaf_ids, n_rows, leaf_c2, lvalid)
    for what, margs in (("into an empty buffer", first), ("into a full buffer", second)):
        got, again = lm.leaf_merge(*margs), lm.leaf_merge(*margs)
        want = lm.leaf_merge_ref(*margs)
        torch.cuda.synchronize()
        for x, y, z in zip(got, again, want):
            assert torch.equal(bits(x), bits(z)), f"leaf_merge {what}: differs from the plain version"
            assert torch.equal(bits(x), bits(y)), f"leaf_merge {what}: two launches differ"
        assert bool(torch.isfinite(got[0]).all()), f"leaf_merge {what}: fewer than C rows kept"
    assert lm.launches["leaf_merge"] == 5, lm.launches
    op = lambda: lm.leaf_merge(*first)
    mask = ((torch.arange(LEAF_CAP, device="cuda") < n_rows[leaf_c][..., None]) & lvalid[..., None]).reshape(B, -1)
    keys = torch.cat([empty[0], torch.where(mask, d.reshape(B, -1), torch.inf)], dim=-1)
    del mask
    lib = lambda: torch.topk(keys, C, dim=1, largest=False, sorted=True)
    t = {"ms": cuda_ms(op, 50), "device_ms": named_device_ms(op, "leaf_merge_kernel"),
         "plain_ms": cuda_ms(lambda: lm.leaf_merge_ref(*first), 10),
         "library_ms": cuda_ms(lib, 20), "kernels_per_call": captured_kernels(op),
         "ms_full_buffer": cuda_ms(lambda: lm.leaf_merge(*second), 50)}
    t["library_device_ms"], _ = device_time(lib, whole=False)
    t["bound_ms"], t["bound_by"], t["counted"] = merge_bound_ms(first)
    assert t["kernels_per_call"] == 1, f"leaf_merge makes {t['kernels_per_call']} kernels a call"
    res["merge"] = t
    log(f"[kernels] leaf_merge B={B} b={LEAF_b} L={LEAF_L} cap={LEAF_CAP} C={C} cosine, bit-identical to the "
        f"plain version into an empty and a full buffer: " + json.dumps(t))
    del args, q, emb, d, d2, keys, got, again, want, first, second
    torch.cuda.empty_cache()


# ------------------------------------------------------------ the k < N path
def split_edges(tag: str) -> list[str]:
    """distance_topk's k < N path against its plain version at the edges of
    its design; returns what failed (empty when everything agrees).  Launch
    errors are not caught.  The cases: k of 1, 100 and N - 1 at N = 1000
    (four 256-row blocks; one block at k = N - 1); N = 1 000 003 at d = 18,
    whose last stage is 67 rows, 4824 bytes (the copy engine brings 4816,
    the threads the last 8), with its last row the nearest; B = 4 at N = 1M;
    a run of 150 equal rows across the boundary of the first two blocks
    and 50 more in the last one, the nearest rows (ties: the lowest 100
    indices, in order); the candidates one row off their allocation (not
    16-byte aligned: no bulk copies)."""
    import torch
    from repro_torch.kernels.distance_topk import ops, ref

    fails = []

    def check(what, fn):
        try:
            fn()
        except AssertionError as e:
            fails.append(f"{tag} {what}: {e}")

    def case(what, q, c, k, metric, extra=None):
        dk, ik = ops.distance_topk(q, c, k, metric)
        dp, ip = ref.distance_topk_ref(q, c, k, metric)
        check(what, lambda: (compare_topk("", dk, ik, dp, ip), extra and extra(dk, ik)))

    g = torch.Generator(device="cuda").manual_seed(31)
    c = torch.randn(1000, 18, generator=g, device="cuda")
    q = torch.randn(1, 18, generator=g, device="cuda")
    for k in (1, SPLIT_K, 999):
        for metric in ("l2", "ip", "cosine"):
            case(f"N=1000 d=18 k={k} {metric}", q, c, k, metric)
    N = 1_000_003
    c = torch.randn(N, 18, generator=g, device="cuda")
    q = torch.randn(1, 18, generator=g, device="cuda")
    c[-1] = 50 * q[0]

    def last_first(dk, ik):
        assert int(ik[0, 0]) == c.shape[0] - 1, f"the last row is not first: {ik[0, :3].tolist()}"
    case(f"N={N} d=18 ip, the last row nearest", q, c, SPLIT_K, "ip", last_first)
    case(f"N={N} d=18 l2", q, c, SPLIT_K, "l2")
    case(f"N={N - 1} d=18 ip, not 16-byte aligned", q, c[1:], SPLIT_K, "ip")
    qb = torch.randn(4, 32, generator=g, device="cuda")
    cb = torch.randn(1_000_000, 32, generator=g, device="cuda")
    case("B=4 N=1000000 d=32 ip", qb, cb, SPLIT_K, "ip")
    case("B=4 N=1000000 d=32 cosine", qb, cb, SPLIT_K, "cosine")
    nblk = ops.topk_split_plan(1, cb.shape[0], 32, SPLIT_K, ops._optin[torch.cuda.current_device()])
    rpb = -(-(-(-cb.shape[0] // nblk)) // ops.SPLIT_NARROW_ROWS) * ops.SPLIT_NARROW_ROWS  # rows a block
    runs = [*range(rpb - 70, rpb + 80), *range(cb.shape[0] - 50, cb.shape[0])]
    cb[runs] = qb[0] + 0.01
    want = runs[:SPLIT_K]

    def lowest_first(dk, ik):
        ties_in_order("", dk, ik)
        assert ik[0].tolist() == want, f"equal rows not in index order: {ik[0, :5].tolist()} ..."
    case(f"{len(runs)} equal nearest rows across blocks l2", qb[:1], cb, SPLIT_K, "l2", lowest_first)
    case(f"{len(runs)} equal nearest rows across blocks ip", qb[:1], cb, SPLIT_K, "ip")
    check("finish counters", counters_at_rest)
    return fails


def phase_split(res: dict, fault_builds: dict) -> None:
    """distance_topk's k < N path at its caller's shape (candidate_scores:
    B = 1, N = 1M, k = 100, d = 32 / 18 / 16), its edges, the planted
    faults, and its times four ways."""
    import torch
    from repro_torch.kernels.distance_topk import ops, ref

    N = 1_000_000
    g = torch.Generator(device="cuda").manual_seed(30)
    err, times = 0.0, {}
    for d in RECSYS_WIDTHS:
        c = torch.randn(N, d, generator=g, device="cuda")
        q = torch.randn(1, d, generator=g, device="cuda")
        cases = [("ip", torch.float32), ("l2", torch.float32), ("cosine", torch.float32)]
        if d == 32:
            cases.append(("ip", torch.bfloat16))
        for metric, dt in cases:
            dk, ik = ops.distance_topk(q.to(dt), c.to(dt), SPLIT_K, metric)
            dp, ip = ref.distance_topk_ref(q.to(dt), c.to(dt), SPLIT_K, metric)
            err = max(err, compare_topk(f"distance_topk k<N d={d} {metric} {dt}", dk, ik, dp, ip))
        log(f"[split] distance_topk B=1 N={N} d={d} k={SPLIT_K}: ip/l2/cosine f32"
            f"{', ip bf16' if d == 32 else ''} agree (max abs err so far {err:.3g})")
        kern = lambda: ops.distance_topk(q, c, SPLIT_K, "ip")
        t = {**four_ways(kern, lambda: torch.topk(torch.mm(q, c.T), SPLIT_K, dim=1), 50),
             "plain_ms": cuda_ms(lambda: ref.distance_topk_ref(q, c, SPLIT_K, "ip"), 20),
             "stream_ms": cuda_ms(lambda: c.sum(), 50)}  # one read of the candidates, a yardstick
        t["bound_ms"], t["bound_by"] = topk_bound_ms(1, N, SPLIT_K, d=d)
        t["blocks"] = ops.topk_split_plan(1, N, d, SPLIT_K, ops._optin[torch.cuda.current_device()])
        n0 = ops.launches["distance_topk"]
        kern()
        counted = ops.launches["distance_topk"] - n0
        assert t["kernels_per_call"] == 1 and counted == 1, \
            f"distance_topk k<N makes {t['kernels_per_call']} kernels a call in a CUDA graph and counts {counted}"
        times[d] = t
        log(f"[split] distance_topk B=1 N={N} d={d} f32 ip k={SPLIT_K}: {json.dumps(t)}")
        del c, q
    res["split"], res["split_err"] = times, err
    fails = split_edges("real kernel")
    assert not fails, "the k < N path disagrees at its edges:\n" + "\n".join(fails)
    log("[split] edges agree: k=1/100/N-1 at N=1000, N=1000003 (a tail under 16 bytes, the last row first), "
        "B=4, equal rows across blocks in index order, unaligned candidates; finish counters at 0")
    for name, fault in load_faults(fault_builds, "distance_topk").items():
        with planted(fault):
            seen = split_edges(name)
        counters_at_rest()
        assert seen, f"the k < N checks do not see the planted fault {name}"
        log(f"[split] planted fault {name}: {len(seen)} checks fail, first: {seen[0][:300]}")
    torch.cuda.empty_cache()


# ------------------------------------------------------------------- recsys
def phase_recsys(res: dict, seed: int) -> None:
    """The four recsys architectures at full width (configs/recsys_archs.py),
    random parameters from a seeded generator on the card: serve_p99 (a
    ctr_batch of 512, sigmoid(forward) on the card against the same on the
    CPU) and retrieval_cand (one request: user_tower, then candidate_scores
    over 1M candidate embeddings drawn on the card, k = 100: one
    distance_topk launch, held against its plain version and against
    torch.mm + torch.topk)."""
    import torch
    from repro_torch.configs import recsys_archs, shapes
    from repro_torch.data.synthetic import ctr_batch
    from repro_torch.kernels.distance_topk import ops, ref
    from repro_torch.models import recsys as R
    from repro_torch.models.base import param_count

    serve, retr = shapes.RECSYS_SHAPES["serve_p99"], shapes.RECSYS_SHAPES["retrieval_cand"]
    log(f"reduced: recsys none (full widths and vocabularies; serve_p99 at batch {serve['batch']}, "
        f"retrieval_cand at batch {retr['batch']} against {retr['n_candidates']} candidates); "
        "train_batch and serve_bulk not run")
    out = {}
    for name in recsys_archs.ARCHS:
        cfg = recsys_archs.get(name)
        part = {"params": param_count(R.param_specs(cfg))}
        kw = dict(field_vocabs=cfg.field_vocabs, n_dense=cfg.n_dense, seq_len=cfg.seq_len,
                  seq_fields=cfg.seq_fields)
        t0 = time.perf_counter()
        g = torch.Generator(device="cuda").manual_seed(seed)
        params = R.init_params(cfg, g, device="cuda")
        torch.cuda.synchronize()
        part["init_s"] = time.perf_counter() - t0
        # serve_p99: the card against the CPU on the same parameters and batch
        batch = ctr_batch(seed, 0, batch=serve["batch"], **kw)
        t0 = time.perf_counter()
        p_card = torch.sigmoid(R.forward(params, batch, cfg))
        torch.cuda.synchronize()
        part["serve_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = {k: v.cpu() for k, v in params.items()}
        p_cpu = torch.sigmoid(R.forward(cpu, batch, cfg))
        part["serve_cpu_s"] = time.perf_counter() - t0
        p_card = p_card.cpu()
        assert p_card.shape == (serve["batch"],) and torch.isfinite(p_card).all(), name
        rel = float(((p_card - p_cpu).abs() / p_cpu.abs().clamp_min(1.0)).max())
        assert rel <= RTOL, f"{name} serve_p99: card and CPU differ by {rel} (tolerance {RTOL})"
        part["serve_rel_err"] = rel
        del cpu
        # retrieval_cand: one request, its top 100 of 1M candidates
        one = ctr_batch(seed, 1, batch=retr["batch"], **kw)
        cand = torch.randn(retr["n_candidates"], cfg.embed_dim, generator=g, device="cuda")
        t0 = time.perf_counter()
        qv = R.user_tower(params, one, cfg)
        torch.cuda.synchronize()
        part["tower_s"] = time.perf_counter() - t0
        ops.reset_launches()
        t0 = time.perf_counter()
        s, i = R.candidate_scores(qv, cand, SPLIT_K)
        torch.cuda.synchronize()
        part["scores_s"] = time.perf_counter() - t0
        part["launches"] = dict(ops.launches)
        assert part["launches"] == {"distance_topk": 1, "grouped_distance_topk": 0}, part["launches"]
        assert s.shape == i.shape == (1, SPLIT_K) and torch.isfinite(s).all(), name
        t0 = time.perf_counter()
        dp, ip = ref.distance_topk_ref(qv, cand, SPLIT_K, "ip")
        part["max_abs_err"] = compare_topk(f"{name} candidate_scores against the plain version", -s, i, dp, ip)
        ls, li = torch.topk(torch.mm(qv, cand.T), SPLIT_K, dim=1)
        compare_topk(f"{name} candidate_scores against torch.mm + torch.topk", -s, i, -ls, li.int())
        part["check_s"] = time.perf_counter() - t0
        out[name] = part
        log(f"[recsys] {name} (d={cfg.embed_dim}): {json.dumps(part)}")
        del params, cand, qv
        torch.cuda.empty_cache()
    res["recsys"] = out


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
    out["recall_at_k"] = recall(rs.ids, gt, cfg.k)
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
    return {"blob": blob, "store": bst, "fs": fs, "fp_ids": frs.ids, "n_items": len(data), "gt": gt,
            "ids": rs.ids, "dists": rs.dists, "nx_ids": nx.ids, "nx_dists": nx.dists}


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


def packed_tie_check(work: Path, seed: int, res: dict, fault_builds: dict) -> None:
    """The packed searcher keeps equal distances in index order on an index
    of repeated rows at the paper's width; with the merge kernel's planted
    fault (ties in reverse position order) the same check must fail.  A
    copy whose rank stage selects on ``torch.topk`` is reported."""
    from repro_torch.configs.ecpfs_paper import ECPFSPaperConfig, build_cfg
    from unittest import mock

    from repro_torch.core import BatchedSearcher, batched, build_index, load_packed
    from repro_torch.data.synthetic import clustered_vectors

    copies = 4
    base, _ = clustered_vectors(seed + 5, n=1024 + 16, dim=D)
    data = np.repeat(base[:1024], copies, axis=0)
    fs = work / "ties_fs"
    build_index(data, str(fs), build_cfg(ECPFSPaperConfig(n_items=len(data))))
    packed = load_packed(str(fs))
    Qt = base[1024:]
    good = BatchedSearcher(packed)
    reset_all_launches()
    rs = good.search(Qt, 40, b=4)
    launched = all_launches()
    assert launched["leaf_distances"] > 0 and launched["leaf_merge"] == launched["leaf_distances"], launched
    groups = rs.dists.reshape(len(Qt), -1, copies)
    exact = float(np.mean(np.all(groups == groups[..., :1], axis=-1)))
    assert exact == 1.0, f"the copies' distances do not tie exactly ({exact:.3f} of groups do)"
    ties_in_index_order("packed ties", rs, copies)
    # the same shape twice more: captured into CUDA graphs, then replayed
    for n in range(2):
        again = good.search(Qt, 40, b=4)
        assert np.array_equal(again.ids, rs.ids) and np.array_equal(again.dists, rs.dists), \
            f"packed ties: search {n + 2} (a CUDA graph's replay) differs from the first, eager one"
    assert len(good._graphs) == 1, "the tie check's shape was not captured"
    found = {}
    (fault,) = load_faults(fault_builds, "leaf_merge").values()
    for name in ("torch.topk", "planted"):
        other = BatchedSearcher(packed)
        try:
            with planted(fault) if name == "planted" else mock.patch.object(batched, "ascending_top_k",
                                                                              topk_by_distance):
                ties_in_index_order(name, other.search(Qt, 40, b=4), copies)
            found[name] = False
        except AssertionError as e:
            found[name] = str(e)
        del other
    assert found["planted"], "the planted merge fault (ties against position order) passed the tie check"
    res["serve"]["ties"] = {"groups_tied": exact, "launches": launched, **found}
    log(f"[serve] packed tie check on {len(data)} rows ({copies} copies each, dim {D}): ties in index "
        f"order; planted merge fault (ties against position order) seen: {found['planted']}; a copy "
        f"ranking on torch.topk (no promised tie order) broke it here: {found['torch.topk']}")
    shutil.rmtree(fs)


def phase_serve(work: Path, data, Q, cfg, res: dict, built: dict, seed: int, fault_builds: dict) -> None:
    """The serving path of ``launch/serve.py`` on the main phase's 200k
    collection, through ``Server``: (a) interactive quantized file mode,
    (b) the write path, (c) the 4-worker scheduler over snapshots while a
    writer inserts, (d) the batched server, packed mode on the card."""
    import threading

    import torch
    from repro_torch.configs.ecpfs_paper import build_cfg
    from repro_torch.core import BatchedSearcher, build_index, open_index
    from repro_torch.kernels.distance_topk import ops
    from repro_torch.kernels.leaf_distances.ref import SCAN_BUDGET_BYTES
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
    reset_all_launches()
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
    limit = SCAN_BUDGET_BYTES + 8 * len(Q) * (C + b * cap) * 8
    out["batched_launches"] = all_launches()
    bl = out["batched_launches"]
    assert bl["leaf_distances"] > 0 and bl["leaf_merge"] == bl["leaf_distances"], bl
    assert peak <= limit, f"the packed scan took {peak} B beyond the resident index (limit {limit})"
    # the same shape again: its second search captures it into CUDA graphs
    # (the memory their pool holds read around it), the third replays them
    pooled = graph_pool_bytes()
    rs2, sid2 = bsrv.search(Q, k=k, b=b, b_internal=w)
    nx2 = bsrv.more(sid2, k)
    out["graph_pool_bytes"] = graph_pool = graph_pool_bytes() - pooled
    assert len(bs._graphs) == 1, "serve (d)'s second search of its shape did not capture it"
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    rs3, sid3 = bsrv.search(Q, k=k, b=b, b_internal=w)
    nx3 = bsrv.more(sid3, k)
    replay_peak = torch.cuda.max_memory_allocated() - resident
    out["replayed_launches"] = all_launches()
    assert out["replayed_launches"] == bl, f"a replayed search + more launched {out['replayed_launches']}, not {bl}"
    assert replay_peak <= limit, f"the replayed scan took {replay_peak} B beyond the index (limit {limit})"
    for n, (a, m) in enumerate(((rs2, nx2), (rs3, nx3))):
        for what, x, y in (("search", a, rs), ("more", m, nx)):
            assert np.array_equal(x.ids, y.ids) and np.array_equal(x.dists, y.dists), \
                f"serve (d) {what} {n + 2} (captured, then replayed) differs from the first, eager one"
    bsrv.close(sid2)
    bsrv.close(sid3)
    # the profiler's kernel records of a replayed search + more, apart from
    # the launch counters: each packed kernel as often as eagerly
    names = {"leaf_distances": "leaf_distances_kernel", "leaf_merge": "leaf_merge_kernel"}
    want = {n: bl[n] for n in names}

    def replayed():
        r, i = bsrv.search(Q, k=k, b=b, b_internal=w)
        bsrv.more(i, k)
        bsrv.close(i)

    seen = []
    for _ in range(8):
        ks = [e.name for e in traced_kernels(replayed, 1)]
        seen.append({n: sum(kn in x for x in ks) for n, kn in names.items()})
        # a dropped record can only hide a launch, never add one
        assert all(seen[-1][n] <= want[n] for n in names), f"replayed kernels {seen} against {want}"
        if seen[-1] == want:
            break
    assert seen[-1] == want, f"no trace of a replayed search kept its kernels: {seen} against {want}"
    out["replayed_profiled"] = {"kernels": seen[-1], "traces": len(seen)}
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
                      "replay_scan_peak_bytes": int(replay_peak),
                      "leaves": n_leaves, "cap_padded": cap, "max_abs_err": err,
                      "overlap_with_file_mode_at_b": overlap}
    log(f"[serve] (d) packed: resident {bs.device_bytes / 1e9:.3f} GB ({n_leaves} leaves padded to {cap} rows), "
        f"loaded in {out['packed_load_s']:.3f} s; 128 queries k={k} b={b} b_internal={w}: "
        f"{out['batched_search_s'] * 1e3:.3f} ms, more({k}) {out['batched_more_s'] * 1e3:.3f} ms; scan peak "
        f"{peak / 1e9:.3f} GB beyond the index (limit {limit / 1e9:.3f}); the shape's 2nd search captured "
        f"(graphs' pool {graph_pool / 1e9:.3f} GB), the 3rd replayed: pages bit-identical, launches "
        f"{out['replayed_launches']}, profiled kernels {out['replayed_profiled']}, scan peak "
        f"{replay_peak / 1e9:.3f} GB; host scan of the same leaves agrees "
        f"(32 queries) "
        f"(max abs err {err:.3g}); next = ranks {k}-{2 * k - 1} of k={2 * k}; with every leaf scanned, ids agree "
        f"with file mode (8 queries); at b={b} the two traversals share {overlap:.4f} of their top {k}; launches "
        f"{out['batched_launches']}")
    bsrv.shutdown()
    del bs, state
    torch.cuda.empty_cache()
    out["part_s"]["d"] = time.perf_counter() - t_phase - sum(out["part_s"].values())
    packed_tie_check(work, seed, res, fault_builds)
    out["part_s"]["ties"] = time.perf_counter() - t_phase - sum(out["part_s"].values())
    w2 = bytes_written()
    out["bytes_written"] = None if w0 is None else w2 - w0
    log(f"[serve] seconds by part {json.dumps(out['part_s'])}; bytes written by this process in the "
        f"phase: {out['bytes_written']}; in the run so far: {w2}")


# -------------------------------------------------------------- read path
def same_rows(what: str, rs, ids, dists) -> None:
    """``rs`` against rows of results computed earlier (``[R, k]``)."""
    a_ids, a_d = np.atleast_2d(rs.ids), np.atleast_2d(rs.dists)
    assert np.array_equal(a_ids, ids) and np.array_equal(a_d, dists), f"{what}: results differ"


def same_up_to_ties(what: str, a, b) -> int:
    """``a`` and ``b`` hold the same distances, and in every run of equal
    distances the same ids; returns the positions whose id differs."""
    assert np.array_equal(a.dists, b.dists), f"{what}: distances differ"
    for r in range(len(b.dists)):
        d = b.dists[r]
        starts = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
        for lo, hi in zip(starts, np.r_[starts[1:], len(d)]):
            assert sorted(a.ids[r][lo:hi]) == sorted(b.ids[r][lo:hi]), f"{what}: row {r} ids differ at {lo}"
    return int((a.ids != b.ids).sum())


def prefetch_io(idx) -> dict:
    """The prefetch store's counters once its background reads settled."""
    idx.store.drain()
    idx.flush_prefetch_stats()
    io = idx.store.io
    return {"issued": io.prefetch_issued, "hits": io.prefetch_hits, "wasted_bytes": io.prefetch_wasted_bytes,
            "suppressed_keys": idx.store.prefetch_suppressed, "bytes_read": io.bytes_read,
            "reads_issued": io.reads_issued}


def phase_read_path(work: Path, Q, cfg, res: dict, built: dict) -> None:
    """The rest of the paper's read path on the main phase's 200k index,
    each result held against the main phase's own: (a) the async prefetch
    store under quantized rounds, (b) pinned internal levels, (c) the
    legacy engine, (d) saved queries."""
    from repro_torch.core import AsyncPrefetchStore, ECPIndex, open_index, open_store
    from repro_torch.kernels.distance_topk import ops

    out = res.setdefault("read", {"part_s": {}, "launches": {}})
    blob, fs = str(built["blob"]), str(built["fs"])
    k, b = cfg.k, cfg.b
    want_ids, want_d, nx_ids, nx_d = built["ids"], built["dists"], built["nx_ids"], built["nx_dists"]

    # ---------------- (a) 32 queries through the async prefetch store, quantized
    # the store's defaults, then a byte cap that admits nodes of this index
    # (the default 4 MiB is below one node's slot estimate, the blob's
    # fixed block of the largest leaf, so every key is suppressed)
    n = 32
    for tag in ("prefetch", "prefetch_cap"):
        t0 = time.perf_counter()
        if tag == "prefetch":
            idx = open_index(blob, mode="file", backend="blob+prefetch", quantized=True)
        else:
            store = AsyncPrefetchStore(open_store(blob), max_inflight_bytes=PREFETCH_CAP)
            idx = open_index(store, mode="file", quantized=True)
        ops.reset_launches()
        rs = idx.search(Q[:n], k, b=b)
        nx = rs.query.next(k)
        out["launches"][tag] = dict(ops.launches)
        out[f"{tag}_io"] = prefetch_io(idx)
        same_rows(f"read (a) {tag} search", rs, want_ids[:n], want_d[:n])
        same_rows(f"read (a) {tag} next", nx, nx_ids[:n], nx_d[:n])
        assert out["launches"][tag]["grouped_distance_topk"] > 0, out["launches"][tag]
        idx.close()
        idx.store.close()  # a caller's store stays open after the index closes
        out["part_s"][tag] = time.perf_counter() - t0
        log(f"[read] (a) {tag}: {n} queries + next({k}) bit-identical to the main phase in "
            f"{out['part_s'][tag]:.3f} s; prefetch {json.dumps(out[f'{tag}_io'])}; launches {out['launches'][tag]}")
    assert out["prefetch_cap_io"]["issued"] > 0, out["prefetch_cap_io"]

    # ---------------- (b) pinned internal levels: a search reads no internal node
    t0 = time.perf_counter()
    idx = open_index(blob, mode="file", quantized=True, pin_internal=True)
    pinned, before = idx.cache.n_pinned, idx.store.io.internal_reads
    assert pinned == idx.info.nodes_per_level[0], (pinned, idx.info.nodes_per_level)
    ops.reset_launches()
    rs = idx.search(Q[:8], k, b=b)
    out["launches"]["pin_internal"] = dict(ops.launches)
    internal = idx.store.io.internal_reads - before
    same_rows("read (b) pin_internal search", rs, want_ids[:8], want_d[:8])
    assert internal == 0, internal
    assert out["launches"]["pin_internal"]["grouped_distance_topk"] > 0
    idx.close()
    out["pin_internal"] = {"pinned_nodes": pinned, "internal_reads": internal}
    out["part_s"]["pin_internal"] = time.perf_counter() - t0
    log(f"[read] (b) pin_internal: {pinned} internal nodes pinned at open, 8 searches read {internal} internal "
        f"nodes, bit-identical, in {out['part_s']['pin_internal']:.3f} s")

    # ---------------- (c) the legacy engine: timed on one query, then as many as fit LEGACY_S
    t0 = time.perf_counter()
    leg = open_index(blob, mode="file", engine="legacy")
    times = []
    for r in range(8):
        t1 = time.perf_counter()
        rs = leg.search(Q[r], k, b=b)
        nx = rs.query.next(k)
        times.append(time.perf_counter() - t1)
        same_rows(f"read (c) legacy search {r}", rs, want_ids[r : r + 1], want_d[r : r + 1])
        same_rows(f"read (c) legacy next {r}", nx, nx_ids[r : r + 1], nx_d[r : r + 1])
        if sum(times) + times[0] > LEGACY_S:
            break
    leg.close()
    out["legacy"] = {"queries": len(times), "s_per_query": times}
    out["part_s"]["legacy"] = time.perf_counter() - t0
    log(f"[read] (c) legacy engine: {len(times)} queries + next({k}) bit-identical to the flat engine; seconds "
        f"each {[round(t, 3) for t in times]}")

    # ---------------- (d) saved queries on the fstore form, fp and quantized
    # after next(k), a continuation past the candidates the saved state
    # holds, which the restored query must find by traversing on; the
    # oracle of both is an fp engine of its own over the blob form
    t0 = time.perf_counter()
    out["saved"] = {}
    deep = oracle = None
    for quantized in (False, True):
        tag = "quantized" if quantized else "fp"
        rs = open_index(fs, mode="file", quantized=quantized).search(Q[:4], k, b=b)
        same_rows(f"read (d) {tag} search on the fstore", rs, want_ids[:4], want_d[:4])
        token = rs.query.save(name=f"smoke_{tag}")
        fresh = ECPIndex(fs, quantized=quantized)
        restored = fresh.load_query(token)
        ops.reset_launches()
        nx = restored.next(k)
        if deep is None:
            deep = max(len(st.I) for st in restored.states) + 1
        far = restored.next(deep)
        out["launches"][f"saved_{tag}"] = dict(ops.launches)
        same_rows(f"read (d) {tag} restored next", nx, nx_ids[:4], nx_d[:4])
        same_rows(f"read (d) {tag} unsaved next", rs.query.next(k), nx_ids[:4], nx_d[:4])
        unsaved = rs.query.next(deep)
        if oracle is None:
            with open_index(blob, mode="file", quantized=False) as fp:
                ors = fp.search(Q[:4], k, b=b)
                same_rows("read (d) oracle next", ors.query.next(k), nx_ids[:4], nx_d[:4])
                oracle = ors.query.next(deep)
        same_rs(f"read (d) {tag} restored next({deep}) vs the oracle's", far, oracle)
        if quantized:
            # the unsaved quantized query scans the leaves its earlier call
            # read in full on the fp path, staged before the increment's
            # quantized leaves: rows of different leaves at exactly equal
            # distances then come out in another order, in both packages
            # (ROADMAP Queue 3)
            swapped = same_up_to_ties(f"read (d) {tag} unsaved next({deep}) vs the oracle's", unsaved, oracle)
        else:
            same_rs(f"read (d) {tag} unsaved next({deep}) vs the oracle's", unsaved, oracle)
            swapped = 0
        out["saved"][tag] = {"deep_k": deep, "rounds": sum(st.stats.rounds for st in restored.states),
                             "unsaved_tie_swaps": swapped}
        fresh.close()
    assert out["launches"]["saved_quantized"]["grouped_distance_topk"] > 0, out["launches"]
    out["saved_bytes"] = sum(p.stat().st_size for p in (built["fs"] / "query_states").rglob("*") if p.is_file())
    out["part_s"]["save_load"] = time.perf_counter() - t0
    log(f"[read] (d) Query.save -> load_query in a fresh ECPIndex -> next({k}) (4 queries each, the main phase's "
        f"results), then next({deep}), past the saved candidates (an fp engine's on the blob; the unsaved fp "
        f"query's too, the unsaved quantized one's up to the order of equal distances): {json.dumps(out['saved'])}; {out['saved_bytes']} bytes of saved "
        f"state; launches {out['launches']['saved_quantized']}; {out['part_s']['save_load']:.3f} s")


def phase_session(Q, Q2, res: dict, built: dict, built2: dict, cfg) -> None:
    """(e) ``MultiIndexSession``: the 200k index (quantized, its fstore) and
    the l2 phase's 50k index (fp, leaves scored by ``make_kernel_scorer``)
    under one byte budget below either index's leaves: evictions above 0,
    and each index answers as the phases that opened it alone did."""
    from repro_torch.core import MultiIndexSession, make_kernel_scorer
    from repro_torch.kernels.distance_topk import ops

    out = res["read"]
    k, b, n = cfg.k, cfg.b, 8
    # the leaves as the cache holds them: float32 rows and int64 ids
    leaf_bytes = [x["n_items"] * (cfg.dim * 4 + 8) for x in (built, built2)]
    assert SESSION_BYTES < min(leaf_bytes), (SESSION_BYTES, leaf_bytes)
    t0 = time.perf_counter()
    with MultiIndexSession(cache_bytes=SESSION_BYTES) as sess:
        big = sess.open(str(built["fs"]), name="main", quantized=True)
        small = sess.open(str(built2["blob"]), name="l2", scorer=make_kernel_scorer())
        ops.reset_launches()
        for r in range(0, n, 2):  # the two indexes in turns, two queries a call
            a = big.search(Q[r : r + 2], k, b=b)
            c = small.search(Q2[r : r + 2], k, b=b)
            same_rows(f"read (e) session main rows {r}", a, built["ids"][r : r + 2], built["dists"][r : r + 2])
            compare_topk(f"read (e) session l2 rows {r} (kernel scorer) vs the l2 phase", c.dists, c.ids,
                         built2["dists"][r : r + 2], built2["ids"][r : r + 2])
            assert sess.cache.resident_bytes <= SESSION_BYTES
        out["launches"]["session"] = dict(ops.launches)
        st = sess.stats()
    assert st["evictions"] > 0, st
    assert all(v > 0 for v in out["launches"]["session"].values()), out["launches"]["session"]
    out["session"] = {"budget_bytes": SESSION_BYTES, "leaf_bytes": leaf_bytes, **st}
    out["part_s"]["session"] = time.perf_counter() - t0
    log(f"[read] (e) MultiIndexSession, budget {SESSION_BYTES} B (leaves {leaf_bytes} B): {n} queries "
        f"each, main bit-identical, l2 within the kernel tolerance; stats {json.dumps(st)}; launches "
        f"{out['launches']['session']}; {out['part_s']['session']:.3f} s")


# ------------------------------------------------------------- federation
def stat_counters(st) -> dict:
    """Every counter of a ``SearchStats``, its ``IOStats`` included."""
    io = st.io.as_dict()
    return {**{f: getattr(st, f) for f in ("node_loads", "nodes_opened", "leaves_opened", "distance_calcs",
                                           "increments", "rounds", "dedup_hits", "kernel_launches")},
            **{f"io.{a}": v for a, v in io.items()}}


def quant_split(times) -> dict:
    """Indexes' ``quant_times`` summed (staging and rerank on the host
    clock, the copy and the kernel on CUDA events), in seconds, with the
    rounds."""
    tot = {}
    for t in times:
        for a, v in t.items():
            tot[a] = tot.get(a, 0) + v
    return {"rounds": tot["rounds"], **{a[:-3] + "_s": tot[a] / 1e3 for a in tot if a.endswith("_ms")}}


def phase_federation(work: Path, data, Q, cfg, res: dict, built: dict) -> None:
    """3b. The main collection as a federation of FED_SHARDS shards, each
    built on the card, converted with its int8 companion and joined by a
    manifest; ``open_index(root, quantized=True)`` with no mode opens it
    (a federation stays one on a GPU).  FED_QUERIES queries, search and
    ``next(k)``: (i) identical to the same federation's fp shards on the
    host engine (a refill past a shard's candidates may order rows of equal
    distance otherwise, ROADMAP Queue 3: counted and printed), (ii) every
    row's allocation sums to b, each probed shard at ``b_min`` or above,
    (iii) each row's aggregate counters are the sum of its shards', (iv)
    the grouped kernel launched in every shard.  Then a one-shard manifest
    over the main phase's own quantized blob answers as the main phase."""
    import os

    import torch
    from repro_torch.configs.ecpfs_paper import build_cfg
    from repro_torch.core import FederatedIndex, build_federation, convert, open_index
    from repro_torch.core.federation import FederationManifest
    from repro_torch.kernels.distance_topk import ops

    out = res["federation"] = {}
    k, b, n = cfg.k, cfg.b, FED_QUERIES
    bc = build_cfg(cfg)
    w0 = bytes_written()
    t_phase = time.perf_counter()
    root = work / "fed"
    t0 = time.perf_counter()
    build_federation(data, root / "fs", n_shards=FED_SHARDS, cfg=bc, backend="fstore")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entries = []
    for e in FederationManifest.load(root / "fs").shards:
        shard = convert(str(root / "fs" / e["path"]), root / f"{e['name']}.blob", quant="int8")
        entries.append({"name": e["name"], "path": shard.name, "backend": "blob"})
    FederationManifest(metric=bc.metric, dim=cfg.dim, dtype=bc.storage_dtype, shards=entries).save(root)
    shutil.rmtree(root / "fs")
    out["convert_s"] = time.perf_counter() - t0
    out["blob_bytes"] = sum((root / e["path"]).stat().st_size for e in entries)

    fed = open_index(str(root), quantized=True)
    assert isinstance(fed, FederatedIndex) and fed.device.type == "cuda", type(fed)
    names = fed.shard_names
    ops.reset_launches()
    t0 = time.perf_counter()
    rs = fed.search(Q[:n], k, b=b)
    out["search_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nx = rs.query.next(k)
    out["next_s"] = time.perf_counter() - t0
    out["launches"] = dict(ops.launches)
    per_row = rs.query.shard_stats
    per_shard = {nm: sum(row[nm].kernel_launches for row in per_row if nm in row) for nm in names}
    out["shard_launches"] = per_shard
    assert sum(per_shard.values()) == out["launches"]["grouped_distance_topk"], (per_shard, out["launches"])
    assert all(v > 0 for v in per_shard.values()), f"a shard never launched the grouped kernel: {per_shard}"
    # (ii) the effort split, (iii) the aggregate counters
    allocs = rs.query.allocation
    for r, a in enumerate(allocs):
        assert sum(a.values()) == b and all(v >= fed.b_min for v in a.values()), (r, a)
    for r, (tot, per) in enumerate(zip(rs.query.stats, per_row)):
        summed = {}
        for st in per.values():
            for f, v in stat_counters(st).items():
                summed[f] = summed.get(f, 0) + v
        assert stat_counters(tot) == summed, (r, stat_counters(tot), summed)
    probed = [len(a) for a in allocs]
    out["probed_shards"] = {"min": min(probed), "max": max(probed), "mean": float(np.mean(probed))}
    out["quant_times"] = quant_split(fed.shard(nm).quant_times for nm in names)
    # (i) the same federation, fp shards on the host engine
    fp = open_index(str(root))
    t0 = time.perf_counter()
    frs = fp.search(Q[:n], k, b=b)
    fnx = frs.query.next(k)
    out["fp_s"] = time.perf_counter() - t0
    assert rs.ids.shape == (n, k) and np.isfinite(rs.dists).all()
    same_rs("federation (i) search vs the fp shards", rs, frs)
    out["next_tie_swaps"] = same_up_to_ties("federation (i) next vs the fp shards", nx, fnx)
    fp.close()
    fed.close()
    out["recall_at_k"] = recall(rs.ids, built["gt"][:n], k)
    out["single_index_recall_at_k"] = recall(built["ids"][:n], built["gt"][:n], k)
    out["part_s"] = {"four_shards": time.perf_counter() - t_phase}
    log(f"[federation] {FED_SHARDS} shards of {len(data)} items: built on the card in {out['build_s']:.3f} s, "
        f"converted (int8) in {out['convert_s']:.3f} s, {out['blob_bytes'] / 1e9:.3f} GB of blobs; "
        f"open_index(root, quantized=True) -> FederatedIndex on cuda; {n} queries k={k} b={b}: search "
        f"{out['search_s']:.3f} s, next({k}) {out['next_s']:.3f} s; grouped launches by shard {per_shard} "
        f"(total {out['launches']}); shards probed a row {out['probed_shards']}; the shards' scan "
        f"{json.dumps(out['quant_times'])}; allocations sum to {b}; "
        f"aggregate counters = the shards' sum; search identical to the fp shards ({out['fp_s']:.3f} s), "
        f"next up to the order of equal distances ({out['next_tie_swaps']} positions swapped); recall@{k} "
        f"{out['recall_at_k']:.4f} (the single index on the same {n} queries: "
        f"{out['single_index_recall_at_k']:.4f})")
    shutil.rmtree(root)

    # a one-shard manifest over the main phase's own quantized blob
    t0 = time.perf_counter()
    one = work / "fed_one"
    one.mkdir()
    FederationManifest(metric=bc.metric, dim=cfg.dim, dtype=bc.storage_dtype, shards=[
        {"name": "main", "path": os.path.relpath(built["blob"], one), "backend": "blob"}]).save(one)
    with open_index(str(one), quantized=True) as f1:
        ops.reset_launches()
        r1 = f1.search(Q[:n], k, b=b)
        same_rows("federation, one shard: search vs the main phase", r1, built["ids"][:n], built["dists"][:n])
        same_rows("federation, one shard: next vs the main phase", r1.query.next(k),
                  built["nx_ids"][:n], built["nx_dists"][:n])
        out["one_shard_launches"] = dict(ops.launches)
        out["one_shard_quant_times"] = quant_split([f1.shard("main").quant_times])
    shutil.rmtree(one)
    out["part_s"]["one_shard"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    w1 = bytes_written()
    out["bytes_written"] = None if w0 is None else w1 - w0
    log(f"[federation] a one-shard manifest over the main blob: {n} queries + next({k}) identical to the main "
        f"phase in {out['part_s']['one_shard']:.3f} s (launches {out['one_shard_launches']}; its scan "
        f"{json.dumps(out['one_shard_quant_times'])}, the main phase's batch of {len(Q)} "
        f"{json.dumps(quant_split([res['main']['quant_times']]))}); phase "
        f"{out['phase_s']:.3f} s; bytes written by the phase {out['bytes_written']}, by the run so far {w1}")


# -------------------------------------------------------------- baselines
def phase_baselines(work: Path, data, Q, cfg, res: dict, built: dict) -> None:
    """3c. The paper's baselines on the main collection as stored (float16,
    as float32): ``BruteForce`` (the batch's distance block on the card)
    held against the main phase's ground truth; ``IVFIndex`` with IVF_LISTS
    lists (the main index's leaves) and IVF_ITERS k-means iterations, the
    assignment on the card (held against the host's on a sample) and the
    update on the host, timed apart; its search at nprobe = b (the paper's
    matching) and ``next(k)``, none of which launches a hand-written
    kernel; packed mode's batch, which launches ``leaf_distances``; then
    one line of recall@k and batch time for eCP-FS (file mode quantized,
    packed), the federation and IVF, all against BruteForce.  ``HNSWLite`` and
    ``VamanaLite`` do no device work in either package and their Python
    builds take minutes at these widths: the CPU tests hold them."""
    import torch
    from repro_torch.core import BatchedSearcher, open_index
    from repro_torch.core.baselines import BruteForce, IVFIndex, kmeans
    from repro_torch.core.distances import np_distances, torch_distances

    out = res["baselines"] = {}
    k, b, metric = cfg.k, cfg.b, cfg.metric
    t_phase = time.perf_counter()
    stored = data.astype(np.float16).astype(np.float32)
    reset_all_launches()
    # ---- brute force: the device block, then the host argsort
    bf = BruteForce(stored, metric)
    bf.search(Q[:2], k)  # the collection goes to the card once
    t0 = time.perf_counter()
    brs = bf.search(Q, k)
    out["bf_s"] = time.perf_counter() - t0
    qt = torch.from_numpy(Q).cuda()
    out["bf_block_ms"] = cuda_ms(lambda: torch_distances(qt, bf._device_data(), metric), iters=5, warmup=1)
    err = 0.0
    for r in range(len(Q)):  # the ground truth's distances on the host, in its order
        g = built["gt"][r]
        dg = np_distances(Q[r], stored[g], metric)[None]
        err = max(err, compare_topk(f"BruteForce row {r} vs the main phase's ground truth",
                                    brs.dists[r : r + 1], brs.ids[r : r + 1], dg, g[None]))
    out["bf_vs_gt"] = {"max_abs_err": err, "positions_differing": int((brs.ids != built["gt"]).sum())}
    del bf
    # ---- IVF: k-means with the assignment on the card
    sample = stored[:20000]
    dev = kmeans(sample, 64, iters=2, metric=metric)
    host = kmeans(sample, 64, iters=2, metric=metric, device="cpu")
    out["kmeans_sample_assign_equal"] = float(np.mean(dev[1] == host[1]))
    assert out["kmeans_sample_assign_equal"] > 0.999, out["kmeans_sample_assign_equal"]
    timings = {}
    t0 = time.perf_counter()
    ivf = IVFIndex(stored, n_lists=IVF_LISTS, train_iters=IVF_ITERS, metric=metric, timings=timings)
    out["ivf_build_s"] = time.perf_counter() - t0
    out["kmeans_s"] = timings
    sizes = np.array([len(x) for x in ivf.lists])
    assert sizes.sum() == len(stored)
    t0 = time.perf_counter()
    irs = ivf.search(Q, k, b=b)
    out["ivf_search_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inx = irs.query.next(k)
    out["ivf_next_s"] = time.perf_counter() - t0
    assert irs.ids.shape == (len(Q), k) and np.isfinite(irs.dists).all() and inx.ids.shape == (len(Q), k)
    assert not (set(irs.ids[0]) & set(inx.ids[0]))
    out["launches"] = all_launches()
    assert not any(out["launches"].values()), f"the baselines launched a hand-written kernel: {out['launches']}"
    del ivf
    # ---- packed mode's batch, for the comparison
    t0 = time.perf_counter()
    pk = open_index(str(built["fs"]))
    assert isinstance(pk, BatchedSearcher), type(pk)
    out["packed_load_s"] = time.perf_counter() - t0
    reset_all_launches()
    t0 = time.perf_counter()
    prs = pk.search(Q, k, b=b, b_internal=pk.info.nodes_per_level[0])
    out["packed_s"] = time.perf_counter() - t0
    out["packed_launches"] = all_launches()
    pl = out["packed_launches"]
    assert pl["leaf_distances"] > 0 and pl["leaf_merge"] == pl["leaf_distances"], pl
    del pk
    torch.cuda.empty_cache()
    n = FED_QUERIES
    fed = res["federation"]
    out["compare"] = {
        "eCP-FS file, quantized": {"queries": len(Q), "recall": recall(built["ids"], brs.ids, k),
                                   "batch_s": res["main"]["search_s"]},
        "eCP-FS packed": {"queries": len(Q), "recall": recall(prs.ids, brs.ids, k), "batch_s": out["packed_s"]},
        f"federation, {FED_SHARDS} shards": {"queries": n, "recall": fed["recall_at_k"], "batch_s": fed["search_s"],
                                             "single_index_recall": fed["single_index_recall_at_k"]},
        f"IVF, nprobe={b}": {"queries": len(Q), "recall": recall(irs.ids, brs.ids, k), "batch_s": out["ivf_search_s"]},
        "BruteForce": {"queries": len(Q), "recall": 1.0, "batch_s": out["bf_s"]},
    }
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[baselines] BruteForce over {stored.shape} ({metric}): {len(Q)} queries in {out['bf_s']:.3f} s (the "
        f"device block {out['bf_block_ms']:.3f} ms, the rest the host argsort); ids those of the main phase's "
        f"ground truth but for ties {json.dumps(out['bf_vs_gt'])}; k-means assignment on the card equals the "
        f"host's on a 20000-row sample ({out['kmeans_sample_assign_equal']:.6f}); IVF {IVF_LISTS} lists "
        f"({sizes.min()}-{sizes.max()} rows), {IVF_ITERS} iterations: {out['ivf_build_s']:.3f} s (assignment on "
        f"the card {timings['assign_s']:.3f} s, update on the host {timings['update_s']:.3f} s); search "
        f"{out['ivf_search_s']:.3f} s, next({k}) {out['ivf_next_s']:.3f} s; packed load {out['packed_load_s']:.3f} "
        f"s; launches {out['launches']}, packed mode's {out['packed_launches']}; phase {out['phase_s']:.3f} s")
    log(f"[baselines] the paper's comparison at {len(data)} items, recall@{k} against BruteForce and batch "
        f"seconds: {json.dumps(out['compare'])}")



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
    # llama4-scout's heads: a GQA group of 5 (phi4-mini's is 3)
    qs, ks, vs = flash_inputs(14, 1, 40, 8, 4096, 4096, d, torch.bfloat16)
    check("bf16 1x40x4096x128 (llama4-scout's heads)", *flash_pair(qs, ks, vs))
    log(f"[flash] bf16 [1,40,4096,128] x [1,8,4096,128] causal (llama4-scout's heads) agrees (max abs err so far "
        f"{err:.3g}, max row err {row:.3g})")
    del qs, ks, vs
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
    sdpa32 = lambda: F.scaled_dot_product_attention(qc, k32, v32, is_causal=True, enable_gqa=True)
    t32["library_ms"] = cuda_ms(sdpa32, 5, 1)
    t32["device_ms"], t32["profiled_kernels_per_call"] = device_time(lambda: ops.flash_attention(q32, k32, v32), 3)
    t32["kernels_per_call"] = captured_kernels(lambda: ops.flash_attention(q32, k32, v32))
    t32["library_device_ms"], t32["library_kernels_per_call"] = device_time(sdpa32, 3, whole=False)
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
def lm_run(params, tokens, cfg, decode_tokens=None, n_decode: int = N_DECODE) -> dict:
    """prefill then ``n_decode`` decode steps through the user's entry
    points; greedy next tokens unless ``decode_tokens`` are given.  Returns
    the logits of every step (on the host) and the times."""
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
        logits, cache = T.prefill(params, tokens, cfg, max_seq=S + n_decode)
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
    for i in range(n_decode):
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


def mem_line() -> str:
    import torch

    free, total = torch.cuda.mem_get_info()
    return (f"free {free / 2**30:.3f} GiB of {total / 2**30:.3f} GiB (allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.3f}, reserved {torch.cuda.memory_reserved() / 2**30:.3f})")


def graph_pool_bytes() -> int:
    """Bytes the caching allocator holds for CUDA graphs: its segments in
    pools other than the default one, allocated or not (a capture empties
    the default pool's cache, so ``memory_reserved`` around it reads the
    release, not the graphs)."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def reset_all_launches() -> None:
    from repro_torch.kernels import leaf_distances as lops
    from repro_torch.kernels import leaf_merge as mops
    from repro_torch.kernels.distance_topk import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops

    fops.reset_launches()
    dops.reset_launches()
    lops.reset_launches()
    mops.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels import leaf_distances as lops
    from repro_torch.kernels import leaf_merge as mops
    from repro_torch.kernels.distance_topk import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops

    return {**fops.launches, **dops.launches, **lops.launches, **mops.launches}


def within(what: str, o, e, rtol: float = RETR_TOL) -> float:
    """|o - e| <= rtol * (1 + |e|) everywhere; returns the largest absolute error."""
    import torch

    assert torch.isfinite(o).all(), f"{what}: non-finite output"
    err = (o - e).abs()
    bad = err > rtol * (1 + e.abs())
    assert not bad.any(), f"{what}: {int(bad.sum())} entries off, max abs err {float(err.max())}"
    return float(err.max())


# ---------------------------------------------------------- long_500k phase
def fill_clustered_cache(cache, pos: int, g, chunk: int = 64) -> None:
    """Every layer's k and v drawn from ``g``'s normals straight into the
    cache's dtype, one layer at a time, zeros from token ``pos`` on; each
    centroid the float32 mean of its cluster's written keys, ``chunk``
    clusters at a time (no layer-sized float32 copy)."""
    import torch

    L, _, _, nC, cs, _ = cache.k.shape
    cid, off = divmod(pos, cs)
    for i in range(L):
        for t in (cache.k[i], cache.v[i]):
            t.normal_(generator=g)
            t[:, :, cid, off:] = 0
            t[:, :, cid + 1:] = 0
        for c0 in range(0, cid, chunk):
            c1 = min(c0 + chunk, cid)
            cache.centroids[i, :, :, c0:c1] = cache.k[i, :, :, c0:c1].to(torch.float32).mean(3)
        if off:
            cache.centroids[i, :, :, cid] = cache.k[i, :, :, cid, :off].to(torch.float32).mean(2)
    cache.pos = pos


def masked_exact_attention(q, layer_k, layer_v, token_mask, chunk: int = 64):
    """Exact attention of q [B, Hq, d] over the tokens of one layer's
    clustered cache [B, Hkv, nC, cs, d] that ``token_mask`` [B, Hkv, nC, cs]
    admits: float32 scores, one softmax over the whole layer, k and v read
    ``chunk`` clusters at a time.  Returns [B, Hq, d] float32."""
    import torch

    B, Hq, d = q.shape
    _, Hkv, nC, cs, _ = layer_k.shape
    qg = (q.to(torch.float32) * (1.0 / d**0.5)).reshape(B, Hkv, Hq // Hkv, d)
    s = torch.empty((B, Hkv, Hq // Hkv, nC, cs), device=q.device)
    for c0 in range(0, nC, chunk):
        s[:, :, :, c0:c0 + chunk] = torch.einsum("bhgd,bhncd->bhgnc", qg, layer_k[:, :, c0:c0 + chunk].float())
    s.masked_fill_(~token_mask[:, :, None], -torch.inf)
    p = torch.softmax(s.reshape(B, Hkv, Hq // Hkv, nC * cs), dim=-1).reshape(s.shape)
    out = torch.zeros((B, Hkv, Hq // Hkv, d), device=q.device)
    for c0 in range(0, nC, chunk):
        out += torch.einsum("bhgnc,bhncd->bhgd", p[:, :, :, c0:c0 + chunk], layer_v[:, :, c0:c0 + chunk].float())
    return out.reshape(B, Hq, d)


def decode_bytes(cfg, batch: int) -> int:
    """Weight bytes one decode step must read: every weight but the
    embedding table, of which it reads one row a sequence."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.base import param_count

    n = param_count(T.param_specs(cfg)) - cfg.vocab * cfg.d_model + batch * cfg.d_model
    return n * torch.empty((), dtype=cfg.dtype).element_size()


def phase_long500k(res: dict, seed: int) -> None:
    """[long500k]: ``retrieval_decode_step`` of phi4-mini at full width and
    depth over ``long_500k``'s 524288-token clustered cache, 16 steps in
    place.  A prompt-filled cache cannot be built on one card: a flash
    prefill of 524288 tokens needs ~25 GB of activations on top of the
    64 GiB cache.  So the cache is filled from the seeded generator (k and v
    normals, the centroids their clusters' means) up to 300 tokens before
    its end.  The exact decode over 524288 keys is not run either: the
    chunked attention's float32 copies of a layer's GQA-expanded k and v
    (~16 GB) do not fit beside the cache; it is held against retrieval
    attention on a sub-cache instead."""
    import torch
    from repro_torch.configs import lm_archs, shapes
    from repro_torch.models import layers as NL
    from repro_torch.models import retrieval_attention as R
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import attention

    cfg = lm_archs.get("phi4-mini-3.8b")
    S, B = shapes.LM_SHAPES["long_500k"]["seq"], shapes.LM_SHAPES["long_500k"]["batch"]
    cs, top_b, d, Hkv = cfg.retrieval.cluster_size, cfg.retrieval.top_clusters, cfg.d_head, cfg.n_kv_heads
    log(f"reduced: long500k: the {S}-token clustered cache is filled with seeded normals (centroids their "
        f"clusters' means), not by a prefill of the prompt (~25 GB of flash activations beside the 64 GiB "
        f"cache); the exact decode over {S} keys is not run (its float32 k and v copies do not fit beside "
        f"the cache): held on a {LONG_SUB_CLUSTERS}-cluster sub-cache instead; width, depth "
        f"({cfg.n_layers} layers), batch {B}, cluster_size {cs} and top_clusters {top_b} as phi4-mini-3.8b's "
        f"and long_500k's")
    log(f"[long500k] device memory before it allocates: {mem_line()}")
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(seed + 500)
    params = T.init_params(cfg, g)
    cache = R.init_clustered_cache(cfg.n_layers, B, Hkv, S, cs, d, cfg.dtype)
    t0 = time.perf_counter()
    fill_clustered_cache(cache, S - LONG_TAIL, g)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    nC = cache.k.shape[3]
    log(f"[long500k] cache k, v {tuple(cache.k.shape)} {cfg.dtype}: {2 * cache.k.nbytes / 2**30:.3f} GiB, "
        f"centroids {cache.centroids.nbytes / 2**30:.3f} GiB; filled in {fill_s:.3f} s to pos {cache.pos}; "
        f"{mem_line()}")
    tokens = torch.randint(0, cfg.vocab, (LONG_STEPS, B), generator=g, device="cuda")
    lp0 = params["layers"][0]
    step_ms = []
    reset_all_launches()
    for i in range(LONG_STEPS):
        pos = cache.pos
        cid, off = divmod(pos, cs)
        before = (cache.k[:, :, :, cid, off].clone(), cache.v[:, :, :, cid, off].clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.retrieval_decode_step(params, cache, tokens[i], cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        assert logits.shape == (B, cfg.vocab) and bool(torch.isfinite(logits).all()), f"step {i}: non-finite logits"
        assert cache.pos == pos + 1, (cache.pos, pos)
        # the token's k and v land at (pos // cs, pos % cs) of every layer, and nowhere after it ...
        for kv, b in zip((cache.k, cache.v), before):
            slot = kv[:, :, :, cid, off]
            assert bool((b == 0).all()) and bool((slot != 0).any(-1).all()), f"step {i}: slot {cid, off}"
            assert bool((kv[:, :, :, cid, off + 1:] == 0).all()), f"step {i}: written past slot {cid, off}"
        del kv, slot, before
        # ... and layer 0's are the token's own projections
        h = NL.rms_norm(params["embed"][tokens[i]][:, None].to(cfg.dtype), lp0["attn_norm"])
        k0 = NL.rope((h @ lp0["wk"]).reshape(B, 1, Hkv, d), torch.full((B, 1), pos, device="cuda"), cfg.rope_theta)
        v0 = (h @ lp0["wv"]).reshape(B, Hkv, d)
        assert torch.equal(cache.k[0, :, :, cid, off], k0[:, 0]) and torch.equal(cache.v[0, :, :, cid, off], v0), i
    launches = all_launches()
    assert not any(launches.values()), f"retrieval decode launched a kernel: {launches}"
    peak = torch.cuda.max_memory_allocated()
    # one more step under the profiler: the card's kernel time in a step against the host's clock
    nxt, box = torch.randint(0, cfg.vocab, (B,), generator=g, device="cuda"), {}
    kernels = traced_kernels(lambda: box.update(out=T.retrieval_decode_step(params, cache, nxt, cfg)), 1)
    logits, cache = box.pop("out")
    assert bool(torch.isfinite(logits).all()), "the traced step's logits are not finite"
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # a trace that kept no record (the profiler drops some) measured nothing
    traced = {"kernels": len(kernels), "device_ms": sum(t for t, _ in by_name.values()) if kernels else None,
              "top_kernels_ms_count": [[name[:80], t, n] for name, (t, n) in top]}
    pos = cache.pos
    cid, n = divmod(pos, cs)

    # the current cluster's centroid is the float32 mean of its keys, in every layer
    mean = cache.k[:, :, :, cid, :n].to(torch.float32).mean(3)
    cent_rel = float(((cache.centroids[:, :, :, cid] - mean).norm(dim=-1) / mean.norm(dim=-1)).max())
    assert cent_rel <= CENTROID_RTOL, f"the current cluster's centroid is {cent_rel} off its keys' mean"

    # top_b past the complete clusters of a sub-cache (layer 0's first clusters) is exact attention
    q = torch.randn((B, cfg.n_heads, d), generator=g, device="cuda")
    sub_pos = LONG_SUB_CLUSTERS * cs - LONG_TAIL
    sk = cache.k[0, :, :, :LONG_SUB_CLUSTERS].to(torch.float32)
    sv = cache.v[0, :, :, :LONG_SUB_CLUSTERS].to(torch.float32)
    o = R.retrieval_decode_attention(q, sk, sv, cache.centroids[0, :, :, :LONG_SUB_CLUSTERS], sub_pos, cs=cs,
                                     top_b=LONG_SUB_CLUSTERS)
    flat = lambda t: t.reshape(B, Hkv, LONG_SUB_CLUSTERS * cs, d)
    e = attention(q[:, :, None], flat(sk), flat(sv), causal=True,
                  kv_lens=torch.full((B,), sub_pos, dtype=torch.int32, device="cuda"), impl="chunked")[:, :, 0]
    sub_err = within(f"retrieval over all {LONG_SUB_CLUSTERS} clusters vs chunked attention", o, e)
    del sk, sv, o, e

    # at top_b over the whole layer: exact attention masked to the top-b complete clusters, chosen by a
    # separate topk of the centroid scores, and the current cluster
    o = R.retrieval_decode_attention(q, cache.k[0], cache.v[0], cache.centroids[0], pos, cs=cs, top_b=top_b)
    qg = (q * (1.0 / d**0.5)).reshape(B, Hkv, cfg.n_heads // Hkv, d)
    scores = torch.einsum("bhgd,bhnd->bhgn", qg, cache.centroids[0]).mean(2)
    scores[..., (pos - 1) // cs:] = -torch.inf
    chosen = torch.zeros((B, Hkv, nC), dtype=torch.bool, device="cuda")
    chosen.scatter_(-1, torch.topk(scores, top_b, dim=-1).indices, True)
    chosen[..., (pos - 1) // cs] = True
    tmask = chosen[..., None] & (torch.arange(nC * cs, device="cuda").reshape(nC, cs) < pos)
    e = masked_exact_attention(q, cache.k[0], cache.v[0], tmask)
    top_err = within(f"retrieval at top_b={top_b} vs exact attention masked to the same clusters", o, e)
    del o, e, tmask

    w = decode_bytes(cfg, B)
    kv = 2 * cfg.n_layers * B * Hkv * (top_b + 1) * cs * d * cache.k.element_size()
    step_bytes = w + cache.centroids.nbytes + kv
    exact_bytes = w + 2 * cfg.n_layers * B * Hkv * pos * d * cache.k.element_size()
    out = {"layers": cfg.n_layers, "pos_first_last": [S - LONG_TAIL, pos], "fill_s": fill_s,
           "step_ms": float(np.mean(step_ms)), "step_ms_first_last": [step_ms[0], step_ms[-1]],
           "step_ms_all": step_ms, "traced_step": traced, "peak_gib": peak / 2**30, "launches": launches,
           "step_bytes": {"weights": w, "centroids": cache.centroids.nbytes, "kv_33_clusters": kv, "all": step_bytes},
           "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
           "exact_decode_bytes": exact_bytes, "exact_bound_ms": exact_bytes / HBM_BYTES_PER_S * 1e3,
           "token_scores_a_head": nC + (top_b + 1) * cs, "exact_token_scores_a_head": pos,
           "centroid_rel_err": cent_rel, "sub_cache_err": sub_err, "top_b_err": top_err}
    log(f"[long500k] {cfg.name} at {cfg.n_layers} layers, {LONG_STEPS} retrieval_decode_step over pos "
        f"{S - LONG_TAIL}..{S - LONG_TAIL + LONG_STEPS - 1} (and one traced, at {pos - 1}): {json.dumps(out)}")
    log(f"[long500k] checks: logits finite at every step; each token's k and v at (pos // {cs}, pos % {cs}) in every "
        f"layer (layer 0's bit for bit); the current centroid within {cent_rel:.3g} of its keys' mean (limit "
        f"{CENTROID_RTOL}); top_b={LONG_SUB_CLUSTERS} over a {LONG_SUB_CLUSTERS * cs}-token sub-cache equals chunked "
        f"attention (max abs err {sub_err:.3g}); top_b={top_b} over the layer equals exact attention masked to the "
        f"same clusters (max abs err {top_err:.3g}); limits {RETR_TOL} (1 + |x|)")
    res["long500k"] = out
    del params, cache, logits, tokens, q, mean, h, k0, v0
    torch.cuda.empty_cache()


# --------------------------------------------------------------- moe phase
@contextlib.contextmanager
def routing_recorded(calls: list, replay: list | None = None):
    """Each ``moe_ffn`` call of the model appends the experts its own router
    chose to ``calls`` (the tensor ``route`` made: no work on the card is
    added, so a run's times stand).  With ``replay``, another run's
    ``calls``, the i-th call dispatches to ``replay[i]``'s experts instead,
    each token gated by its own router's probability of that expert."""
    from repro_torch.models import moe as M

    real = M.route

    def recording(x, router_w):
        probs, gate, eidx = real(x, router_w)
        calls.append(eidx)
        if replay is None:
            return probs, gate, eidx
        e = replay[len(calls) - 1]
        return probs, probs.gather(1, e[:, None])[:, 0], e

    M.route = recording
    try:
        yield
    finally:
        M.route = real


def moe_check(what: str, x, lp, mcfg, g) -> dict:
    """``moe_ffn`` on x [T, D] through one MoE layer's weights, held against
    an independent reading of its dispatch: each expert keeps its first C
    tokens in token order, the others come back exactly 0 (per expert,
    max(0, n_e - C) of them), and MOE_SAMPLES kept tokens, one at a time,
    equal gate * swiglu(x_t; W_e)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe as M

    T_, E = x.shape[0], mcfg.n_experts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = M.moe_ffn(x, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], mcfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    probs = torch.softmax(x.to(torch.float32) @ lp["router"].to(torch.float32), dim=-1)
    eidx = torch.argmax(probs, dim=-1)
    C = max(1, int(mcfg.capacity_factor * T_ / E))
    onehot = F.one_hot(eidx, E)
    rank = (onehot.cumsum(0) - 1).gather(1, eidx[:, None])[:, 0]       # place in its expert's group
    keep = rank < C
    nonzero = (y != 0).any(dim=-1)
    assert torch.equal(nonzero, keep), f"moe {what}: the kept tokens are not each expert's first {C}"
    assert bool((y[~keep] == 0).all())
    n_e = onehot.sum(0)
    drops = torch.bincount(eidx[~nonzero], minlength=E)
    assert torch.equal(drops, (n_e - C).clamp_min(0)), f"moe {what}: drops by expert {drops.tolist()}"
    kept = torch.nonzero(keep)[:, 0]
    sample = kept[torch.randperm(kept.numel(), generator=g, device="cuda")[:MOE_SAMPLES]]
    worst = 0.0
    for t in sample.tolist():
        e, xt = int(eidx[t]), x[t:t + 1]
        ref = probs[t].max().to(x.dtype) * ((F.silu(xt @ lp["we_gate"][e]) * (xt @ lp["we_up"][e])) @ lp["we_down"][e])
        worst = max(worst, float((y[t].float() - ref[0].float()).norm() / ref.float().norm()))
    assert worst <= MOE_TOKEN_TOL, f"moe {what}: a kept token is {worst} off gate * swiglu (relative L2)"
    out = {"T": T_, "experts": E, "capacity": C, "max_tokens_an_expert": int(n_e.max()),
           "dropped": int((~keep).sum()), "experts_over_capacity": int((n_e > C).sum()), "aux": float(aux),
           "sampled_rel_err": worst, "ms": ms}
    log(f"[moe] moe_ffn {what}: {json.dumps(out)}")
    return out


def routing_flips(f_calls, c_calls, n_layers: int) -> dict:
    """Where the chunked run's own router chose other experts than the flash
    run's: the share of tokens per layer, in the prefill and over the
    decode steps; and, step by step, the layers in which the token whose
    logits the step compares (the prompt's last, then each decoded one)
    would have gone to another expert."""
    import torch

    pre = [float((a != b).float().mean()) for a, b in zip(f_calls[:n_layers], c_calls[:n_layers])]
    dec = [float(torch.cat([(f_calls[i] != c_calls[i]).float() for i in range(n_layers + l, len(f_calls), n_layers)])
                 .mean()) for l in range(n_layers)]
    by_step = [[l for l in range(n_layers) if bool(f_calls[s + l][-1] != c_calls[s + l][-1])]
               for s in range(0, len(f_calls), n_layers)]
    return {"prefill": pre, "decode": dec, "token_layers_by_step": by_step}


def phase_moe(res: dict, seed: int) -> None:
    """[moe]: llama4-scout (MoE every layer, 16 experts) and llama4-maverick
    (a dense + MoE block, 128 experts) at full width through ``prefill``
    (flash) and ``decode_step``; scout again through chunked attention with
    the flash run's experts replayed, the logits held as phi4-mini's at
    every step, and the tokens its own router would have sent elsewhere
    reported; ``moe_ffn`` on one MoE layer of each checked independently at
    T = 32768."""
    import torch
    from repro_torch.configs import lm_archs, shapes
    from repro_torch.models import transformer as T
    from repro_torch.models.base import param_count

    S = shapes.LM_SHAPES["prefill_32k"]["seq"]
    res["moe"] = {}
    runs = (("llama4-scout-17b-a16e", SCOUT_LAYERS, N_DECODE, True),
            ("llama4-maverick-400b-a17b", MAVERICK_LAYERS, MAVERICK_DECODE, False))
    for arch, depth, n_dec, against_chunked in runs:
        full = lm_archs.get(arch)
        cfg = replace(full, n_layers=depth)
        log(f"reduced: {arch} depth {full.n_layers} -> {depth} layers, batch 32 -> 1 for prefill (prefill_32k), "
            f"128 -> 1 for {n_dec} decode steps (decode_32k); width, experts ({full.moe.n_experts}), top-1, "
            f"capacity factor and moe_every ({full.moe_every}) as the config's"
            + (f"; chunked attention in blocks of {SCOUT_CHUNK} queries ({full.attn_chunk} in the config)"
               if against_chunked else ""))
        log(f"[moe] {arch}: device memory before it allocates: {mem_line()}")
        g = torch.Generator(device="cuda").manual_seed(seed + 700)
        params = T.init_params(cfg, g)
        tokens = torch.randint(0, cfg.vocab, (1, S), generator=g, device="cuda")
        torch.cuda.synchronize()
        log(f"[moe] {arch}: {param_count(T.param_specs(cfg)) / 1e9:.3f} B parameters at {depth} layers "
            f"({param_count(T.param_specs(full)) / 1e9:.3f} B at {full.n_layers}) in {cfg.dtype}; {mem_line()}")
        out = {"layers": depth}
        f_calls, c_calls = [], []
        reset_all_launches()
        with routing_recorded(f_calls):
            fl, f_steps, f_toks = lm_run(params, tokens, replace(cfg, attn_impl="flash"), n_decode=n_dec)
        launches = all_launches()
        log(f"[moe] {arch} flash: {json.dumps(fl)}; launches {launches}")
        assert fl["launches"] == depth and fl["other_flash_launches"] == 0, fl
        assert launches["distance_topk"] == launches["grouped_distance_topk"] == 0, launches
        for i, a in enumerate(f_steps):
            assert a.shape == (1, cfg.vocab) and bool(torch.isfinite(a).all()), f"{arch} step {i}: non-finite logits"
        out.update(flash=fl, launches=launches)
        w = decode_bytes(cfg, 1)
        moe_layers = [lp for lp in params["layers"] if "router" in lp]
        experts = sum(lp[k].nbytes for lp in moe_layers for k in ("we_gate", "we_up", "we_down"))
        out["decode_bytes"] = {"weights": w, "experts": experts, "bound_ms": w / HBM_BYTES_PER_S * 1e3}
        log(f"[moe] {arch}: at batch 1 each decode step's batched expert product reads every expert's weights, "
            f"{experts / 1e9:.3f} GB of {w / 1e9:.3f} GB a step (bound {out['decode_bytes']['bound_ms']:.3f} ms); "
            f"measured {fl['decode_ms']:.3f} ms a step")
        if against_chunked:
            with routing_recorded(c_calls, replay=f_calls):
                ch, c_steps, _ = lm_run(params, tokens, replace(cfg, attn_impl="chunked", attn_chunk=SCOUT_CHUNK),
                                        decode_tokens=f_toks)
            log(f"[moe] {arch} chunked, the flash run's experts replayed: {json.dumps(ch)}")
            assert ch["launches"] == ch["other_flash_launches"] == 0, ch
            assert len(c_calls) == len(f_calls), (len(c_calls), len(f_calls))
            rel, flips = logit_errs(f_steps, c_steps), argmax_flips(f_steps, c_steps)
            route = routing_flips(f_calls, c_calls, depth)
            log(f"[moe] {arch} flash vs chunked logits (same experts), relative L2 error by step: "
                f"{json.dumps([round(r, 6) for r in rel])}; argmax differs at {len(flips)} of {len(rel)} steps "
                f"(step, chunked gap): {flips}; share of tokens the chunked run's own router sent to another "
                f"expert by layer, and the layers where each step's own token was: {json.dumps(route)}")
            out.update(chunked=ch, logit_rel_err=rel, argmax_flips=flips, routing_flips=route)
        del f_calls, c_calls
        lp = next(lp for lp in params["layers"] if "router" in lp)
        x = torch.randn((S, cfg.d_model), generator=g, device="cuda").to(cfg.dtype)
        r0 = lp["router"][:, 0].to(torch.float32)
        skew = (x.float() + 2.0 * r0 / r0.norm()).to(cfg.dtype)    # expert 0's logit + 2: it overflows
        out["moe_ffn"] = {"balanced": moe_check(f"{arch} balanced", x, lp, cfg.moe, g),
                          "skewed": moe_check(f"{arch} skewed to expert 0", skew, lp, cfg.moe, g)}
        assert out["moe_ffn"]["skewed"]["dropped"] > 0
        res["moe"][arch] = out
        del params, tokens, x, skew, lp, moe_layers
        torch.cuda.empty_cache()
        if against_chunked:
            assert max(rel) < LOGIT_REL_TOL, (
                f"{arch}: flash and chunked logits differ by {max(rel)} (tolerance {LOGIT_REL_TOL})")
            for i, gap in flips:
                assert gap <= ARGMAX_GAP, f"{arch} step {i}: the argmax moved between logits {gap} apart"


# --------------------------------------------------------------- train phase
def leaf_names(tree, pre: str = "") -> list[str]:
    """Names of a tree's leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{pre}/{i}")]
    return [] if tree is None else [pre or "/"]


def rel_max(a, b) -> float:
    """max |a - b| over max |b| (float32, on the CPU)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cosine(a, b) -> float:
    """Cosine of two tensors (1 when both are zero)."""
    a, b = a.detach().double().flatten().cpu(), b.detach().double().flatten().cpu()
    if not a.any() and not b.any():
        return 1.0
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def lm_train_flops(cfg, n_params: int, tokens: int, seq: int, batch: int) -> int:
    """Model FLOPs of one training step: 6 a parameter a token over the
    parameters that multiply (all but the embedding, a lookup), plus
    attention as the chunked path computes it: q k^T and p v over the full
    seq x seq (no causal skip), 4 B Hq S^2 dh a layer forward, three times
    that with the backward pass.  Remat's recompute is not counted."""
    dense = 6 * (n_params - cfg.vocab * cfg.d_model) * tokens
    attn = 12 * cfg.n_layers * batch * cfg.n_heads * seq * seq * cfg.d_head
    return dense + attn


def train_checks(out: dict, seed: int) -> None:
    """phi4-mini at full width and 2 layers, seq 512, float32 master
    weights: remat bit for bit, bf16 against float32, one AdamW update on
    the card against the CPU."""
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.data import lm_batch
    from repro_torch.launch.cells import value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, apply_updates
    from repro_torch.tree import tree_leaves

    cfg = replace(lm_archs.get("phi4-mini-3.8b"), n_layers=TRAIN_CHECK_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(seed + 800)
    params = T.init_params(cfg, g, device="cuda", dtype=torch.float32)
    batch = {"tokens": torch.as_tensor(lm_batch(seed, 0, batch=1, seq=TRAIN_CHECK_SEQ + 1, vocab=cfg.vocab)["tokens"],
                                       device="cuda")}
    loss_of = lambda c: (lambda p, b: T.lm_loss(p, b, c))
    names = leaf_names(params)
    (l1, _), g1 = value_and_grad(loss_of(cfg), params, batch)
    (l0, _), g0 = value_and_grad(loss_of(replace(cfg, remat=False)), params, batch)
    differ = [n for n, a, b in zip(names, tree_leaves(g1), tree_leaves(g0)) if not torch.equal(a, b)]
    out["remat"] = {"loss_equal": bool(torch.equal(l0, l1)), "leaves": len(names), "leaves_differing": differ}
    log(f"[train] checks: phi4-mini width, {TRAIN_CHECK_LAYERS} layers, seq {TRAIN_CHECK_SEQ}: gradients with remat "
        f"against without: loss equal {out['remat']['loss_equal']}, {len(names) - len(differ)} of {len(names)} "
        f"leaves bit-identical; differing {differ}")
    del g0
    (l32, _), g32 = value_and_grad(loss_of(replace(cfg, dtype=torch.float32)), params, batch)
    coss = {n: cosine(a, b) for n, a, b in zip(names, tree_leaves(g1), tree_leaves(g32))}
    loss_rel = abs(float(l1) - float(l32)) / abs(float(l32))
    worst = min(coss, key=coss.get)
    out["bf16_vs_f32"] = {"loss_bf16": float(l1), "loss_f32": float(l32), "loss_rel": loss_rel,
                          "min_cos": coss[worst], "min_cos_leaf": worst, "cos": coss}
    log(f"[train] checks: bf16 against float32 compute on the same float32 master weights: loss {float(l1):.6f} / "
        f"{float(l32):.6f} (rel {loss_rel:.3e}); gradient cosine by leaf {json.dumps({k: round(v, 6) for k, v in coss.items()})}")
    del g32
    three = {"embed": params["embed"], "wq": params["layers"][0]["wq"], "attn_norm": params["layers"][0]["attn_norm"]}
    grads3 = {"embed": g1["embed"], "wq": g1["layers"][0]["wq"], "attn_norm": g1["layers"][0]["attn_norm"]}
    del g1
    opt = adamw(TRAIN_LR)

    def one_update(dev):
        p = {k: v.detach().to(dev, copy=True) for k, v in three.items()}
        gr = {k: v.to(dev, copy=True) for k, v in grads3.items()}
        u, _ = opt.update(gr, opt.init(p), p)
        apply_updates(p, u)
        return {k: v.cpu() for k, v in p.items()}, {k: v.cpu() for k, v in u.items()}

    pc, uc = one_update("cuda")
    pp, up = one_update("cpu")
    errs = {k: {"update": rel_max(uc[k], up[k]), "param": rel_max(pc[k], pp[k])} for k in three}
    out["adamw_card_vs_cpu"] = errs
    log(f"[train] checks: one AdamW update (lr {TRAIN_LR}, clip 1.0, wd 0.1) of embed {tuple(three['embed'].shape)}, "
        f"layer 0 wq and attn_norm, card against CPU, max |a - b| / max |b|: {json.dumps(errs)}")
    del params, three, grads3
    torch.cuda.empty_cache()
    assert out["remat"]["loss_equal"] and not differ, f"remat changes the gradients of {differ}"
    assert loss_rel <= BF16_LOSS_RTOL, f"bf16 loss {float(l1)} vs float32 {float(l32)}"
    assert coss[worst] >= BF16_GRAD_COS, f"{worst}: gradient cosine {coss[worst]}"
    for k, e in errs.items():
        assert e["update"] <= ADAMW_RTOL and e["param"] <= ADAMW_RTOL, (k, e)


def train_lm(out: dict, seed: int) -> None:
    """(a) make_lm_trainer at phi4-mini's full width and TRAIN_LAYERS
    layers, train_4k's sequence at batch 1."""
    import torch
    from functools import partial

    from repro_torch.configs import lm_archs, shapes
    from repro_torch.data import StepLoader, lm_batch
    from repro_torch.launch.train import make_lm_trainer
    from repro_torch.models import transformer as T
    from repro_torch.models.base import param_count

    full = lm_archs.get("phi4-mini-3.8b")
    cfg = replace(full, n_layers=TRAIN_LAYERS)
    S, B_full = shapes.LM_SHAPES["train_4k"]["seq"], shapes.LM_SHAPES["train_4k"]["batch"]
    B = 1
    layer = param_count(T._layer_specs(full, moe=False))
    outer = 2 * full.vocab * full.d_model + full.d_model
    n = param_count(T.param_specs(cfg))
    reck = {L: 16 * (L * layer + outer) for L in (32, 24, 16)}
    logits = 4 * B * (S - 1) * cfg.vocab
    out["reckoning"] = {"layer_params": layer, "outer_params": outer, "state_bytes_by_layers": reck,
                        "logits_f32_bytes": logits, "params": n, "state_bytes": 16 * n}
    log(f"reduced: phi4-mini-3.8b training depth {full.n_layers} -> {TRAIN_LAYERS} layers, batch {B_full} -> {B} "
        f"(train_4k, seq {S}); width, vocabulary and dtypes as the config's (bf16 compute, float32 master weights "
        f"and moments); no checkpoint at this width (weights and moments ~{16 * n * 3 / 4 / 1e9:.1f} GB a save)")
    log(f"[train] (a) reckoning: {layer / 1e6:.3f} M parameters a layer, {outer / 1e9:.4f} B outside the layers; "
        f"16 bytes a parameter: {json.dumps({k: round(v / 1e9, 2) for k, v in reck.items()})} GB at 32/24/16 "
        f"layers; float32 logits [{B}, {S - 1}, {cfg.vocab}] {logits / 1e9:.3f} GB; {mem_line()}")
    total = TRAIN_STEPS + TRAIN_REPEAT
    step, init = make_lm_trainer(cfg, lr=TRAIN_LR, total_steps=total, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init(torch.Generator(device="cuda").manual_seed(seed + 900))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    loader = StepLoader(make=partial(lm_batch, batch=B, seq=S, vocab=cfg.vocab), seed=seed)
    tokens = B * (S - 1)
    flops = lm_train_flops(cfg, n, tokens, S - 1, B)
    rows = []
    for i in range(TRAIN_STEPS):
        batch = loader.global_batch(i)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks = iter(ev[1:])
        t0 = time.perf_counter()
        ev[0].record()
        state, m = step(state, batch, mark=lambda _: next(marks).record())
        ev[2].synchronize()
        host_s = time.perf_counter() - t0
        fb, opt_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        step_s = (fb + opt_ms) / 1e3
        rows.append({"step": i, "loss": float(m["loss"]), "fwd_bwd_ms": fb, "opt_ms": opt_ms, "host_s": host_s,
                     "tokens_per_s": tokens / step_s, "flop_share": flops / step_s / PEAK_OPS["bfloat16"],
                     "peak_bytes": torch.cuda.max_memory_allocated(), "state_bytes": 16 * n})
        log(f"[train] (a) step {i}: {json.dumps(rows[-1])}")
    peak = torch.cuda.max_memory_allocated()
    b0 = loader.global_batch(0)
    repeat, box = [], {}
    for i in range(TRAIN_REPEAT - 1):
        state, m = step(state, b0)
        repeat.append(float(m["loss"]))
    # the last repeated step under the profiler: where a step's time goes on the card
    kernels = traced_kernels(lambda: box.update(out=step(state, b0)), 1)
    state, m = box.pop("out")
    repeat.append(float(m["loss"]))
    peak = max(peak, torch.cuda.max_memory_allocated())
    by_name: dict = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out["traced"] = {"kernels": len(kernels), "device_ms": sum(t for t, _ in by_name.values()) if kernels else None,
                     "top_kernels_ms_count": [[k[:90], t, c] for k, (t, c) in top]}
    log(f"[train] (a) one step under torch.profiler: {json.dumps(out['traced'])}")
    steady = rows[1:]
    mean = lambda k: sum(r[k] for r in steady) / len(steady)
    out.update(layers=TRAIN_LAYERS, seq=S, batch=B, tokens=tokens, model_flops=flops, steps=rows,
               repeat_losses=repeat, peak_bytes=peak,
               mean={k: mean(k) for k in ("fwd_bwd_ms", "opt_ms", "tokens_per_s", "flop_share")})
    log(f"[train] (a) phi4-mini {TRAIN_LAYERS} layers ({n / 1e9:.4f} B parameters), steps 1-{TRAIN_STEPS - 1}: "
        f"forward+backward {out['mean']['fwd_bwd_ms']:.3f} ms, optimizer {out['mean']['opt_ms']:.3f} ms, "
        f"{out['mean']['tokens_per_s']:.1f} tokens/s, model FLOPs {flops / 1e12:.3f} T a step = "
        f"{out['mean']['flop_share']:.4f} of the dense bf16 peak ({PEAK_OPS['bfloat16'] / 1e12:.0f} TFLOP/s, "
        f"NVIDIA's H100 SXM data sheet); peak memory {peak / 1e9:.3f} GB against the state's "
        f"{16 * n / 1e9:.3f} GB; {mem_line()}")
    log(f"[train] (a) one batch {TRAIN_REPEAT} times: losses {json.dumps(repeat)}")
    del state
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in rows] + repeat
    assert all(np.isfinite(losses)), losses
    assert all(b < a for a, b in zip(repeat, repeat[1:])), f"the repeated batch's loss did not fall at every step: {repeat}"


def train_supervisor(out: dict, seed: int) -> None:
    """(b) TrainSupervisor at the reduced phi4 config on the card."""
    import torch
    from functools import partial

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import lm_archs
    from repro_torch.data import StepLoader, lm_batch
    from repro_torch.distributed import FailureInjector, TrainSupervisor
    from repro_torch.distributed.fault_tolerance import onto_devices_of
    from repro_torch.launch.train import make_lm_trainer
    from repro_torch.tree import tree_leaves

    cfg = lm_archs.get("phi4-mini-3.8b", reduced=True)
    step, init = make_lm_trainer(cfg, lr=1e-3, total_steps=SUP_STEPS, device="cuda")
    loader = StepLoader(make=partial(lm_batch, batch=8, seq=cfg.max_seq, vocab=cfg.vocab), seed=seed)
    work = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    runs = {}
    try:
        for tag, faults in (("clean", None), ("faulty", dict(SUP_FAILS))):
            ck = CheckpointManager(work / tag, keep_n=2, async_save=True)
            sup = TrainSupervisor(step_fn=lambda s, b, i: step(s, b), loader=loader, ckpt=ck, ckpt_every=SUP_EVERY)
            state = init(torch.Generator(device="cuda").manual_seed(seed + 1000))
            t0 = time.perf_counter()
            final, stats = sup.run(state, SUP_STEPS, injector=FailureInjector(fail_at=faults) if faults else None)
            torch.cuda.synchronize()
            runs[tag] = (final, stats, ck)
            out[tag] = {**stats, "s": time.perf_counter() - t0, "saves": ck.saves, "kept": ck.steps()}
        clean, faulty = runs["clean"][0], runs["faulty"][0]
        names = leaf_names(clean)
        differ = [n for n, a, b in zip(names, tree_leaves(clean), tree_leaves(faulty)) if not torch.equal(a, b)]
        devices = sorted({str(x.device) for x in tree_leaves(faulty)})
        back, ck_step = runs["faulty"][2].restore()
        placed = onto_devices_of(back, faulty)
        round_trip = [n for n, a, b in zip(names, tree_leaves(placed), tree_leaves(faulty)) if not torch.equal(a, b)]
        leaf = work / "faulty" / f"step_{SUP_STEPS:08d}" / "leaf_000000"
        meta = json.loads((leaf / ".zarray").read_text())
        chunk = leaf / ".".join(["0"] * len(meta["shape"]))
        raw = np.fromfile(chunk, dtype=np.dtype(meta["dtype"])).reshape(meta["chunks"])[: meta["shape"][0]]
        path = json.loads((leaf / ".zattrs").read_text())["path"]
        raw_equal = bool(np.array_equal(raw, tree_leaves(faulty)[0].cpu().numpy()))
        out.update(leaves=len(names), leaves_differing=differ, devices=devices, restored_step=ck_step,
                   round_trip_differing=round_trip, raw_leaf={"path": path, "zarray": meta, "equal": raw_equal})
        log(f"[train] (b) supervisor, reduced phi4 ({cfg.n_layers} layers, d_model {cfg.d_model}), {SUP_STEPS} steps, "
            f"a checkpoint every {SUP_EVERY} (async), failures at {sorted(SUP_FAILS)}: clean {json.dumps(out['clean'])}; "
            f"faulty {json.dumps(out['faulty'])}; final state on {devices}, {len(names) - len(differ)} of "
            f"{len(names)} leaves bit-identical to the clean run's (differing {differ}); the step-{ck_step} "
            f"checkpoint against the final state: {len(names) - len(round_trip)} leaves equal; "
            f"{chunk.relative_to(work)} by numpy.fromfile and .zarray ({meta['dtype']}, shape {meta['shape']}) is "
            f"{path}: equal {raw_equal}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert out["faulty"]["restarts"] == 2 and out["clean"]["restarts"] == 0, out
    assert devices == ["cuda:0"], devices
    assert not differ, f"the restarted run's leaves differ from the clean run's: {differ}"
    assert ck_step == SUP_STEPS and not round_trip, (ck_step, round_trip)
    assert raw_equal and path == "0/embed", path


def gnn_case(name: str, cfg, loss_fn, make_batch, g, out: dict, *, against_cpu: bool = True) -> None:
    """One GraphSAGE shape: step 0's loss and gradients on the card against
    the CPU's (GNN_RTOL), then GNN_STEPS AdamW steps."""
    import torch
    from repro_torch.launch.cells import make_train_step, to_device, value_and_grad
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    torch.cuda.reset_peak_memory_stats()
    params = G.init_params(cfg, g, device="cuda")
    fn = lambda p, b: loss_fn(p, b, cfg)
    part = {}
    if against_cpu:
        b0 = make_batch(0)
        (lc, _), gc_ = value_and_grad(fn, params, to_device(b0, "cuda"))
        (lp, _), gp = value_and_grad(fn, tree_map(lambda x: x.cpu(), params), to_device(b0, "cpu"))
        part["loss_rel"] = abs(float(lc) - float(lp)) / abs(float(lp))
        part["grad_rel"] = max(rel_max(a, b) for a, b in zip(tree_leaves(gc_), tree_leaves(gp)))
        del gc_, gp, b0
    opt = adamw(GNN_LR)
    step = make_train_step(fn, opt)
    st = opt.init(params)
    losses, step_s, host_s = [], [], []
    for i in range(GNN_STEPS):
        t0 = time.perf_counter()
        b = make_batch(i)
        t1 = time.perf_counter()
        params, st, m = step(params, st, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        host_s.append(t1 - t0)
        step_s.append(time.perf_counter() - t1)
    part.update(losses=losses, step_s=step_s, batch_host_s=host_s, peak_bytes=torch.cuda.max_memory_allocated())
    out[name] = part
    log(f"[train] (c) {name} (d_in {cfg.d_in}, {cfg.n_classes} classes): {json.dumps(part)}")
    assert all(np.isfinite(losses)), losses
    if against_cpu:
        assert part["loss_rel"] <= GNN_RTOL and part["grad_rel"] <= GNN_RTOL, part


def train_gnn(out: dict, seed: int) -> None:
    """(c) graphsage-reddit at each of its shapes."""
    import torch
    from repro_torch.configs import gnn_archs, shapes
    from repro_torch.data import CSRGraph, batched_molecules, random_graph, sample_hops
    from repro_torch.models import gnn as G

    full = gnn_archs.get("graphsage-reddit")
    gs = shapes.GNN_SHAPES
    g = torch.Generator(device="cuda").manual_seed(seed + 1100)
    # minibatch_lg: the full Reddit-sized graph on the host, sampled batches to the card
    sh = gs["minibatch_lg"]
    t0 = time.perf_counter()
    graph = random_graph(seed, n_nodes=sh["n_nodes"], n_edges=sh["n_edges"], d_feat=sh["d_feat"],
                         n_classes=sh["n_classes"])
    t1 = time.perf_counter()
    csr = CSRGraph(sh["n_nodes"], graph["edge_src"], graph["edge_dst"])
    t2 = time.perf_counter()
    out["minibatch_lg_host"] = {"random_graph_s": t1 - t0, "csr_s": t2 - t1}
    log(f"[train] (c) minibatch_lg: random_graph of {sh['n_nodes']} nodes, {sh['n_edges']} edges in {t1 - t0:.1f} s, "
        f"CSRGraph in {t2 - t1:.1f} s (host)")
    feats, labels = graph["feats"], graph["labels"]
    del graph

    def sampled(i):
        rng = np.random.default_rng([seed, i])
        seeds = rng.choice(sh["n_nodes"], sh["batch_nodes"], replace=False)
        return {"hops": sample_hops(csr, feats, seeds, sh["fanouts"], rng), "labels": labels[seeds]}

    cfg = replace(full, d_in=sh["d_feat"], n_classes=sh["n_classes"], fanouts=sh["fanouts"])
    gnn_case("minibatch_lg", cfg, G.gnn_loss_sampled, sampled, g, out)
    del csr, feats, labels
    # full_graph_sm: Cora's shape, full batch
    sh = gs["full_graph_sm"]
    cora = random_graph(seed, n_nodes=sh["n_nodes"], n_edges=sh["n_edges"], d_feat=sh["d_feat"],
                        n_classes=sh["n_classes"])
    gnn_case("full_graph_sm", replace(full, d_in=sh["d_feat"], n_classes=sh["n_classes"]), G.gnn_loss_full,
             lambda i: cora, g, out)
    # molecule: 128 graphs of 30 nodes a batch
    sh = gs["molecule"]
    mol = lambda i: batched_molecules(seed, i, batch=sh["batch"], n_nodes=sh["n_nodes"], n_edges=sh["n_edges"],
                                      d_feat=sh["d_feat"], n_classes=sh["n_classes"])
    gnn_case("molecule", replace(full, d_in=sh["d_feat"], n_classes=sh["n_classes"]), G.gnn_loss_graphs, mol, g, out)
    # ogb_products full batch: gather_scatter holds one chunk of messages at a time (the whole
    # [E, 128] float32 is 31.7 GB, and its gradient as much again: held whole, the backward pass
    # runs out of the H100's memory, asking 29.5 GiB more with 35.4 allocated and 20.4 cached)
    sh = gs["ogb_products"]
    E, N, H = sh["n_edges"], sh["n_nodes"], full.d_hidden
    chunk = 4 * G.EDGE_CHUNK * H
    reckoned = 2 * chunk + 4 * N * (sh["d_feat"] + 6 * H) + 8 * E
    total = torch.cuda.mem_get_info()[1]
    out["ogb_products_reckoned_bytes"] = reckoned
    log(f"[train] (c) ogb_products reckoned peak: a chunk of {G.EDGE_CHUNK} messages [.., {H}] float32 "
        f"{chunk / 1e9:.2f} GB and its gradient (whole: {4 * E * H / 1e9:.2f} GB), features and activations "
        f"{4 * N * (sh['d_feat'] + 6 * H) / 1e9:.2f} GB, edges {8 * E / 1e9:.2f} GB: {reckoned / 1e9:.2f} GB of "
        f"{total / 1e9:.2f} GB")
    if reckoned <= 0.6 * total:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prod = random_graph(seed, n_nodes=N, n_edges=E, d_feat=sh["d_feat"], n_classes=sh["n_classes"])
        out["ogb_products_host_s"] = time.perf_counter() - t0
        dev = {k: torch.as_tensor(v, device="cuda") for k, v in prod.items()}
        del prod
        gnn_case("ogb_products", replace(full, d_in=sh["d_feat"], n_classes=sh["n_classes"]), G.gnn_loss_full,
                 lambda i: dev, g, out, against_cpu=False)
        del dev
    torch.cuda.empty_cache()


def train_recsys(out: dict, seed: int) -> None:
    """(d) the four recsys architectures at train_batch, full vocabularies."""
    import torch
    from repro_torch.configs import recsys_archs, shapes
    from repro_torch.data.synthetic import ctr_batch
    from repro_torch.launch.cells import make_train_step, to_device, value_and_grad
    from repro_torch.models import recsys as R
    from repro_torch.models.base import param_count
    from repro_torch.optim import adamw

    rows = shapes.RECSYS_SHAPES["train_batch"]["batch"]
    for name in recsys_archs.ARCHS:
        cfg = recsys_archs.get(name)
        kw = dict(field_vocabs=cfg.field_vocabs, n_dense=cfg.n_dense, seq_len=cfg.seq_len, seq_fields=cfg.seq_fields)
        g = torch.Generator(device="cuda").manual_seed(seed + 1200)
        params = R.init_params(cfg, g, device="cuda")
        opt = adamw(RECSYS_LR)
        step = make_train_step(lambda p, b: R.recsys_loss(p, b, cfg), opt)
        part = {"params": param_count(R.param_specs(cfg))}
        # step 0 at a slice of the batch, the card against the CPU.  float32: the loss, and each
        # leaf's gradient by cosine (a ReLU whose input the two devices round to either side of
        # 0 drops one row's term: up to ~1% of a leaf's largest entry, seen on the H100).
        # float64 copies of the parameters (pre-activations 1e-16 apart, so no such flip; the
        # loss's own gradient stays float32, bce_logits): the gradients within RTOL of each
        # leaf's largest, and the step's update of every entry within its bound from them
        sl = {k: v[:RECSYS_SLICE] for k, v in ctr_batch(seed, 0, batch=rows, **kw).items()}
        fn = lambda p, b: R.recsys_loss(p, b, cfg)
        cpu = {k: v.cpu() for k, v in params.items()}
        (lc, _), gc_ = value_and_grad(fn, params, to_device(sl, "cuda"))
        (lp, _), gp = value_and_grad(fn, cpu, to_device(sl, "cpu"))
        part["slice_loss_rel"] = abs(float(lc) - float(lp)) / abs(float(lp))
        part["slice_grad_cos_min"] = min(cosine(gc_[k], gp[k]) for k in params)
        part["slice_grad_rel_f32"] = max(rel_max(gc_[k], gp[k]) for k in params)
        del gc_, gp
        p64 = {k: v.double() for k, v in params.items()}
        c64 = {k: v.double() for k, v in cpu.items()}
        del cpu
        (_, _), gc_ = value_and_grad(fn, p64, to_device(sl, "cuda"))
        (_, _), gp = value_and_grad(fn, c64, to_device(sl, "cpu"))
        part["slice_grad_rel_f64"] = max(rel_max(gc_[k], gp[k]) for k in params)
        dg = {k: float((gc_[k].cpu() - gp[k]).abs().max()) for k in params}
        del gc_, gp
        u = {}
        for tag, p in (("card", p64), ("cpu", c64)):
            before = {k: v.clone() for k, v in p.items()}
            p, _, _ = step(p, opt.init(p), sl)
            u[tag] = {k: (p[k] - before[k]).cpu() for k in p}
            del before, p
        du = {k: float((u["card"][k] - u["cpu"][k]).abs().max()) for k in params}
        # AdamW's first update is lr * g / (|g| + eps) (+ the decay, the same on both): it moves
        # by at most lr / eps times the gradients' difference, plus rounding
        over = {k: du[k] / (RECSYS_LR * (dg[k] / ADAMW_EPS + 1e-6)) for k in params}
        part["slice_update_max_abs_f64"] = max(du.values())
        part["slice_update_over_bound"] = max(over.values())
        del p64, c64, u
        st = opt.init(params)
        losses, step_s = [], []
        for i in range(RECSYS_STEPS):
            b = ctr_batch(seed, i, batch=rows, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, st, m = step(params, st, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        part.update(losses=losses, step_s=step_s)
        out[name] = part
        log(f"[train] (d) {name} (d={cfg.embed_dim}), batch {rows}: {json.dumps(part)}")
        del params, st
        torch.cuda.empty_cache()
        assert all(np.isfinite(losses)), losses
        assert part["slice_loss_rel"] <= 1e-6 and part["slice_grad_cos_min"] >= RECSYS_GRAD_COS, part
        assert part["slice_grad_rel_f64"] <= RTOL and part["slice_update_over_bound"] <= 1.0, part


def phase_train(res: dict, seed: int) -> None:
    """[train]: the checks at 2 layers, then (a)-(d), each with the kernel
    launch counters zeroed before it and read after (no kernel lies on a
    training path: each must read 0)."""
    import torch

    out = res["train"] = {"launches": {}}
    parts = (("checks", train_checks), ("lm", train_lm), ("supervisor", train_supervisor),
             ("gnn", train_gnn), ("recsys", train_recsys))
    for name, part in parts:
        out[name] = {}
        reset_all_launches()
        t0 = time.perf_counter()
        part(out[name], seed)
        torch.cuda.synchronize()
        out[name]["part_s"] = time.perf_counter() - t0
        out["launches"][name] = all_launches()
        log(f"[train] {name} done in {out[name]['part_s']:.1f} s; kernel launches {out['launches'][name]}; "
            f"{mem_line()}")
        torch.cuda.empty_cache()
        assert not any(out["launches"][name].values()), (name, out["launches"][name])


def _trace_key(arch: str, shape: str, batch) -> str:
    return f"{arch}/{shape}/{batch}"


def write_cell_traces(path: str) -> None:
    """The dry run (``repro_torch.launch.dryrun``) of every cell [cells]
    runs at full size or holds against an earlier phase's run, written as
    JSON to ``path``.  Runs in a child process of its own from the start of
    the smoke (``start_cell_traces``): fake tensors on the meta device, no
    card, one CPU thread."""
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs import ALL_CELLS, get_arch
    from repro_torch.launch import cells, dryrun
    from repro_torch.models import transformer as T

    recs = {}
    for arch, shape in ALL_CELLS:
        if get_arch(arch)[0] != "lm":
            recs[_trace_key(arch, shape, None)] = dryrun.run_cell(arch, shape, verbose=False)
    for arch, shape, batch in CELL_LM_RUNS + CELL_LM_EARLIER:
        recs[_trace_key(arch, shape, batch)] = dryrun.run_cell(arch, shape, batch=batch, verbose=False)
    cell = cells.build_cell("qwen2-7b", "prefill_32k", mesh_axes=None, batch=1)
    fcfg = replace(cell.meta["cfg"], attn_impl="flash")
    flash = replace(cell, fn=lambda p, t: T.prefill(p, t, fcfg, max_seq=fcfg.max_seq))
    recs[_trace_key("qwen2-7b", "prefill_32k/flash", 1)] = dryrun.trace_cell(flash)
    Path(path).write_text(json.dumps(recs))


def start_cell_traces(out: Path) -> subprocess.Popen:
    """``write_cell_traces`` in a child process, started at once; its
    output goes to ``out`` with the suffix ``.log``."""
    code = "import sys, chip_smoke; chip_smoke.write_cell_traces(sys.argv[1])"
    with open(out.with_suffix(".log"), "w") as f:
        return subprocess.Popen([sys.executable, "-c", code, str(out)], cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT)


def read_cell_traces(proc: subprocess.Popen, out: Path) -> dict:
    proc.wait()
    assert proc.returncode == 0, f"the dry run of the cells failed:\n{out.with_suffix('.log').read_text()}"
    return json.loads(out.read_text())


def to_cuda(args):
    from repro_torch.launch import cells

    return cells.map_args(lambda _n, t: t.to("cuda"), args)


def held_train(what: str, family: str, card, cpu) -> dict:
    """A train cell's step on the card held against the CPU's (rules at
    CELL_ATOL's definition)."""
    import torch
    from repro_torch.tree import tree_leaves

    (cp, cs, cm), (hp, hs, hm) = card, cpu
    assert int(cs["step"]) == int(hs["step"]) == 1, what
    loss, ref = float(cm["loss"]), float(hm["loss"])
    assert loss > 0 and abs(loss - ref) <= CELL_LOSS_RTOL * abs(ref), (what, loss, ref)
    mu_err = p_err = 0.0
    lr = CELL_LR1[family]
    for m, mr, p, pr in zip(tree_leaves(cs["mu"]), tree_leaves(hs["mu"]), tree_leaves(cp), tree_leaves(hp)):
        m, p = m.cpu(), p.cpu()
        d = (m - mr).abs()
        assert bool((d <= CELL_MU_ATOL + CELL_MU_RTOL * mr.abs()).all()), (what, "mu", float(d.max()))
        mu_err = max(mu_err, float(d.max()))
        d = (p - pr).abs()
        tol = CELL_P_ATOL + CELL_P_RTOL * pr.abs() + torch.where(mr.abs() / 0.1 < CELL_TINY_GRAD, 2 * lr, 0.0)
        assert bool((d <= tol).all()), (what, "parameters", float(d.max()))
        p_err = max(p_err, float(d.max()))
    return {"loss": loss, "loss_cpu": ref, "mu_err": mu_err, "param_err": p_err}


def held_close(what: str, a, b) -> float:
    err = float((a.cpu().to(b.dtype) - b).abs().max()) if a.numel() else 0.0
    assert err <= CELL_ATOL, (what, err)
    return err


def cells_reduced(out: dict, seed: int) -> None:
    """(a) Every one of the 40 cells, reduced, one step on the card and one
    on the CPU from the same ``example_inputs`` (parameters drawn once on
    the CPU and copied)."""
    import torch
    from dataclasses import fields as dc_fields

    from repro_torch.configs import ALL_CELLS
    from repro_torch.launch import cells
    from repro_torch.tree import tree_leaves

    rows = {}
    for arch, shape in ALL_CELLS:
        cell = cells.build_cell(arch, shape, mesh_axes=None, reduced=True)
        cpu_args = cells.example_inputs(cell, seed, device="cpu")
        card_args = to_cuda(cpu_args)
        before = [p.clone() for p in tree_leaves(cpu_args[0])]
        with torch.no_grad():
            card = cell.fn(*card_args)
            torch.cuda.synchronize()
            cpu = cell.fn(*cpu_args)
        what = f"[cells] (a) {arch} {shape}"
        for t in tree_leaves(card[:2] if cell.kind == "train" else card):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                assert bool(torch.isfinite(t).all()), what
        if cell.kind == "train":
            row = held_train(what, cell.meta["family"], card, cpu)
            assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(cpu[0]), before)), f"{what}: nothing moved"
        elif cell.kind == "serve":
            row = {"err": held_close(what, card, cpu)}
        elif cell.kind == "retrieval":
            assert torch.equal(card[1].cpu(), cpu[1]), what
            row = {"err": held_close(what, card[0], cpu[0])}
        else:
            (lc, cc), (lh, ch) = card, cpu
            assert cc.pos == ch.pos, what
            row = {"err": max([held_close(what, lc, lh)] + [held_close(f"{what} {f.name}", getattr(cc, f.name),
                                                                       getattr(ch, f.name))
                                                          for f in dc_fields(cc) if f.name != "pos"])}
        rows[f"{arch}/{shape}"] = row
    out["cells"] = rows
    log(f"[cells] (a) 40 reduced cells, card against CPU: {json.dumps(rows)}")


def run_full(cell, args) -> tuple:
    """One step of ``cell`` on the card from ``args`` (live on the card):
    (outputs, seconds, peak bytes counted from the args)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        o = cell.fn(*args)
    torch.cuda.synchronize()
    return o, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def traced_row(rec: dict, peak: int, peak_key: str = "peak_bytes") -> dict:
    return {"peak_traced": rec[peak_key], "peak_measured": peak, "measured_over_traced": peak / rec[peak_key]}


def cells_full(out: dict, seed: int, traces: dict) -> None:
    """(b) The 20 GraphSAGE and recsys cells at their shapes, uncut: one
    step each, beside the dry run's peak."""
    import torch

    from repro_torch.configs import ALL_CELLS, get_arch
    from repro_torch.launch import cells
    from repro_torch.tree import tree_leaves

    rows = {}
    for arch, shape in ALL_CELLS:
        if get_arch(arch)[0] == "lm":
            continue
        rec = traces[_trace_key(arch, shape, None)]
        assert rec["fits_h100"], (arch, shape, rec["peak_bytes"])
        cell = cells.build_cell(arch, shape, mesh_axes=None)
        t0 = time.perf_counter()
        args = cells.example_inputs(cell, seed, device="cuda")
        small = [(p, p.clone()) for p in tree_leaves(args[0]) if p.numel() < 1 << 24 and cell.kind == "train"]
        inputs_s = time.perf_counter() - t0
        o, dt, peak = run_full(cell, args)
        what = f"[cells] (b) {arch} {shape}"
        for t in tree_leaves(o[:2] if cell.kind == "train" else o):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                assert bool(torch.isfinite(t).all()), what
        if cell.kind == "train":
            assert int(o[1]["step"]) == 1 and float(o[2]["loss"]) > 0, what
            assert any(not torch.equal(p, c) for p, c in small), f"{what}: nothing moved"
        rows[f"{arch}/{shape}"] = {"kind": cell.kind, "inputs_s": inputs_s, "step_s": dt, **traced_row(rec, peak)}
        log(f"{what}: {json.dumps(rows[f'{arch}/{shape}'])}")
        del args, o, small
        torch.cuda.empty_cache()
    out["cells"] = rows


def cells_lm(out: dict, seed: int, traces: dict) -> None:
    """(c) qwen2-7b at full width and depth: prefill_32k at batch 1
    (chunked, then flash: one wgmma launch a layer, logits held to the
    chunked run's), decode_32k at the dry run's fit_batch, long_500k; then
    phi4-mini's decode_32k at its fit_batch.  (d) phi4-mini's prefill,
    train and long_500k ran in earlier phases: their traces beside those
    phases' peaks."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import cells
    from repro_torch.launch.dryrun import H100_FIT_BYTES
    from repro_torch.models import transformer as T

    rows = {}
    for arch, shape, batch in CELL_LM_RUNS:
        rec = traces[_trace_key(arch, shape, batch)]
        b, key = (batch, "peak_bytes") if batch is not None else (rec["fit_batch"], "fit_peak_bytes")
        assert b is not None and rec[key] <= H100_FIT_BYTES, (arch, shape, rec)
        cell = cells.build_cell(arch, shape, mesh_axes=None, batch=b)
        t0 = time.perf_counter()
        args = cells.example_inputs(cell, seed, device="cuda")
        torch.cuda.synchronize()
        inputs_s = time.perf_counter() - t0
        o, dt, peak = run_full(cell, args)
        logits = o[0]
        what = f"[cells] (c) {arch} {shape} batch {b}"
        assert logits.shape == (b, cell.meta["cfg"].vocab) and bool(torch.isfinite(logits).all()), what
        row = {"batch": b, "inputs_s": inputs_s, "step_s": dt, **traced_row(rec, peak, key)}
        if cell.kind != "prefill":   # a second step: the first one's time holds the allocator's warm-up
            t0 = time.perf_counter()
            with torch.no_grad():
                o = cell.fn(args[0], o[1], args[2])
            torch.cuda.synchronize()
            row["step2_s"] = time.perf_counter() - t0
        else:
            chunked = logits.float().cpu()
            del o
            torch.cuda.empty_cache()
            fcfg = replace(cell.meta["cfg"], attn_impl="flash")
            frec = traces[_trace_key(arch, "prefill_32k/flash", batch)]
            fops.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.no_grad():
                o = T.prefill(args[0], args[1], fcfg, max_seq=fcfg.max_seq)
            torch.cuda.synchronize()
            fdt, fpeak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
            flash = o[0].float().cpu()
            rel = logit_errs([flash], [chunked])[0]
            flips = argmax_flips([flash], [chunked])
            row["flash"] = {"step_s": fdt, "launches": dict(fops.launches), "logit_rel_err": rel,
                            "argmax_flips": flips, **traced_row(frec, fpeak)}
            assert fops.launches["flash_attention_wgmma"] == cell.meta["cfg"].n_layers, fops.launches
            assert fops.launches["flash_attention"] == 0, fops.launches
            assert rel < LOGIT_REL_TOL, f"{what}: flash and chunked logits differ by {rel}"
            for i, gap in flips:
                assert gap <= ARGMAX_GAP, f"{what}: the argmax moved between logits {gap} apart"
        rows[f"{arch}/{shape}"] = row
        log(f"{what}: {json.dumps(row)}; {mem_line()}")
        del args, o, logits
        torch.cuda.empty_cache()
    out["cells"] = rows


def cells_earlier(res: dict, out: dict, traces: dict) -> None:
    """(d) phi4-mini's cells that [lm], [train] and [long500k] ran: the
    dry run's trace of the cell at batch 1 beside the peak each phase
    measured, and what the phase ran that the cell does not."""
    measured = {
        "prefill_32k": (res["lm"]["chunked"]["peak_gb"] * 1e9, "[lm]: bf16 weights (the cell's are float32), "
                        f"a cache of 32768 + {N_DECODE} positions, {N_DECODE} decode steps in the same window"),
        "train_4k": (res["train"]["lm"]["peak_bytes"], "[train] (a): the same state, steps 0-13"),
        "long_500k": (res["long500k"]["peak_gib"] * 2**30, "[long500k]: bf16 weights (the cell's are float32)"),
    }
    rows = {}
    for arch, shape, batch in CELL_LM_EARLIER:
        rec = traces[_trace_key(arch, shape, batch)]
        peak, note = measured[shape]
        rows[f"{arch}/{shape}"] = {**traced_row(rec, int(peak)), "fits_h100": rec["fits_h100"], "phase": note}
    out["cells"] = rows
    log(f"[cells] (d) traced at batch 1 against the earlier phases' peaks: {json.dumps(rows)}")


def wrapper_overhead(out: dict) -> None:
    """The custom ops' cost a call: each kernel's wrapper against its
    launching body called straight (``_init_fn``: no dispatcher), CUDA
    events over back-to-back calls at the leaf scorer's shape (B=1,
    N_pad=512, D=1152) and at a small flash call, in turns."""
    import torch

    from repro_torch.kernels.distance_topk import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops

    g = torch.Generator(device="cuda").manual_seed(7)
    q, c = torch.randn(1, D, device="cuda", generator=g), torch.randn(512, D, device="cuda", generator=g)
    qa = torch.randn(1, 24, 128, 128, device="cuda", generator=g).to(torch.bfloat16)
    ka = torch.randn(1, 8, 128, 128, device="cuda", generator=g).to(torch.bfloat16)
    m = dops.METRIC_CODE["cosine"]
    pairs = {
        "distance_topk": (lambda: dops.distance_topk(q, c, 512, "cosine"),
                          lambda: dops._distance_topk_op._init_fn(q, c, 512, m)),
        "flash_attention_wgmma": (lambda: fops.flash_attention(qa, ka, ka),
                                  lambda: fops._flash_op._init_fn(qa, ka, ka, None, "wgmma", True, 128 ** -0.5)),
    }
    for name, (wrapped, body) in pairs.items():
        t = [cuda_ms(f, 200, 20) for f in (wrapped, body, body, wrapped)]
        out[name] = {"wrapper_ms": (t[0] + t[3]) / 2, "body_ms": (t[1] + t[2]) / 2, "turns_ms": t,
                     "overhead_us": ((t[0] + t[3]) - (t[1] + t[2])) / 2 * 1e3}
    log(f"[cells] the custom ops' cost a call (wrapper against its body, back to back): {json.dumps(out)}")


def phase_cells(res: dict, seed: int, traces: dict) -> None:
    """[cells]: (a) the 40 reduced cells on the card against the CPU, (b)
    the 20 GraphSAGE and recsys cells at full size, (c) qwen2-7b and
    phi4-mini's decode at full width, (d) the traces of phi4-mini's cells
    the earlier phases ran; each part's launches counted from 0."""
    import torch

    out = res["cells"] = {"launches": {}, "overhead": {}}
    wrapper_overhead(out["overhead"])
    parts = (("reduced", lambda o: cells_reduced(o, seed)), ("full", lambda o: cells_full(o, seed, traces)),
             ("lm", lambda o: cells_lm(o, seed, traces)), ("earlier", lambda o: cells_earlier(res, o, traces)))
    for name, part in parts:
        out[name] = {}
        reset_all_launches()
        t0 = time.perf_counter()
        part(out[name])
        torch.cuda.synchronize()
        out[name]["part_s"] = time.perf_counter() - t0
        out["launches"][name] = all_launches()
        log(f"[cells] {name} done in {out[name]['part_s']:.1f} s; kernel launches {out['launches'][name]}; "
            f"{mem_line()}")
        torch.cuda.empty_cache()
    n = out["launches"]
    assert n["reduced"]["distance_topk"] == n["full"]["distance_topk"] == 4, n      # one a retrieval cell
    assert n["lm"]["flash_attention_wgmma"] >= 28 and n["lm"]["distance_topk"] == 0, n
    assert not any(v for k, v in n["reduced"].items() if k != "distance_topk"), n
    assert not any(v for k, v in n["full"].items() if k != "distance_topk"), n
    assert not any(n["earlier"].values()), n


# ---------------------------------------------------------------- [mesh]
def rel_l2(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def mesh_rules(mesh, *, sp: bool):
    from repro_torch.models import transformer as T

    return T.ShardingRules(batch=("data",), model="model", seq="model" if sp else None, mesh=mesh)


def mesh_prefill(out: dict, mesh, seed: int) -> None:
    """(a) phi4-mini's sequence-parallel prefill through flash."""
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer as T
    from repro_torch.models.base import shard_params

    cfg = lm_archs.get("phi4-mini-3.8b")
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, g)
    tokens = torch.randint(0, cfg.vocab, (1, MESH_PREFILL), generator=g, device="cuda")
    chunked, _ = T.prefill(params, tokens, replace(cfg, attn_impl="chunked"), max_seq=MESH_PREFILL)
    flash, _ = T.prefill(params, tokens, replace(cfg, attn_impl="flash"), max_seq=MESH_PREFILL)
    pl = shard_params(params, T.param_specs(cfg), mesh)
    n0 = fops.launches["flash_attention_wgmma"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = T.prefill(pl, tokens, replace(cfg, attn_impl="flash"), mesh_rules(mesh, sp=True),
                              max_seq=MESH_PREFILL)
    torch.cuda.synchronize()
    r = {"prefill_s": time.perf_counter() - t0, "mesh_launches": fops.launches["flash_attention_wgmma"] - n0,
         "rel_vs_chunked": rel_l2(logits, chunked), "rel_vs_flash": rel_l2(logits, flash),
         "argmax": [int(logits.argmax()), int(chunked.argmax()), int(flash.argmax())],
         "chunked_gap": float(chunked[0, int(chunked.argmax())] - chunked[0, int(logits.argmax())])}
    assert logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all()), "[mesh] (a) logits"
    assert r["mesh_launches"] == cfg.n_layers, r
    assert r["rel_vs_chunked"] < LOGIT_REL_TOL and r["chunked_gap"] <= ARGMAX_GAP, r
    assert r["rel_vs_flash"] < MESH_SAME_RTOL and r["argmax"][0] == r["argmax"][2], r
    assert tuple(cache.k.shape) == (cfg.n_layers, 1, cfg.n_kv_heads, MESH_PREFILL, cfg.d_head), cache.k.shape
    out["prefill"] = r
    log(f"[mesh] (a) sequence-parallel prefill of {MESH_PREFILL} tokens, phi4-mini bf16 at 32 layers, flash on "
        f"the rank's {cfg.n_heads} query heads: {json.dumps(r)}")


def mesh_decode(out: dict, mesh, seed: int) -> None:
    """(b) decode through flash_decode_sharded against the one-device
    decode, float32, after a one-device prompt of MESH_PREFILL tokens."""
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.models import transformer as T
    from repro_torch.models.base import shard_params

    cfg = replace(lm_archs.get("phi4-mini-3.8b"), dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = T.init_params(cfg, g)
    tokens = torch.randint(0, cfg.vocab, (1, MESH_PREFILL), generator=g, device="cuda")
    logits, c1 = T.prefill(params, tokens, cfg, max_seq=MESH_PREFILL + MESH_DECODE)
    cm = T.KVCache(k=c1.k.clone(), v=c1.v.clone(), pos=c1.pos)
    pl, rules = shard_params(params, T.param_specs(cfg), mesh), mesh_rules(mesh, sp=False)
    tok = tok_m = logits.argmax(-1)
    rel, ms, ms1 = [], [], []
    for _ in range(MESH_DECODE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l1, c1 = T.decode_step(params, c1, tok, cfg)
        torch.cuda.synchronize()
        ms1.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        lm, cm = T.decode_step(pl, cm, tok_m, cfg, rules)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rel.append(rel_l2(lm, l1))
        tok, tok_m = l1.argmax(-1), lm.argmax(-1)
        assert torch.equal(tok, tok_m), "[mesh] (b) the greedy tokens differ"
    kerr = float((cm.k - c1.k).abs().max() / c1.k.abs().max())
    r = {"rel_by_step": rel, "mesh_step_ms": ms, "one_device_step_ms": ms1, "cache_k_rel": kerr}
    assert max(rel) < MESH_DECODE_RTOL and kerr < MESH_RETR_RTOL, r
    out["decode"] = r
    log(f"[mesh] (b) {MESH_DECODE} decode steps through flash_decode_sharded, phi4-mini float32: "
        f"{json.dumps(r)}")


def mesh_retrieval(out: dict, mesh, seed: int) -> None:
    """(c) retrieval decode through retrieval_update_and_attend_sharded over
    a MESH_RETR_SEQ-token clustered cache, float32."""
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.models import retrieval_attention as R
    from repro_torch.models import transformer as T
    from repro_torch.models.base import shard_params

    cfg = replace(lm_archs.get("phi4-mini-3.8b"), dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = T.init_params(cfg, g)
    cs = cfg.retrieval.cluster_size
    c1 = R.init_clustered_cache(cfg.n_layers, 1, cfg.n_kv_heads, MESH_RETR_SEQ, cs, cfg.d_head, torch.float32)
    fill_clustered_cache(c1, MESH_RETR_SEQ - LONG_TAIL, g)
    cm = R.ClusteredKVCache(k=c1.k.clone(), v=c1.v.clone(), centroids=c1.centroids.clone(), pos=c1.pos)
    pl, rules = shard_params(params, T.param_specs(cfg), mesh), mesh_rules(mesh, sp=False)
    tok = torch.randint(0, cfg.vocab, (1,), generator=g, device="cuda")
    rel, ms, ms1 = [], [], []
    for _ in range(MESH_RETR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l1, c1 = T.retrieval_decode_step(params, c1, tok, cfg)
        torch.cuda.synchronize()
        ms1.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        lm, cm = T.retrieval_decode_step(pl, cm, tok, cfg, rules)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rel.append(rel_l2(lm, l1))
        assert torch.equal(l1.argmax(-1), lm.argmax(-1)), "[mesh] (c) the greedy tokens differ"
        tok = l1.argmax(-1)
    errs = {f: float((getattr(cm, f) - getattr(c1, f)).abs().max() / getattr(c1, f).abs().max())
            for f in ("k", "v", "centroids")}
    r = {"rel_by_step": rel, "mesh_step_ms": ms, "one_device_step_ms": ms1, "cache_rel": errs, "pos": cm.pos}
    assert max(rel) < MESH_RETR_RTOL and max(errs.values()) < MESH_RETR_RTOL and cm.pos == c1.pos, r
    out["retrieval"] = r
    log(f"[mesh] (c) {MESH_RETR_STEPS} retrieval steps through retrieval_update_and_attend_sharded over "
        f"{MESH_RETR_SEQ} tokens, phi4-mini float32: {json.dumps(r)}")


def mesh_train(out: dict, mesh, seed: int) -> None:
    """(d) a sequence-parallel loss and gradients against lm_loss without
    rules, then psum_compressed of the gradients."""
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.distributed.collectives import psum_compressed
    from repro_torch.launch.cells import _sum_replicas, value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.models.base import param_pspecs, shard_params
    from repro_torch.optim.compress import compress_decompress, init_ef_state
    from repro_torch.tree import tree_leaves

    cfg = replace(lm_archs.get("phi4-mini-3.8b"), n_layers=MESH_TRAIN_LAYERS, dtype=torch.float32)
    specs = T.param_specs(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    params = T.init_params(cfg, g, dtype=torch.float32)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, MESH_PREFILL + 1), generator=g, device="cuda")}
    (l1, _), g1 = value_and_grad(lambda p, b: T.lm_loss(p, b, cfg), params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rules = mesh_rules(mesh, sp=True)
    (lm, _), gm = value_and_grad(lambda p, b: T.lm_loss(p, b, cfg, rules), shard_params(params, specs, mesh), batch)
    gm, norm = _sum_replicas(gm, mesh, param_pspecs(specs))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    gerr = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(tree_leaves(gm), tree_leaves(g1)))
    r = {"loss": float(lm), "loss_one_device": float(l1), "loss_rel": abs(float(lm - l1)) / abs(float(l1)),
         "grad_rel_max": gerr, "grad_norm": float(norm), "mesh_loss_and_grads_s": step_s}
    del g1
    comp = psum_compressed(gm, mesh, "data")
    ref, _ = compress_decompress(gm, init_ef_state(gm))
    r["psum_compressed_equal"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(comp), tree_leaves(ref)))
    assert r["loss_rel"] < MESH_TRAIN_RTOL and gerr < MESH_TRAIN_RTOL and r["psum_compressed_equal"], r
    out["train"] = r
    log(f"[mesh] (d) sequence-parallel loss and gradients, phi4-mini float32 at {MESH_TRAIN_LAYERS} layers, "
        f"{MESH_PREFILL} tokens: {json.dumps(r)}")


def mesh_cells(out: dict, mesh, seed: int) -> None:
    """The 20 reduced LM cells through lower_cell against their one-device
    step on the card."""
    import torch
    from repro_torch.configs import ALL_CELLS, get_arch
    from repro_torch.distributed.elastic import map_specs
    from repro_torch.launch import cells

    rows = {}
    for arch, shape in ALL_CELLS:
        if get_arch(arch)[0] != "lm":
            continue
        one = cells.build_cell(arch, shape, mesh_axes=None, reduced=True)
        cell = cells.build_cell(arch, shape, mesh_axes=mesh.mesh_dim_names, reduced=True)
        with torch.no_grad():
            want = one.fn(*to_cuda(cells.example_inputs(one, seed, device="cpu")))
            got = cells.lower_cell(cell, mesh)(*to_cuda(cells.example_inputs(cell, seed, device="cpu")))
        got = map_specs(lambda t, ps: t.full_tensor(), got, cell.out_pspecs)
        what = f"[mesh] cells {arch} {shape}"
        errs = [held_close(what, a, b.cpu()) for a, b in zip(cells.arg_leaves(got), cells.arg_leaves(want))]
        rows[f"{arch}/{shape}"] = max(errs)
    assert len(rows) == 20, rows
    out["cells"] = rows
    log(f"[mesh] the 20 reduced LM cells through lower_cell against one device, max abs err: {json.dumps(rows)}")


def mesh_moe(out: dict, mesh, seed: int) -> None:
    """llama4-scout at MESH_SCOUT_LAYERS layers, no token dropped: the
    sequence-parallel prefill (moe_ffn_ep) against the one-device one
    (moe_ffn), both through flash."""
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.models import transformer as T
    from repro_torch.models.base import shard_params

    full = lm_archs.get("llama4-scout-17b-a16e")
    cfg = replace(full, n_layers=MESH_SCOUT_LAYERS, attn_impl="flash",
                  moe=replace(full.moe, capacity_factor=float(full.moe.n_experts)))
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    params = T.init_params(cfg, g)
    tokens = torch.randint(0, cfg.vocab, (1, MESH_PREFILL), generator=g, device="cuda")
    l1, _ = T.prefill(params, tokens, cfg, max_seq=MESH_PREFILL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm, _ = T.prefill(shard_params(params, T.param_specs(cfg), mesh), tokens, cfg, mesh_rules(mesh, sp=True),
                      max_seq=MESH_PREFILL)
    torch.cuda.synchronize()
    r = {"rel": rel_l2(lm, l1), "argmax": [int(lm.argmax()), int(l1.argmax())], "mesh_prefill_s":
         time.perf_counter() - t0, "experts": cfg.moe.n_experts, "capacity_factor": cfg.moe.capacity_factor}
    assert r["rel"] < MESH_SAME_RTOL and r["argmax"][0] == r["argmax"][1], r
    out["moe"] = r
    log(f"[mesh] llama4-scout at {MESH_SCOUT_LAYERS} layers, {MESH_PREFILL} tokens, moe_ffn_ep against moe_ffn: "
        f"{json.dumps(r)}")


def mesh_graph_recsys(out: dict, mesh, seed: int) -> None:
    """The 20 reduced GraphSAGE and recsys cells through lower_cell against
    their one-device step, then MESH_GR_FULL at full width, each from one
    set of live_inputs (a copy a step: the train steps work in place)."""
    import torch
    from repro_torch.configs import ALL_CELLS, get_arch
    from repro_torch.distributed.elastic import map_specs
    from repro_torch.launch import cells
    from repro_torch.tree import tree_map

    def both(arch, shape, reduced, make):
        one = cells.build_cell(arch, shape, mesh_axes=None, reduced=reduced)
        low = cells.lower_cell(cells.build_cell(arch, shape, mesh_axes=mesh.mesh_dim_names, reduced=reduced), mesh)
        args = make(one)
        copy = lambda: tree_map(lambda t: t.clone(), args) if one.kind == "train" else args
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = one.fn(*copy())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = map_specs(lambda t, ps: t.full_tensor(), low(*copy()), low.out_pspecs)
        torch.cuda.synchronize()
        what = f"[mesh] graph_recsys {arch} {shape}{' reduced' if reduced else ''}"
        row = {"one_device_s": t1 - t0, "mesh_s": time.perf_counter() - t1}
        if one.kind == "train":
            row.update(held_train(what, one.meta["family"], got, tree_map(lambda t: t.cpu(), want)))
        elif one.kind == "serve":
            row["err"] = held_close(what, got, want.cpu())
        else:
            assert torch.equal(got[1], want[1]) and bool((got[1] >= 0).all()), what
            err = (got[0] - want[0]).abs().cpu().numpy()
            assert (err <= tol(want[0].cpu().numpy())).all(), (what, err.max())
            row["err"] = float(err.max())
        return row

    rows = {}
    for arch, shape in ALL_CELLS:
        if get_arch(arch)[0] != "lm":
            rows[f"{arch}/{shape}"] = both(arch, shape, True,
                                           lambda c: to_cuda(cells.live_inputs(c, seed, device="cpu")))
    assert len(rows) == 20, rows
    out["graph_recsys"] = {"reduced": rows}
    log(f"[mesh] graph_recsys: the 20 reduced GraphSAGE and recsys cells through lower_cell against one device: "
        f"{json.dumps(rows)}")
    full = {}
    for arch, shape in MESH_GR_FULL:
        full[f"{arch}/{shape}"] = both(arch, shape, False, lambda c: cells.live_inputs(c, seed, device="cuda"))
        log(f"[mesh] graph_recsys {arch} {shape} at full width: {json.dumps(full[f'{arch}/{shape}'])}; {mem_line()}")
        torch.cuda.empty_cache()
    out["graph_recsys"]["full"] = full


def phase_mesh(res: dict, seed: int, work: Path) -> None:
    """[mesh]: the distribution layer on the host mesh, NCCL at world size
    1; each part's launches counted from 0."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh, process_group

    out = res["mesh"] = {"launches": {}, "part_s": {}}
    with process_group(0, 1, init_file=work / "mesh_store", backend="nccl"):
        mesh = make_host_mesh()
        log(f"[mesh] {gpu_line()}; NCCL, world size 1, host mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}")
        for name, part in (("prefill", mesh_prefill), ("decode", mesh_decode), ("retrieval", mesh_retrieval),
                           ("train", mesh_train), ("cells", mesh_cells), ("moe", mesh_moe),
                           ("graph_recsys", mesh_graph_recsys)):
            reset_all_launches()
            t0 = time.perf_counter()
            part(out, mesh, seed)
            torch.cuda.synchronize()
            out["part_s"][name] = time.perf_counter() - t0
            out["launches"][name] = all_launches()
            log(f"[mesh] {name} done in {out['part_s'][name]:.1f} s; kernel launches {out['launches'][name]}; "
                f"{mem_line()}")
            torch.cuda.empty_cache()
    n = out["launches"]
    # (a): one-device flash, then the mesh's: a launch a layer each; scout: the same, 4 layers
    assert n["prefill"]["flash_attention_wgmma"] == 64 and n["moe"]["flash_attention_wgmma"] == 2 * MESH_SCOUT_LAYERS, n
    assert not any(v for p in ("decode", "retrieval", "train", "cells") for v in n[p].values()), n
    # graph_recsys: distance_topk once a retrieval_cand run, one-device and mesh, reduced and full width
    runs = 2 * (4 + sum(shape == "retrieval_cand" for _, shape in MESH_GR_FULL))
    assert n["graph_recsys"]["distance_topk"] == runs, n
    assert not any(v for k, v in n["graph_recsys"].items() if k != "distance_topk"), n
    log(f"[mesh] phase seconds by part {json.dumps(out['part_s'])}; {gpu_line()}")


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
    traces = (fault_dir / "cell_traces.json", start_cell_traces(fault_dir / "cell_traces.json"))
    try:
        kernels = run_phases(res, args, fault_builds, traces, t_all)
    finally:
        for p in [p for _, _, p in fault_builds.values()] + [traces[1]]:
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


def run_phases(res: dict, args, fault_builds: dict, traces: tuple, t_all: float) -> list:
    """Every phase in order; returns the kernels line's entries.  ``traces``:
    (the file, the process) of the cells' dry run, started with the smoke."""
    import torch

    phase_kernels(res, fault_builds)
    log(f"[kernels] phase done at {time.time() - t_all:.1f} s")
    phase_split(res, fault_builds)
    log(f"[split] phase done at {time.time() - t_all:.1f} s")
    phase_recsys(res, args.seed)
    log(f"[recsys] phase done at {time.time() - t_all:.1f} s")
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
        phase_read_path(work, Q, cfg, res, built)
        log(f"[read] (a)-(d) done at {time.time() - t_all:.1f} s")
        phase_federation(work, data, Q, cfg, res, built)
        log(f"[federation] phase done at {time.time() - t_all:.1f} s")
        phase_baselines(work, data, Q, cfg, res, built)
        log(f"[baselines] phase done at {time.time() - t_all:.1f} s")
        phase_serve(work, data, Q, cfg, res, built, args.seed, fault_builds)
        log(f"[serve] phase done at {time.time() - t_all:.1f} s")
        (work / "main.blob").unlink()  # the fstore stays for the session, (e)
        cfg2 = ECPFSPaperConfig(**{**cfg.__dict__, "n_items": args.l2_items, "metric": "l2"})
        x, _ = clustered_vectors(args.seed + 1, n=cfg2.n_items + cfg2.serve_batch, dim=cfg2.dim)
        Q2 = x[cfg2.n_items :]
        built2 = run_path("l2", work, x[: cfg2.n_items], Q2, cfg2, res, scorer_rows=16)
        assert res["l2"]["bit_identical"], "l2: quantized search differs from the fp engine"
        log(f"[l2] phase done at {time.time() - t_all:.1f} s")
        phase_session(Q, Q2, res, built, built2, cfg)
        log(f"[read] (e) done at {time.time() - t_all:.1f} s; read path seconds by part "
            f"{json.dumps(res['read']['part_s'])}")
        shutil.rmtree(work / "main_fs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    fault_libs = load_faults(fault_builds, "flash_attention_wgmma")
    phase_flash(res, fault_libs)
    log(f"[flash] phase done at {time.time() - t_all:.1f} s")
    phase_lm(res, args.seed, fault_libs)
    torch.cuda.empty_cache()
    log(f"[lm] phase done at {time.time() - t_all:.1f} s; {mem_line()}")
    phase_long500k(res, args.seed)
    torch.cuda.empty_cache()
    log(f"[long500k] phase done at {time.time() - t_all:.1f} s; {mem_line()}")
    phase_moe(res, args.seed)
    torch.cuda.empty_cache()
    log(f"[moe] phase done at {time.time() - t_all:.1f} s; {mem_line()}")
    phase_train(res, args.seed)
    log(f"[train] phase done at {time.time() - t_all:.1f} s")
    t0 = time.time()
    cell_traces = read_cell_traces(traces[1], traces[0])
    log(f"[cells] the dry run's traces ready {time.time() - t0:.1f} s after [train]")
    phase_cells(res, args.seed, cell_traces)
    log(f"[cells] phase done at {time.time() - t_all:.1f} s")
    mesh_dir = Path(tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build"))
    try:
        phase_mesh(res, args.seed, mesh_dir)
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    log(f"[mesh] phase done at {time.time() - t_all:.1f} s")
    main_launches = res["main"]["launches"]
    g, t, f32k, sp = res["grouped"], res["topk"], res["flash_32k"], res["split"][RECSYS_WIDTHS[0]]
    lf, mg = res["leaf"], res["merge"]
    four = ("device_ms", "library_device_ms", "kernels_per_call")
    pr = res["main"]["per_round_ms"]
    # the launches of each kernel on the LM paths of this slice, counted from 0 around each
    scout, maverick = res["moe"]["llama4-scout-17b-a16e"], res["moe"]["llama4-maverick-400b-a17b"]
    lm_paths = lambda name: {"long500k_launches": res["long500k"]["launches"][name],
                             "moe_launches": {"llama4-scout": scout["launches"][name],
                                              "llama4-maverick": maverick["launches"][name]},
                             "train_launches": {p: v[name] for p, v in res["train"]["launches"].items()},
                             "cells_launches": {p: v[name] for p, v in res["cells"]["launches"].items()},
                             "mesh_launches": {p: v[name] for p, v in res["mesh"]["launches"].items()}}
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
                            for p in ("interactive", "concurrent")},
         "read_path_launches": {p: v["grouped_distance_topk"] for p, v in res["read"]["launches"].items()},
         "federation_launches": {**res["federation"]["shard_launches"],
                                 "one_shard": res["federation"]["one_shard_launches"]["grouped_distance_topk"]},
         "baselines_launches": res["baselines"]["launches"]["grouped_distance_topk"],
         **lm_paths("grouped_distance_topk")},
        {"name": "distance_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/distance_topk.cu",
         "replaces": "src/repro/kernels/distance_topk/distance_topk.py:101",
         "launches": main_launches["distance_topk"],
         "max_abs_err": res["topk_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
         **{a: t[a] for a in four}, "shape": "B=1 N_pad=512 D=1152 f32 cosine k=512",
         "by_n_pad": {n: {a: v[a] for a in ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms")}
                      for n, v in res["topk_by_n"].items()},
         "scorer_call": res["scorer_call"],
         "read_path_launches": {"session": res["read"]["launches"]["session"]["distance_topk"]},
         "federation_launches": res["federation"]["launches"]["distance_topk"],
         "baselines_launches": res["baselines"]["launches"]["distance_topk"],
         "recsys_launches": {a: v["launches"]["distance_topk"] for a, v in res["recsys"].items()},
         "custom_op": res["cells"]["overhead"]["distance_topk"],
         **lm_paths("distance_topk")},
        {"name": "distance_topk (k < N path)", "route": "cuda",
         "source": "src/repro_torch/csrc/distance_topk.cu",
         "replaces": "src/repro/kernels/distance_topk/distance_topk.py:101",
         "launches": sum(v["launches"]["distance_topk"] for v in res["recsys"].values()),
         "max_abs_err": max(res["split_err"], res["topk_err"]), "ms": sp["ms"], "plain_ms": sp["plain_ms"],
         "bound_ms": sp["bound_ms"], "bound_by": sp["bound_by"], "library_ms": sp["library_ms"],
         **{a: sp[a] for a in four}, "shape": "B=1 N=1000000 d=32 f32 ip k=100 (candidate_scores, bst)",
         "by_width": {d: {a: v[a] for a in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                                             "stream_ms", "bound_ms", "kernels_per_call", "blocks")}
                      for d, v in res["split"].items()},
         "recsys_launches": {a: v["launches"]["distance_topk"] for a, v in res["recsys"].items()},
         "b128": {**res["topk_merge"], "shape": "B=128 N=65536 D=1152 f32 l2 k=100"},
         **lm_paths("distance_topk")},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100",
         "launches": res["lm"]["flash"]["launches"],
         "max_abs_err": res["flash_err"], "ms": f32k["ms"], "plain_ms": res["flash_4k"]["plain_ms"],
         "bound_ms": f32k["bound_ms"], "bound_by": f32k["bound_by"], "library_ms": f32k["library_ms"],
         "shape": "B=1 Hq=24 Hkv=8 S=32768 d=128 bf16 causal", "plain_shape": "S=4096 (else the same)",
         "max_row_rel_err": res["flash_row_err"], "mma_sync_ms": f32k["mma_sync_ms"],
         **{a: f32k[a] for a in four},
         "tflops_counted": f32k["tflops_counted"], "tflops_issued": f32k["tflops_issued"],
         "ms_4k": res["flash_4k"]["ms"], "mma_sync_ms_4k": res["flash_4k"]["mma_sync_ms"],
         "ptxas": res.get("wgmma_ptxas"), "custom_op": res["cells"]["overhead"]["flash_attention_wgmma"],
         **lm_paths("flash_attention_wgmma"),
         "other_flash_launches": {"lm": res["lm"]["flash"]["other_flash_launches"],
                                  **lm_paths("flash_attention")}},
        {"name": "leaf_distances", "route": "cuda",
         "source": "src/repro_torch/csrc/leaf_distances.cu",
         "replaces": None, "replaces_why": "new: the JAX package's packed search runs XLA's products",
         "launches": res["serve"]["batched_launches"]["leaf_distances"],
         "max_abs_err": lf["max_abs_err"], "ms": lf["ms"], "plain_ms": lf["plain_ms"],
         "bound_ms": lf["bound_ms"], "bound_by": lf["bound_by"], "library_ms": lf["library_ms"],
         "device_ms": lf["device_ms"], "op_device_ms": lf["op_device_ms"],
         "op_kernels_per_call": lf["op_kernels_per_call"], "library_device_ms": lf["library_device_ms"],
         "counted": lf["counted"],
         "shape": f"B={LEAF_B} b={LEAF_b} L={LEAF_L} cap={LEAF_CAP} D={D} f32 cosine, real rows median 250, mean ~455",
         "l2": {a: lf["l2"][a] for a in ("ms", "device_ms", "op_device_ms", "plain_ms", "library_ms",
                                         "library_device_ms", "bound_ms")},
         "ptxas": res.get("leaf_distances_ptxas"),
         "serve_launches": {"packed": res["serve"]["batched_launches"]["leaf_distances"],
                            "ties": res["serve"]["ties"]["launches"]["leaf_distances"]},
         "baselines_launches": {"packed": res["baselines"]["packed_launches"]["leaf_distances"],
                                "bruteforce_ivf": res["baselines"]["launches"]["leaf_distances"]},
         **lm_paths("leaf_distances")},
        {"name": "leaf_merge", "route": "cuda",
         "source": "src/repro_torch/csrc/leaf_merge.cu",
         "replaces": None, "replaces_why": "new: the JAX package's packed search merges with XLA's argsort",
         "launches": res["serve"]["batched_launches"]["leaf_merge"], "max_abs_err": 0.0,
         **{a: mg[a] for a in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                               "bound_by", "counted", "kernels_per_call", "ms_full_buffer")},
         "shape": f"B={LEAF_B} b={LEAF_b} L={LEAF_L} cap={LEAF_CAP} C={MERGE_C}, the leaf kernel's cosine distances",
         "ptxas": res.get("leaf_merge_ptxas"),
         "serve_launches": {"packed": res["serve"]["batched_launches"]["leaf_merge"],
                            "ties": res["serve"]["ties"]["launches"]["leaf_merge"]},
         "baselines_launches": {"packed": res["baselines"]["packed_launches"]["leaf_merge"],
                                "bruteforce_ivf": res["baselines"]["launches"]["leaf_merge"]},
         **lm_paths("leaf_merge")},
    ]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
