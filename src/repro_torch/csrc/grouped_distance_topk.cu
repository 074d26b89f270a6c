// Grouped quantized distance + top-k: ONE launch scores every (query, leaf)
// unit of a traversal round of the quantized file-mode search.
//
// Replaces: src/repro/kernels/distance_topk/grouped.py ::
//   grouped_distance_topk_pallas (body _gkernel), the TPU kernel called once
//   per leaf-bearing round at src/repro/core/search.py:1242.
//
// Computes, for each group g: decode codes[g] (int8 as code*scale+offset,
// float16 by widening), score every row r < n_rows[g] against q[g] under
// l2 (|q|^2+|c|^2-2q.c), ip (-q.c) or cosine (1 - q.c * rsqrt(|q|^2+1e-12) *
// rsqrt(|c|^2+1e-12)), and return the k smallest (distance, row) pairs in
// ascending order with ties to the lower row; entries with no row are
// (inf, -1).
//
// What bounds it on an H100: bytes.  At the main path's shape (G=128
// units, 455-row leaves, D=1152, int8) the codes are ~67 MB and the work is
// ~2 multiply-adds a byte, so the least time is the codes over the memory
// rate (~20 us at 3.35 TB/s).  Next in line is the int8 decode: a
// conversion instruction runs at 16 a clock per SM, ~16 us for those 67 M
// codes alone, so the codes are converted without it (common.cuh dec4).
// The search pads a round's codes to its largest leaf (up to 11.8x the
// mean at 200k items), so the rows a group really holds vary widely.
//
// Design:
//  * Work is a list of (group, tile of kTile rows) items, only those that
//    hold rows, group by group; a persistent grid of as many blocks as the
//    card holds at once (four an SM) takes item b, b + gridDim.x, ... each.
//    A leaf of 5360 rows spreads over 21 blocks and SMs, and the padding
//    of a round's smaller leaves costs nothing.  Every block finds its
//    items by scanning n_rows, 128 groups a step (find_item).
//  * A tile's rows are contiguous (kTile*D bytes), so one thread streams
//    them into a ring of kStages shared-memory stages of 16 int8 rows (8
//    float16) with 1-d bulk copies (cp.async.bulk) completing on an
//    mbarrier each; the warps score 2 int8 rows (1 float16 row) at a time
//    from shared memory, each query slice read once for both, the sums in
//    float32 registers.  Widths whose rows are not 16-byte aligned read the
//    rows from global memory instead (no ring).
//  * Top-k in two levels.  Each tile sorts its kTile (distance, row) keys
//    (common.cuh block_sort) and keeps the first P = min(pow2(k), kTile).
//    A group of one tile writes them out directly.  Otherwise every tile
//    writes its list to a global scratch, and the last tile of the group to
//    finish (an atomic counter it resets) merges the lists in shared memory
//    (common.cuh merge_sorted_lists) into the ascending top-k: all at once,
//    or in batches behind a running list when they would not fit.  Keys
//    are compared whole (distance above, row below), so ties stay with the
//    lower row across tiles.  Nothing sorts a whole leaf unless k asks for
//    all of it.
// Measured (chip_smoke.py, PERF.md): the ring keeps the memory busy for
// about the bound's time; what the kernel takes beyond it is each tile's
// start (finding its item, the first stages' latency) and end (its sort,
// the counter, the group's merge), which the blocks of one wave do at the
// same time, so nothing overlaps them.
#include "common.cuh"

namespace ecp {

constexpr int kTile = 256;   // rows of a leaf one block scores
constexpr int kStages = 2;   // ring depth
constexpr int kBarBytes = 128;
constexpr int kBlocksPerSM = 4;  // resident blocks an SM holds (~43 KB of shared memory, 64 registers a thread)

// tiles that hold a group's rows
__device__ __forceinline__ int tiles_of(int n) { return (n + kTile - 1) / kTile; }

struct GArgs {
  const float* q;
  const void* codes;
  const float* scales;
  const float* offsets;
  const int* n_rows;
  float* out_d;
  int* out_i;
  unsigned long long* lists;  // [G, tiles, P]
  int* counters;              // [G], 0 between launches
  int G, N, D, k, metric, tiles, P, cap;
  int batch;  // lists merged at a time behind a running list (0: all at once)
};

// ---- the work list: every (group, tile) that holds rows, in order
__device__ __forceinline__ int group_tiles(const GArgs& a, int g) {
  return g < a.G ? tiles_of(min(max(a.n_rows[g], 0), a.N)) : 0;
}

// Warp 0 walks the groups to the one holding item j, from where its
// previous walk stopped (items only grow), 128 groups a step (four loads
// a lane in flight): the step at group g0 starts at item j0.  Returns
// false when j is past the last item.
struct Walk {
  int g0 = 0, j0 = 0;
};
__device__ bool find_item(const GArgs& a, Walk& w, int j, int lane, int* g, int* tile) {
  while (w.g0 < a.G) {
    int t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) t[u] = group_tiles(a, w.g0 + 32 * u + lane);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int incl = t[u];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      if (j < w.j0 + total) {
        const int l = __ffs(__ballot_sync(0xffffffffu, w.j0 + incl > j)) - 1;
        *g = w.g0 + 32 * u + l;
        *tile = j - w.j0 - __shfl_sync(0xffffffffu, incl - t[u], l);
        w.g0 += 32 * u;  // resume at this chunk
        return true;
      }
      w.j0 += total;
    }
    w.g0 += 128;
  }
  return false;
}

// BULK: rows staged through the ring (D*sizeof(CodeT) a multiple of 16, the
// codes 16-byte aligned); else read from global memory by row_dot.
// Persistent: the work list holds every (group, tile) with rows, group by
// group; block b takes items b, b + gridDim.x, ..., so no block waits on
// another's tiles while it could start its own, and no tile past a
// group's rows costs a block.
template <typename CodeT, bool BULK>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
grouped_tile_kernel(GArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRpw = sizeof(CodeT) == 1 ? 2 : 1;  // rows a warp scores at once
  constexpr int kStageRows = kWarps * kRpw;
  const int D = a.D, G = a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // shared: barriers | query (f32) | tile keys | ring; the merge reuses all
  // but the barriers
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + kBarBytes);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + kBarBytes + align16(D * sizeof(float)));
  unsigned char* ring = reinterpret_cast<unsigned char*>(keys) + kTile * 8;
  const size_t row_bytes = static_cast<size_t>(D) * sizeof(CodeT);
  const uint32_t stage_bytes = static_cast<uint32_t>(kStageRows * row_bytes);
  if (BULK && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int fills = 0;  // ring fills so far: fill f uses slot f % kStages, phase (f / kStages) & 1
  // an empty group's pads, by the blocks in turn
  for (int g = blockIdx.x; g < G; g += gridDim.x)
    if (group_tiles(a, g) == 0)
      write_topk(nullptr, 0, a.k, a.out_d + static_cast<size_t>(g) * a.k, a.out_i + static_cast<size_t>(g) * a.k);
  __shared__ int s_item[2];
  Walk walk;
  for (int item = blockIdx.x;; item += gridDim.x) {
    if (warp == 0) {
      int g = -1, tile = 0;
      find_item(a, walk, item, lane, &g, &tile);
      if (lane == 0) s_item[0] = g, s_item[1] = tile;
    }
    __syncthreads();  // also: the previous item's merge is done with shared memory
    if (s_item[0] < 0) break;
    const int g = s_item[0], tile = s_item[1];
    const int n = min(max(a.n_rows[g], 0), a.N);
    const int m = tiles_of(n);
    float* out_d = a.out_d + static_cast<size_t>(g) * a.k;
    int* out_i = a.out_i + static_cast<size_t>(g) * a.k;
    const int r0 = tile * kTile;
    const int rows = min(kTile, n - r0);
    const unsigned char* src =
        static_cast<const unsigned char*>(a.codes) + (static_cast<size_t>(g) * a.N + r0) * row_bytes;
    const int stages = (rows + kStageRows - 1) / kStageRows;
    auto load_stage = [&](int i) {  // stage i of this tile, fill fills + i
      const int slot = (fills + i) % kStages;
      const uint32_t bytes = static_cast<uint32_t>(min(kStageRows, rows - i * kStageRows) * row_bytes);
      const uint32_t bar = smem_u32(bars + slot);
      mbar_expect_tx(bar, bytes);
      bulk_load(smem_u32(ring + slot * stage_bytes), src + static_cast<size_t>(i) * stage_bytes, bytes, bar);
    };
    if (BULK && threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the last merge's writes
      for (int i = 0; i < min(kStages, stages); ++i) load_stage(i);
    }
    const float qq = load_query(a.q + static_cast<size_t>(g) * D, qs, D);  // synchronises
    const float sc = a.scales[g], of = a.offsets[g];

    if (BULK) {
      for (int i = 0; i < stages; ++i) {
        const int f = fills + i;
        mbar_wait(smem_u32(bars + f % kStages), (f / kStages) & 1);
        const CodeT* st = reinterpret_cast<const CodeT*>(ring + (f % kStages) * stage_bytes);
        const int base = i * kStageRows + warp * kRpw;  // tile row of this warp's first row
        if (base < rows) {
          const CodeT* rp[kRpw];
#pragma unroll
          for (int j = 0; j < kRpw; ++j)  // a row past the tile re-reads the first (ignored)
            rp[j] = st + static_cast<size_t>(base + j < rows ? warp * kRpw + j : warp * kRpw) * D;
          float dot[kRpw], cc[kRpw];
          rows_dot_smem<CodeT, kRpw>(rp, qs, D, sc, of, lane, dot, cc);
          if (lane == 0) {
#pragma unroll
            for (int j = 0; j < kRpw; ++j)
              if (base + j < rows)
                keys[base + j] = make_key(metric_of(a.metric, qq, dot[j], cc[j]), r0 + base + j);
          }
        }
        __syncthreads();  // every warp is done with this slot
        if (threadIdx.x == 0 && i + kStages < stages) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          load_stage(i + kStages);
        }
      }
      fills += stages;
    } else {
      const CodeT* rows_g = reinterpret_cast<const CodeT*>(src);
      for (int t = warp; t < rows; t += kWarps) {
        float dot, cc;
        row_dot<CodeT>(rows_g + static_cast<size_t>(t) * D, qs, D, sc, of, lane, &dot, &cc);
        if (lane == 0) keys[t] = make_key(metric_of(a.metric, qq, dot, cc), r0 + t);
      }
    }
    for (int t = rows + threadIdx.x; t < kTile; t += blockDim.x) keys[t] = kMaxKey;
    __syncthreads();
    block_sort(keys, kTile);

    if (m == 1) {
      write_topk(keys, a.P, a.k, out_d, out_i);
      continue;
    }
    unsigned long long* lists = a.lists + static_cast<size_t>(g) * a.tiles * a.P;
    for (int j = threadIdx.x; j < a.P; j += blockDim.x) lists[static_cast<size_t>(tile) * a.P + j] = keys[j];
    if (!last_to_arrive(a.counters + g, m)) continue;
    // the last tile of the group merges the group's m lists: all at once,
    // or a batch of lists at a time into a running top-cap list (so that
    // the merge fits in the tile's shared memory)
    const int m2 = pow2_at_least(m);
    unsigned long long* mk = reinterpret_cast<unsigned long long*>(smem + kBarBytes);
    if (a.batch == 0 || m2 <= a.batch) {
      load_keys(mk, lists, m * a.P, m2 * a.P);
      __syncthreads();
      merge_sorted_lists(mk, m2, a.P, a.cap);
      write_topk(mk, min(m2 * a.P, a.cap), a.k, out_d, out_i);
      continue;
    }
    unsigned long long* bat = mk + a.cap;  // directly behind the running list
    for (int j = threadIdx.x; j < a.cap; j += blockDim.x) mk[j] = kMaxKey;
    for (int t0 = 0; t0 < m; t0 += a.batch) {
      const int nl = min(a.batch, m - t0), nl2 = pow2_at_least(nl);
      load_keys(bat, lists + static_cast<size_t>(t0) * a.P, nl * a.P, max(nl2 * a.P, a.cap));
      __syncthreads();
      merge_sorted_lists(bat, nl2, a.P, a.cap);
      merge_sorted_lists(mk, 2, a.cap, a.cap);
    }
    write_topk(mk, a.cap, a.k, out_d, out_i);
  }
  if (BULK) {
    __syncthreads();
    if (threadIdx.x == 0)
      for (int s = 0; s < kStages; ++s) mbar_inval(smem_u32(bars + s));
  }
}

template <typename CodeT, bool BULK>
cudaError_t launch(const GArgs& a, cudaStream_t stream) {
  constexpr int kStageRows = kWarps * (sizeof(CodeT) == 1 ? 2 : 1);
  const size_t tile_part = align16(a.D * sizeof(float)) + kTile * 8 +
                           (BULK ? static_cast<size_t>(kStages) * kStageRows * a.D * sizeof(CodeT) : 0);
  // the merge: all lists at once if they fit in the tile's shared memory,
  // else batches behind a running list of cap keys if those fit, else all
  // at once in more shared memory (large k only)
  size_t merge_part = static_cast<size_t>(pow2_at_least(a.tiles)) * a.P * 8;
  GArgs b = a;
  b.batch = 0;
  if (merge_part > tile_part) {
    const long long room = static_cast<long long>(tile_part / 8) - a.cap;  // keys for a batch
    int nb = 1;
    while (2LL * nb * a.P <= room) nb <<= 1;
    if (static_cast<long long>(nb) * a.P <= room && nb * a.P >= a.cap) {
      b.batch = nb;
      merge_part = 0;
    }
  }
  const size_t smem = kBarBytes + (tile_part > merge_part ? tile_part : merge_part);
  const void* kern = reinterpret_cast<const void*>(grouped_tile_kernel<CodeT, BULK>);
  const int slot = 2 * (sizeof(CodeT) - 1) + BULK;
  cudaError_t e = allow_smem(slot, kern, smem);
  if (e != cudaSuccess) return e;
  // as many blocks as stay resident at once, at most one a (group, tile)
  int resident = 0;
  e = resident_blocks(slot, kern, kThreads, smem, &resident);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>(b.G) * b.tiles;
  const int blocks = static_cast<int>(items < resident ? items : resident);
  grouped_tile_kernel<CodeT, BULK><<<blocks > 0 ? blocks : 1, kThreads, smem, stream>>>(b);
  return cudaGetLastError();
}

}  // namespace ecp

extern "C" {

// Largest dynamic shared memory a block may opt in to (bytes).
int grouped_smem_optin() { return ecp::smem_optin(); }

// qformat: 0 = int8, 1 = float16.  metric: 0 = l2, 1 = ip, 2 = cosine.
// All pointers are device pointers of contiguous tensors.  lists: room for
// G * ceil(N / tile) * min(pow2(k), tile) 8-byte keys; counters: G ints,
// all 0 (every launch leaves them 0).  tile must be the kernel's row tile
// (256).  Returns a cudaError_t (0 on success).
int grouped_distance_topk_launch(const void* q, const void* codes, const void* scales,
                                 const void* offsets, const void* n_rows, void* out_d,
                                 void* out_i, void* lists, void* counters, int G, int N, int D,
                                 int k, int metric, int qformat, int tile, void* stream) {
  if (G <= 0 || k <= 0) return 0;
  if (N < 0 || D <= 0 || metric < 0 || metric > 2 || tile != ecp::kTile) return cudaErrorInvalidValue;
  const int k2 = ecp::pow2_at_least(k);
  ecp::GArgs a{static_cast<const float*>(q), codes, static_cast<const float*>(scales),
               static_cast<const float*>(offsets), static_cast<const int*>(n_rows),
               static_cast<float*>(out_d), static_cast<int*>(out_i),
               static_cast<unsigned long long*>(lists), static_cast<int*>(counters),
               G, N, D, k, metric, N > 0 ? (N + ecp::kTile - 1) / ecp::kTile : 1,
               k2 < ecp::kTile ? k2 : ecp::kTile, k2, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) % 16) == 0;
  if (qformat == 0) {
    if (aligned && D % 16 == 0) return ecp::launch<int8_t, true>(a, st);
    return ecp::launch<int8_t, false>(a, st);
  }
  if (qformat == 1) {
    if (aligned && D % 8 == 0) return ecp::launch<__half, true>(a, st);
    return ecp::launch<__half, false>(a, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
