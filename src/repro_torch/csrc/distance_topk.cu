// Fused distance + top-k over one candidate set: q [B, D] against c [N, D]
// (float32, bfloat16 or float16), float32 accumulation, ascending k
// smallest (distance, index) per query row with ties to the lower index,
// (inf, -1) for entries with no candidate.
//
// Replaces: src/repro/kernels/distance_topk/distance_topk.py ::
//   distance_topk_pallas (bodies _kernel and _merge_topk).  Two callers:
//   the leaf scorer make_kernel_scorer (src/repro/core/search.py:212-232),
//   which asks for full selection (k == N_pad, N_pad a multiple of 512),
//   and the recsys retrieval tower's candidate_scores
//   (src/repro/models/recsys.py:338), which asks for k = 100 of N =
//   1 000 000 candidates at B = 1, D = 32, 18 or 16, metric ip.  The TPU
//   kernel returns a stale id for padded entries; this one returns
//   (inf, -1) there.
//
// What bounds it on an H100: bytes, at both callers' shapes.  The scorer's
// (B=1, N_pad=512 or 1024, D=1152, float32): 2-4.7 MB of candidates, ~0.7-
// 1.4 us at 3.35 TB/s, well below the few microseconds a launch and a sort
// take, so its 1224 calls a search are bound by launches and the host.
// candidate_scores' (B=1, N=1M, D=32/18/16, float32): 128/72/64 MB read
// once, 38/21/19 us, at 0.5 multiply-adds a byte.  At a large-batch shape
// (B=128, N=65536, D=1152, k=100) operations: 19 GFLOP at the 67 TFLOP/s
// of float32 outside the tensor cores, ~0.29 ms.
//
// Design, two paths, each ONE launch:
//  * k >= N (full selection): blocks of kFullRows = 32 rows (16 blocks a
//    query row at N_pad=512, so one row still draws on many SMs' share of
//    the memory rate) score their rows, a warp two rows at a time with
//    16-byte loads, ten steps of both rows in flight (a whole 1152-wide
//    float32 row a lane-step).  Each block sorts its 32 keys in registers
//    as the first steps of the row's bitonic sort (ascending in even
//    blocks, descending in odd ones) and writes them to a scratch; the last
//    block of the query row to finish (an atomic counter it resets) reads
//    them all back and finishes the bitonic sort in shared memory
//    (common.cuh block_sort) and writes the row out.  N is bounded by the
//    shared memory of that sort, 8 bytes a key (16384 rows on an H100; the
//    wrapper raises above that).
//  * k < N (split): the candidates are cut into nblk contiguous chunks a
//    query row (ops.topk_split_plan: about 1056 blocks in all, at most 264
//    a row, so B = 1 still puts two blocks on every SM), one block a
//    (chunk, query row), query rows the fast axis of the grid so that the
//    blocks reading one chunk run together and share it in L2.  Rows up to
//    kNarrowD wide (the recsys widths) stream through a ring of 2-4
//    shared-memory stages of 256 rows filled by 1-d bulk copies
//    (cp.async.bulk, an mbarrier a stage; a row of 72 bytes costs nothing
//    extra, the stage is contiguous), and each thread scores a whole row
//    from shared memory in 16- or 4-byte chunks, in order (row_dot_thread
//    says what that costs).  Wider rows keep a warp across two rows with 16-byte
//    loads from global memory (as full selection does).  Each block keeps
//    a running top-pow2(k) in shared memory and filters every key against
//    its running k-th key, whole 64-bit keys so that ties keep the lower
//    index: after the first ~1000 rows most rows cost one compare.  The
//    keys that pass go to a buffer, which is sorted and merged into the
//    running list only when it could overflow.  Each block writes its
//    sorted list to a scratch; the last block of the query row runs the
//    same filter over the row's lists read a column at a time (every
//    list's best keys first) and stops at the first column that offers
//    nothing: a few columns of the 261 lists at the caller's shape, where
//    merging all of them in one block cost more than the stream itself
//    (H100).  No [B, N] matrix exists.
#include <algorithm>

#include "common.cuh"

namespace ecp {

constexpr int kFullThreads = 512;
constexpr int kFullRows = kFullThreads / 16;  // rows a block scores (two a warp)

// ---------------------------------------------------------------- k >= N
// WIDE: rows and the query 16-byte aligned and D a multiple of 16 bytes'
// worth of elements (16-byte loads); else the scalar row loop.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(kFullThreads)
full_select_kernel(const T* __restrict__ q, const T* __restrict__ c, float* __restrict__ out_d,
                   int* __restrict__ out_i, unsigned long long* __restrict__ keys,
                   int* __restrict__ counters, int N, int D, int k, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long run[kFullRows];
  float* qs = reinterpret_cast<float*>(smem);
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float qq = load_query(q + static_cast<size_t>(b) * D, qs, D);
  const int j = 2 * warp, ra = blk * kFullRows + j, rb = ra + 1;
  if (ra < N) {
    float dot[2], cc[2];
    const T* rows[2] = {c + static_cast<size_t>(ra) * D, c + static_cast<size_t>(rb < N ? rb : ra) * D};
    if (WIDE) {
      rows_dot_wide<T, 2, 10>(rows, qs, D, lane, dot, cc);
    } else {
      row_dot<T>(rows[0], qs, D, 1.f, 0.f, lane, &dot[0], &cc[0]);
      row_dot<T>(rows[1], qs, D, 1.f, 0.f, lane, &dot[1], &cc[1]);
    }
    if (lane == 0) {
      run[j] = make_key(metric_of(metric, qq, dot[0], cc[0]), ra);
      run[j + 1] = rb < N ? make_key(metric_of(metric, qq, dot[1], cc[1]), rb) : kMaxKey;
    }
  } else if (lane == 0) {
    run[j] = run[j + 1] = kMaxKey;
  }
  __syncthreads();
  // the block's run sorted as the first steps of the row's bitonic sort
  // make it: ascending in even blocks, descending in odd ones
  warp_strides<false>(run, 1, 0, kFullRows, 2, kFullRows, blk * kFullRows);
  float* od = out_d + static_cast<size_t>(b) * k;
  int* oi = out_i + static_cast<size_t>(b) * k;
  if (nblk == 1) {
    write_topk(run, kFullRows, k, od, oi);
    return;
  }
  unsigned long long* row_keys = keys + static_cast<size_t>(b) * nblk * kFullRows;
  if (threadIdx.x < kFullRows) row_keys[blk * kFullRows + threadIdx.x] = run[threadIdx.x];
  if (!last_to_arrive(counters + b, nblk)) return;
  // the last block of the query row finishes the sort of its keys
  const int n2 = pow2_at_least(nblk * kFullRows);
  unsigned long long* sk = reinterpret_cast<unsigned long long*>(smem);
  load_keys(sk, row_keys, nblk * kFullRows, n2);
  __syncthreads();
  block_sort(sk, n2, 2 * kFullRows);
  write_topk(sk, n2, k, od, oi);
}

// ----------------------------------------------------------------- k < N
// Constants of the plan, as in ops.py (topk_split_plan).
constexpr int kNarrowD = 64;              // widths up to this: a thread scores whole rows
constexpr int kNarrowRows = kThreads;     // rows of a ring stage (one a thread)
constexpr int kWideRows = 2 * kWarps;     // rows a wide block scores between barriers
constexpr int kMaxStages = 4;
constexpr size_t kRingBytes = 96 * 1024;  // ring stages: as many as fit this, 2 to 4
constexpr int kBarBytes = 128;

struct SArgs {
  const void* q;
  const void* c;
  float* out_d;
  int* out_i;
  unsigned long long* lists;  // [B, nblk, K2]: each block's sorted keys
  int* counters;              // [B], 0 between launches
  int B, N, D, k, K2, metric;
  int nblk, rpb;              // chunks a query row, rows a chunk (a multiple of the stage rows)
  int cap;                    // keys the filter's buffer holds
  int stages;                 // ring stages (narrow)
  int bulk;                   // narrow: stages by bulk copies; wide: 16-byte row loads
};

// The end of the rows of the chunk that starts at r0.
__device__ __forceinline__ int rows_end(const SArgs& a, int r0) { return min(a.N, r0 + a.rpb); }

// Appends the keys of the lanes that pass to buf, one atomic a warp; every
// lane of the warp calls it.
__device__ __forceinline__ void append(bool pass, unsigned long long key, unsigned long long* buf, int* cnt) {
  const unsigned m = __ballot_sync(0xffffffffu, pass);
  if (!m) return;
  const int lane = threadIdx.x & 31, first = __ffs(m) - 1;
  int base = 0;
  if (lane == first) base = atomicAdd(cnt, __popc(m));
  base = __shfl_sync(0xffffffffu, base, first);
  if (pass) buf[base + __popc(m & ((1u << lane) - 1u))] = key;
}

// The running top-K2 keys[0, K2) takes in the n keys appended behind it:
// they are sorted (padded to a power of two >= K2), their first K2 merged
// with the running list, and the filter becomes the running k-th key.  All
// threads call it with the same n; it synchronises after.
__device__ void absorb(unsigned long long* keys, int K2, int k, int n, unsigned long long* thr, int* cnt) {
  unsigned long long* buf = keys + K2;
  const int n2 = max(K2, pow2_at_least(n));
  for (int j = n + threadIdx.x; j < n2; j += blockDim.x) buf[j] = kMaxKey;
  __syncthreads();
  block_sort(buf, n2);
  merge_sorted_lists(keys, 2, K2, K2);
  if (threadIdx.x == 0) {
    *thr = keys[k - 1];
    *cnt = 0;
  }
  __syncthreads();
}

// The block's sorted top-K2 (keys[0, K2)) into its list; the last block
// of the query row then finds the row's top-k with the same filter: it
// reads the row's lists a column at a time (every list's j-th key, kCols
// columns a load), offers each key to a running top-K2 of its own, and
// stops after the first column that offers nothing, since the lists
// ascend and the filter only tightens.  Read by columns, the first few
// hold every list's best keys, so the filter is tight after them and only
// those columns are read.
constexpr int kCols = 8;

__device__ void finish(const SArgs& a, unsigned long long* keys, unsigned long long* s_thr, int* s_cnt,
                       int b, int blk) {
  float* od = a.out_d + static_cast<size_t>(b) * a.k;
  int* oi = a.out_i + static_cast<size_t>(b) * a.k;
  const int K2 = a.K2, m = a.nblk, tid = threadIdx.x;
  if (m == 1) {
    write_topk(keys, K2, a.k, od, oi);
    return;
  }
  unsigned long long* lists = a.lists + static_cast<size_t>(b) * m * K2;
  for (int j = tid; j < K2; j += blockDim.x) lists[static_cast<size_t>(blk) * K2 + j] = keys[j];
  if (!last_to_arrive(a.counters + b, m)) return;
  for (int j = tid; j < K2; j += blockDim.x) keys[j] = kMaxKey;
  if (tid == 0) *s_cnt = 0;
  __syncthreads();
  unsigned long long thr = kMaxKey;
  int cnt = 0;
  const int U = (m + blockDim.x - 1) / blockDim.x;  // lists a thread reads
  for (int j0 = 0; j0 < K2; j0 += kCols) {
    int offered[kCols] = {};
    for (int u = 0; u < U; ++u) {
      const int l = tid + u * blockDim.x;
      const bool have = l < m;
      unsigned long long col[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        col[c] = have && j0 + c < K2 ? __ldcg(lists + static_cast<size_t>(l) * K2 + j0 + c) : kMaxKey;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const bool pass = col[c] < thr;
        append(pass, col[c], keys + K2, s_cnt);
        const int n = __syncthreads_count(pass);
        offered[c] += n;
        cnt += n;
        if (cnt > a.cap - static_cast<int>(blockDim.x)) {
          absorb(keys, K2, a.k, cnt, s_thr, s_cnt);
          thr = *s_thr;
          cnt = 0;
        }
      }
    }
    bool dry = false;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dry = dry || offered[c] == 0;
    if (dry) break;
  }
  if (cnt > 0) absorb(keys, K2, a.k, cnt, s_thr, s_cnt);
  write_topk(keys, K2, a.k, od, oi);
}

// VB bytes of a row in shared memory widened to float32 (VB / sizeof(T)
// values).
template <typename T, int VB> struct Chunk;
template <typename T> struct Chunk<T, 16> {
  static constexpr int E = 16 / sizeof(T);
  __device__ static void load(const unsigned char* p, float* out) {
    widen(*reinterpret_cast<const uint4*>(p), out, T());
  }
};
template <typename T> struct Chunk<T, 4> {
  static constexpr int E = 4 / sizeof(T);
  __device__ static void load(const unsigned char* p, float* out) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    if constexpr (sizeof(T) == 4) {
      out[0] = __uint_as_float(w);
    } else {
      const T* v = reinterpret_cast<const T*>(&w);
      out[0] = dec(v[0], 1.f, 0.f);
      out[1] = dec(v[1], 1.f, 0.f);
    }
  }
};
template <typename T> struct Chunk<T, 2> {
  static constexpr int E = 1;
  __device__ static void load(const unsigned char* p, float* out) {
    out[0] = dec(*reinterpret_cast<const T*>(p), 1.f, 0.f);
  }
};

// E query values (float32, shared memory, aligned to their size).
template <int E>
__device__ __forceinline__ void load_q(const float* p, float* y) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 t = reinterpret_cast<const float4*>(p)[i >> 2];
      y[i] = t.x; y[i + 1] = t.y; y[i + 2] = t.z; y[i + 3] = t.w;
    }
  } else if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    y[0] = t.x; y[1] = t.y;
  } else {
    y[0] = p[0];
  }
}

// One thread scores one row staged in shared memory: dot = <q, c> and cc =
// <c, c>, the row's nchunk chunks of VB bytes in order, so that equal rows
// get equal distances wherever they lie (and ties go by index).  The query
// chunk is the same address in every lane (a broadcast).  Rows 64 or 128
// bytes apart put a quarter-warp's chunks on one bank group, 4- or 8-way,
// but each row is read once, so the stream still leads.  Visiting the
// chunks from a per-thread start was faster at d = 32 on an H100 but gave
// equal rows distances a last bit apart; a group of lanes a row (a chunk
// each, a butterfly sum) was slower.
template <typename T, int VB>
__device__ __forceinline__ void row_dot_thread(const unsigned char* row, const float* qs, int nchunk,
                                               float* dot, float* cc) {
  constexpr int E = Chunk<T, VB>::E;
  float a = 0.f, b = 0.f;
#pragma unroll 4
  for (int ch = 0; ch < nchunk; ++ch) {
    float x[E], y[E];
    Chunk<T, VB>::load(row + ch * VB, x);
    load_q<E>(qs + ch * E, y);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      a = fmaf(y[e], x[e], a);
      b = fmaf(x[e], x[e], b);
    }
  }
  *dot = a;
  *cc = b;
}

// shared: barriers | query (f32) | keys: running top-K2, then the filter's
// buffer of cap | ring of `stages` stages of kNarrowRows rows.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
split_narrow_kernel(const SArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_thr;
  __shared__ int s_cnt;
  const int b = blockIdx.x % a.B, blk = blockIdx.x / a.B;
  const int D = a.D, K2 = a.K2, tid = threadIdx.x;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + kBarBytes);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + kBarBytes + align16(D * sizeof(float)));
  unsigned char* ring = reinterpret_cast<unsigned char*>(keys) + align16(static_cast<size_t>(K2 + a.cap) * 8);
  const size_t row_bytes = static_cast<size_t>(D) * sizeof(T);
  const size_t stage_bytes = kNarrowRows * row_bytes;
  const int r0 = blk * a.rpb, r_end = rows_end(a, r0);
  const int nst = (r_end - r0 + kNarrowRows - 1) / kNarrowRows;
  const unsigned char* src = static_cast<const unsigned char*>(a.c) + static_cast<size_t>(r0) * row_bytes;
  // the bytes of stage i the copy engine brings: all but a tail under 16
  auto bulk_bytes = [&](int i) {
    return static_cast<uint32_t>(min(kNarrowRows, r_end - r0 - i * kNarrowRows) * row_bytes) & ~15u;
  };
  auto load_stage = [&](int i) {
    const int slot = i % a.stages;
    const uint32_t bytes = bulk_bytes(i), bar = smem_u32(bars + slot);
    mbar_expect_tx(bar, bytes);
    if (bytes) bulk_load(smem_u32(ring + slot * stage_bytes), src + i * stage_bytes, bytes, bar);
  };
  if (a.bulk && tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(a.stages, nst); ++i) load_stage(i);
  }
  const float qq = load_query(static_cast<const T*>(a.q) + static_cast<size_t>(b) * D, qs, D);  // synchronises
  for (int j = tid; j < K2; j += kThreads) keys[j] = kMaxKey;
  if (tid == 0) {
    s_thr = kMaxKey;
    s_cnt = 0;
  }
  __syncthreads();
  unsigned long long thr = kMaxKey;
  int cnt = 0;  // keys in the buffer (the same in every thread)
  const int nchunk = static_cast<int>(row_bytes / VB);
  for (int i = 0; i < nst; ++i) {
    const int slot = a.bulk ? i % a.stages : 0;
    unsigned char* st = ring + slot * stage_bytes;
    const int rows = min(kNarrowRows, r_end - r0 - i * kNarrowRows);
    const size_t bytes = rows * row_bytes, done = a.bulk ? bulk_bytes(i) : 0;
    if (a.bulk) mbar_wait(smem_u32(bars + slot), (i / a.stages) & 1);
    if (done < bytes) {  // what the copy engine did not bring, by the threads
      const T* from = reinterpret_cast<const T*>(src + i * stage_bytes + done);
      T* to = reinterpret_cast<T*>(st + done);
      for (size_t j = tid; j < (bytes - done) / sizeof(T); j += kThreads) to[j] = from[j];
      __syncthreads();
    }
    bool pass = false;
    unsigned long long key = kMaxKey;
    if (tid < rows) {
      float dot, cc;
      row_dot_thread<T, VB>(st + tid * row_bytes, qs, nchunk, &dot, &cc);
      key = make_key(metric_of(a.metric, qq, dot, cc), r0 + i * kNarrowRows + tid);
      pass = key < thr;
    }
    append(pass, key, keys + K2, &s_cnt);
    cnt += __syncthreads_count(pass);  // also: every thread is done with the slot
    if (a.bulk && tid == 0 && i + a.stages < nst) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_stage(i + a.stages);
    }
    if (cnt > a.cap - kNarrowRows) {
      absorb(keys, K2, a.k, cnt, &s_thr, &s_cnt);
      thr = s_thr;
      cnt = 0;
    }
  }
  if (a.bulk && tid == 0)
    for (int s = 0; s < a.stages; ++s) mbar_inval(smem_u32(bars + s));
  if (cnt > 0) absorb(keys, K2, a.k, cnt, &s_thr, &s_cnt);
  finish(a, keys, &s_thr, &s_cnt, b, blk);
}

// Rows wider than kNarrowD: a warp scores two rows at a time from global
// memory (16-byte loads, ten steps of both rows in flight, when bulk), the
// running list and the filter as above.  shared: barriers (unused) | query
// | keys.
template <typename T>
__global__ void __launch_bounds__(kThreads)
split_wide_kernel(const SArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_thr;
  __shared__ int s_cnt;
  const int b = blockIdx.x % a.B, blk = blockIdx.x / a.B;
  const int D = a.D, K2 = a.K2, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = reinterpret_cast<float*>(smem + kBarBytes);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + kBarBytes + align16(D * sizeof(float)));
  const T* c = static_cast<const T*>(a.c);
  const int r0 = blk * a.rpb, r_end = rows_end(a, r0);
  const float qq = load_query(static_cast<const T*>(a.q) + static_cast<size_t>(b) * D, qs, D);  // synchronises
  for (int j = threadIdx.x; j < K2; j += kThreads) keys[j] = kMaxKey;
  if (threadIdx.x == 0) {
    s_thr = kMaxKey;
    s_cnt = 0;
  }
  __syncthreads();
  unsigned long long thr = kMaxKey;
  int cnt = 0;
  for (int base = r0; base < r_end; base += kWideRows) {
    const int ra = base + 2 * warp, rb = ra + 1;
    bool pass = false;
    unsigned long long key = kMaxKey;
    if (ra < r_end) {
      float dot[2], cc[2];
      const T* rows[2] = {c + static_cast<size_t>(ra) * D, c + static_cast<size_t>(rb < r_end ? rb : ra) * D};
      if (a.bulk) {
        rows_dot_wide<T, 2, 10>(rows, qs, D, lane, dot, cc);
      } else {
        row_dot<T>(rows[0], qs, D, 1.f, 0.f, lane, &dot[0], &cc[0]);
        row_dot<T>(rows[1], qs, D, 1.f, 0.f, lane, &dot[1], &cc[1]);
      }
      // lane 0 offers row a, lane 1 row b
      if (lane == 0) key = make_key(metric_of(a.metric, qq, dot[0], cc[0]), ra);
      if (lane == 1 && rb < r_end) key = make_key(metric_of(a.metric, qq, dot[1], cc[1]), rb);
      pass = lane < 2 && key < thr;
    }
    append(pass, key, keys + K2, &s_cnt);
    cnt += __syncthreads_count(pass);
    if (cnt > a.cap - kWideRows) {
      absorb(keys, K2, a.k, cnt, &s_thr, &s_cnt);
      thr = s_thr;
      cnt = 0;
    }
  }
  if (cnt > 0) absorb(keys, K2, a.k, cnt, &s_thr, &s_cnt);
  finish(a, keys, &s_thr, &s_cnt, b, blk);
}

template <typename T> constexpr int kDtypeSlot = 0;
template <> constexpr int kDtypeSlot<__half> = 1;
template <> constexpr int kDtypeSlot<__nv_bfloat16> = 2;

template <typename T, bool WIDE>
cudaError_t launch_full(const T* q, const T* c, float* od, int* oi, void* keys, void* counters,
                        int B, int N, int D, int k, int metric, cudaStream_t stream) {
  const int nblk = N > kFullRows ? (N + kFullRows - 1) / kFullRows : 1;
  const size_t sort_part = nblk > 1 ? static_cast<size_t>(pow2_at_least(nblk * kFullRows)) * 8 : 0;
  const size_t q_part = align16(D * sizeof(float));
  const size_t smem = q_part > sort_part ? q_part : sort_part;
  cudaError_t e = allow_smem(2 * kDtypeSlot<T> + WIDE,
                             reinterpret_cast<const void*>(full_select_kernel<T, WIDE>), smem);
  if (e != cudaSuccess) return e;
  full_select_kernel<T, WIDE><<<dim3(nblk, B), kFullThreads, smem, stream>>>(
      q, c, od, oi, static_cast<unsigned long long*>(keys), static_cast<int*>(counters), N, D, k,
      metric);
  return cudaGetLastError();
}

inline bool aligned_to(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <typename T>
cudaError_t launch_split(const T* q, const T* c, float* od, int* oi, void* lists, void* counters, int B,
                         int N, int D, int k, int metric, int nblk, cudaStream_t stream) {
  const bool narrow = D <= kNarrowD;
  const int R = narrow ? kNarrowRows : kWideRows;
  SArgs a{q, c, od, oi, static_cast<unsigned long long*>(lists), static_cast<int*>(counters),
          B, N, D, k, pow2_at_least(k), metric, nblk, 0, 0, 0, 0};
  a.cap = std::max(2 * a.K2, 4 * kNarrowRows);
  const size_t row_bytes = static_cast<size_t>(D) * sizeof(T);
  size_t smem = kBarBytes + align16(D * sizeof(float)) + align16(static_cast<size_t>(a.K2 + a.cap) * 8);
  if (narrow) {
    const size_t sb = kNarrowRows * row_bytes;
    a.stages = static_cast<int>(std::clamp(kRingBytes / sb, static_cast<size_t>(2), static_cast<size_t>(kMaxStages)));
    smem += a.stages * sb;
  }
  if (nblk < 1) return cudaErrorInvalidValue;
  a.rpb = ((N + nblk - 1) / nblk + R - 1) / R * R;
  if ((N + a.rpb - 1) / a.rpb != nblk) return cudaErrorInvalidValue;  // not topk_split_plan's
  a.bulk = aligned_to(c, 16);
  const void* kern;
  int slot;
  if (narrow) {
    if (row_bytes % 16 == 0) {
      kern = reinterpret_cast<const void*>(split_narrow_kernel<T, 16>), slot = 9 + 3 * kDtypeSlot<T>;
    } else if (row_bytes % 4 == 0 || sizeof(T) == 4) {
      kern = reinterpret_cast<const void*>(split_narrow_kernel<T, 4>), slot = 10 + 3 * kDtypeSlot<T>;
    } else {
      kern = reinterpret_cast<const void*>(split_narrow_kernel<T, sizeof(T) == 4 ? 4 : 2>), slot = 11 + 3 * kDtypeSlot<T>;
    }
  } else {
    a.bulk = a.bulk && D % Wide<T>::W == 0;
    kern = reinterpret_cast<const void*>(split_wide_kernel<T>), slot = 6 + kDtypeSlot<T>;
  }
  cudaError_t e = allow_smem(slot, kern, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  return cudaLaunchKernel(kern, dim3(B * nblk), dim3(kThreads), args, smem, stream);
}

template <typename T>
cudaError_t launch_any(const void* qv, const void* cv, void* out_d, void* out_i, void* keys,
                       void* counters, int B, int N, int D, int k, int metric, int nblk,
                       cudaStream_t stream) {
  const T* q = static_cast<const T*>(qv);
  const T* c = static_cast<const T*>(cv);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  if (k >= N) {
    constexpr int W = Wide<T>::W;
    if (aligned_to(q, 16) && aligned_to(c, 16) && D % W == 0)
      return launch_full<T, true>(q, c, od, oi, keys, counters, B, N, D, k, metric, stream);
    return launch_full<T, false>(q, c, od, oi, keys, counters, B, N, D, k, metric, stream);
  }
  return launch_split<T>(q, c, od, oi, keys, counters, B, N, D, k, metric, nblk, stream);
}

}  // namespace ecp

extern "C" {

// Largest dynamic shared memory a block may opt in to (bytes).
int distance_topk_smem_optin() { return ecp::smem_optin(); }

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  metric: 0 = l2, 1 = ip,
// 2 = cosine.  keys: room for B * ceil(N / 32) * 32 8-byte keys when
// k >= N, for B * nblk * pow2(k) when k < N; counters: B ints, all 0 (every
// launch leaves them 0).  nblk: blocks a query row of the k < N path, as
// ops.topk_split_plan gives it (ignored when k >= N).  Returns a
// cudaError_t (0 on success).
int distance_topk_launch(const void* q, const void* c, void* out_d, void* out_i, void* keys,
                         void* counters, int B, int N, int D, int k, int metric, int dtype,
                         int nblk, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (N < 0 || D <= 0 || metric < 0 || metric > 2) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ecp::launch_any<float>(q, c, out_d, out_i, keys, counters, B, N, D, k, metric, nblk, st);
  if (dtype == 1)
    return ecp::launch_any<__half>(q, c, out_d, out_i, keys, counters, B, N, D, k, metric, nblk, st);
  if (dtype == 2)
    return ecp::launch_any<__nv_bfloat16>(q, c, out_d, out_i, keys, counters, B, N, D, k, metric, nblk, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
