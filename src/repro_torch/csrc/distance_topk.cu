// Fused distance + top-k over one candidate set: q [B, D] against c [N, D]
// (float32, bfloat16 or float16), float32 accumulation, ascending k
// smallest (distance, index) per query row with ties to the lower index,
// (inf, -1) for entries with no candidate.
//
// Replaces: src/repro/kernels/distance_topk/distance_topk.py ::
//   distance_topk_pallas (bodies _kernel and _merge_topk).  On this slice's
//   path its caller is the leaf scorer make_kernel_scorer
//   (src/repro/core/search.py:212-232), which asks for full selection
//   (k == N_pad, N_pad a multiple of 512).  The TPU kernel returns a stale
//   id for padded entries; this one returns (inf, -1) there.
//
// What bounds it on an H100: at the scorer's shape (B=1, N_pad=512 or
// 1024, D=1152, float32) bytes: 2-4.7 MB of candidates, 0.5 operations a
// byte, ~0.7-1.4 us at 3.35 TB/s, well below the few microseconds a launch
// and a sort take, so the scorer's 1224 calls a search are bound by
// launches and the host.  At a large-batch shape (B=128, N=65536, k=100)
// operations: 19 GFLOP at the 67 TFLOP/s of float32 outside the tensor
// cores, ~0.29 ms, against 0.09 ms for the bytes.
//
// Design, two paths:
//  * k >= N (full selection): ONE launch.  Blocks of kFullRows = 32 rows
//    (16 blocks a query row at N_pad=512, so one row still draws on many
//    SMs' share of the memory rate) score their rows, a warp two rows at a
//    time with 16-byte loads, ten steps of both rows in flight (a whole
//    1152-wide float32 row a lane-step).  Each block sorts its 32 keys in
//    registers as the first steps of the row's bitonic sort (ascending in
//    even blocks, descending in odd ones) and writes them to a scratch; the
//    last block of the query row to finish (an atomic counter it resets)
//    reads them all back and finishes the bitonic sort in shared memory
//    (common.cuh block_sort: strides of 64 and more with a barrier each,
//    the smaller ones in registers) and writes the row out.  N is bounded
//    by the shared memory of that sort, 8 bytes a key (16384 rows on an
//    H100; the wrapper raises above that).  No [B, N] distance matrix
//    exists.
//  * k < N: one block per query row walks the candidates in tiles.  A tile's
//    keys land in shared memory behind the running top-k (the next power of
//    two >= k) and one bitonic sort of both keeps the smallest in front:
//    the [B, N] matrix never exists.  Every block reads all of c, so this
//    path leans on the L2 cache; sharing candidate tiles between query rows
//    (and wgmma for the products) is later work.
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
      row_dot<T, false>(rows[0], qs, D, 1.f, 0.f, lane, &dot[0], &cc[0]);
      row_dot<T, false>(rows[1], qs, D, 1.f, 0.f, lane, &dot[1], &cc[1]);
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
// shared: query (float32) | keys[S]: running top-K2 in [0, K2), tile in
// [K2, S), S = 2 * max(K2, 256).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const T* __restrict__ q, const T* __restrict__ c, float* __restrict__ out_d,
                  int* __restrict__ out_i, int N, int D, int k, int K2, int S, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + align16(D * sizeof(float)));
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T_rows = S - K2;
  const float qq = load_query(q + static_cast<size_t>(b) * D, qs, D);
  for (int j = threadIdx.x; j < K2; j += blockDim.x) keys[j] = kMaxKey;
  for (int base = 0; base < N; base += T_rows) {
    for (int t = warp; t < T_rows; t += kWarps) {
      const int r = base + t;
      if (r < N) {
        float dot, cc;
        row_dot<T, VEC>(c + static_cast<size_t>(r) * D, qs, D, 1.f, 0.f, lane, &dot, &cc);
        if (lane == 0) keys[K2 + t] = make_key(metric_of(metric, qq, dot, cc), r);
      } else if (lane == 0) {
        keys[K2 + t] = kMaxKey;
      }
    }
    __syncthreads();
    bitonic_sort(keys, S);
  }
  write_topk(keys, K2, k, out_d + static_cast<size_t>(b) * k, out_i + static_cast<size_t>(b) * k);
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

template <typename T, bool VEC>
cudaError_t launch_merge(const T* q, const T* c, float* od, int* oi, int B, int N, int D, int k,
                         int metric, cudaStream_t stream) {
  const int K2 = pow2_at_least(k);
  const int S = 2 * (K2 > 256 ? K2 : 256);
  const size_t smem = align16(D * sizeof(float)) + static_cast<size_t>(S) * 8;
  cudaError_t e = allow_smem(8 + 2 * kDtypeSlot<T> + VEC,
                             reinterpret_cast<const void*>(topk_merge_kernel<T, VEC>), smem);
  if (e != cudaSuccess) return e;
  topk_merge_kernel<T, VEC><<<B, kThreads, smem, stream>>>(q, c, od, oi, N, D, k, K2, S, metric);
  return cudaGetLastError();
}

inline bool aligned_to(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <typename T>
cudaError_t launch_any(const void* qv, const void* cv, void* out_d, void* out_i, void* keys,
                       void* counters, int B, int N, int D, int k, int metric, cudaStream_t stream) {
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
  constexpr int W = Vec<T>::W;
  if (aligned_to(q, W * sizeof(T)) && aligned_to(c, W * sizeof(T)) && D % W == 0)
    return launch_merge<T, true>(q, c, od, oi, B, N, D, k, metric, stream);
  return launch_merge<T, false>(q, c, od, oi, B, N, D, k, metric, stream);
}

}  // namespace ecp

extern "C" {

// Largest dynamic shared memory a block may opt in to (bytes).
int distance_topk_smem_optin() { return ecp::smem_optin(); }

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  metric: 0 = l2, 1 = ip,
// 2 = cosine.  Full selection (k >= N) only: keys, room for
// B * ceil(N / 32) * 32 8-byte keys; counters, B ints, all 0 (every launch
// leaves them 0).  Returns a
// cudaError_t (0 on success).
int distance_topk_launch(const void* q, const void* c, void* out_d, void* out_i, void* keys,
                         void* counters, int B, int N, int D, int k, int metric, int dtype,
                         void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (N < 0 || D <= 0 || metric < 0 || metric > 2) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ecp::launch_any<float>(q, c, out_d, out_i, keys, counters, B, N, D, k, metric, st);
  if (dtype == 1)
    return ecp::launch_any<__half>(q, c, out_d, out_i, keys, counters, B, N, D, k, metric, st);
  if (dtype == 2)
    return ecp::launch_any<__nv_bfloat16>(q, c, out_d, out_i, keys, counters, B, N, D, k, metric, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
