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
// byte, ~0.7-1.4 us at 3.35 TB/s.  At a large-batch shape (B=128,
// N=65536, k=100) operations: 19 GFLOP at the 67 TFLOP/s of float32
// outside the tensor cores, ~0.29 ms, against 0.09 ms for the bytes.
//
// Design, two paths:
//  * k >= N (full selection): no running top-k at all.  A distance kernel
//    spreads the candidate rows over many blocks (64 rows a block, a warp a
//    row, lanes over D with 16-byte loads) so that a single query row still
//    draws on every SM's share of the memory rate, and writes the [B, N]
//    distances to a scratch buffer; a second kernel sorts each row's
//    (distance, index) keys in shared memory with one bitonic sort and
//    writes them out.  N is bounded by the shared memory of one block
//    (16384 rows on an H100; the wrapper raises above that).
//  * k < N: one block per query row walks the candidates in tiles.  A tile's
//    keys land in shared memory behind the running top-k (the next power of
//    two >= k) and one bitonic sort of both keeps the smallest in front:
//    the [B, N] matrix never exists.  Every block reads all of c, so this
//    path leans on the L2 cache; sharing candidate tiles between query rows
//    (and wgmma for the products) is later work.
#include "common.cuh"

namespace ecp {

constexpr int kRowsPerBlock = 64;

// ---------------------------------------------------------------- k >= N
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dist_rows_kernel(const T* __restrict__ q, const T* __restrict__ c, float* __restrict__ dist,
                 int N, int D, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float qq = load_query(q + static_cast<size_t>(b) * D, qs, D);
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, N);
  for (int r = r0 + warp; r < r1; r += kWarps) {
    float dot, cc;
    row_dot<T, VEC>(c + static_cast<size_t>(r) * D, qs, D, 1.f, 0.f, lane, &dot, &cc);
    if (lane == 0) dist[static_cast<size_t>(b) * N + r] = metric_of(metric, qq, dot, cc);
  }
}

__global__ void __launch_bounds__(1024)
sort_rows_kernel(const float* __restrict__ dist, float* __restrict__ out_d,
                 int* __restrict__ out_i, int N, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  const int b = blockIdx.x;
  const int n2 = pow2_at_least(N);
  for (int r = threadIdx.x; r < n2; r += blockDim.x)
    keys[r] = r < N ? make_key(dist[static_cast<size_t>(b) * N + r], r) : kMaxKey;
  __syncthreads();
  bitonic_sort(keys, n2);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float dv = INFINITY;
    int iv = -1;
    if (j < N) key_out(keys[j], &dv, &iv);
    out_d[static_cast<size_t>(b) * k + j] = dv;
    out_i[static_cast<size_t>(b) * k + j] = iv;
  }
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
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float dv;
    int iv;
    key_out(keys[j], &dv, &iv);
    out_d[static_cast<size_t>(b) * k + j] = dv;
    out_i[static_cast<size_t>(b) * k + j] = iv;
  }
}

inline cudaError_t allow_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, bool VEC>
cudaError_t launch(const void* qv, const void* cv, void* out_d, void* out_i, void* scratch,
                   int B, int N, int D, int k, int metric, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qv);
  const T* c = static_cast<const T*>(cv);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  if (k >= N) {
    if (N > 0) {
      const size_t smem_d = align16(D * sizeof(float));
      cudaError_t e = allow_smem(reinterpret_cast<const void*>(dist_rows_kernel<T, VEC>), smem_d);
      if (e != cudaSuccess) return e;
      dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, B);
      dist_rows_kernel<T, VEC><<<grid, kThreads, smem_d, stream>>>(
          q, c, static_cast<float*>(scratch), N, D, metric);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    const size_t smem_s = static_cast<size_t>(pow2_at_least(N > 0 ? N : 1)) * 8;
    cudaError_t e = allow_smem(reinterpret_cast<const void*>(sort_rows_kernel), smem_s);
    if (e != cudaSuccess) return e;
    sort_rows_kernel<<<B, 1024, smem_s, stream>>>(static_cast<const float*>(scratch), od, oi, N,
                                                  k);
    return cudaGetLastError();
  }
  const int K2 = pow2_at_least(k);
  const int S = 2 * (K2 > 256 ? K2 : 256);
  const size_t smem = align16(D * sizeof(float)) + static_cast<size_t>(S) * 8;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(topk_merge_kernel<T, VEC>), smem);
  if (e != cudaSuccess) return e;
  topk_merge_kernel<T, VEC><<<B, kThreads, smem, stream>>>(q, c, od, oi, N, D, k, K2, S, metric);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* q, const void* c, void* out_d, void* out_i, void* scratch,
                       int B, int N, int D, int k, int metric, cudaStream_t stream) {
  constexpr int W = Vec<T>::W;
  const bool aligned = (reinterpret_cast<uintptr_t>(c) % (W * sizeof(T))) == 0 &&
                       (reinterpret_cast<uintptr_t>(q) % (W * sizeof(T))) == 0;
  if (aligned && D % W == 0)
    return launch<T, true>(q, c, out_d, out_i, scratch, B, N, D, k, metric, stream);
  return launch<T, false>(q, c, out_d, out_i, scratch, B, N, D, k, metric, stream);
}

}  // namespace ecp

extern "C" {

// Largest dynamic shared memory a block may opt in to (bytes).
int distance_topk_smem_optin() { return ecp::smem_optin(); }

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  metric: 0 = l2, 1 = ip,
// 2 = cosine.  scratch: B*N float32 on the device, used when k >= N.
// Returns a cudaError_t (0 on success).
int distance_topk_launch(const void* q, const void* c, void* out_d, void* out_i, void* scratch,
                         int B, int N, int D, int k, int metric, int dtype, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (N < 0 || D <= 0 || metric < 0 || metric > 2) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ecp::launch_any<float>(q, c, out_d, out_i, scratch, B, N, D, k, metric, st);
  if (dtype == 1) return ecp::launch_any<__half>(q, c, out_d, out_i, scratch, B, N, D, k, metric, st);
  if (dtype == 2)
    return ecp::launch_any<__nv_bfloat16>(q, c, out_d, out_i, scratch, B, N, D, k, metric, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
