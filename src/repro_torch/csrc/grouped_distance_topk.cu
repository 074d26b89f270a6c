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
// units, a 455-row leaf, D=1152, int8) the codes are ~67 MB and the work is
// ~2 int8 operations a byte, far below the ~590 the card needs before the
// arithmetic is the limit, so the least time is the codes over the memory
// rate (~20 us at 3.35 TB/s).  The codes come from the host every round, so
// end to end the host-to-device copy of the same bytes (over PCIe) costs
// more than the kernel: the caller stages them through one pinned buffer
// and times that copy apart.
//
// Design: one thread block per group (a round has ~G=128 units, about one
// wave on 132 SMs).  Warps stride over the rows, lanes over D with 4-byte
// vector loads (a warp reads 128 contiguous bytes per load), the dot
// product and the row norm accumulate in float32 registers and reduce by
// warp shuffles, so the decoded rows never exist outside registers.  Each
// row's distance becomes a 64-bit (distance, row) key in shared memory;
// one block-wide bitonic sort over the next power of two >= n_rows[g]
// orders them, which gives ties to the lower row without a k-step
// extraction, for any k (k grows with every next(k) and can reach the
// leaf size).  The leaf size is bounded only by shared memory: 8 bytes a
// row plus the query (the wrapper raises above that limit).
// Later work: split large groups over several blocks, TMA row tiles.
#include "common.cuh"

namespace ecp {

template <typename CodeT, bool VEC>
__global__ void __launch_bounds__(kThreads)
grouped_topk_kernel(const float* __restrict__ q, const CodeT* __restrict__ codes,
                    const float* __restrict__ scales, const float* __restrict__ offsets,
                    const int* __restrict__ n_rows, float* __restrict__ out_d,
                    int* __restrict__ out_i, int N, int D, int k, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + align16(D * sizeof(float)));
  const int g = blockIdx.x;
  const int n = min(max(n_rows[g], 0), N);
  const int n2 = pow2_at_least(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const float qq = load_query(q + static_cast<size_t>(g) * D, qs, D);
  const float s = scales[g], o = offsets[g];
  const CodeT* cg = codes + static_cast<size_t>(g) * N * D;
  for (int r = warp; r < n; r += kWarps) {
    float dot, cc;
    row_dot<CodeT, VEC>(cg + static_cast<size_t>(r) * D, qs, D, s, o, lane, &dot, &cc);
    if (lane == 0) keys[r] = make_key(metric_of(metric, qq, dot, cc), r);
  }
  for (int r = n + threadIdx.x; r < n2; r += blockDim.x) keys[r] = kMaxKey;
  __syncthreads();
  bitonic_sort(keys, n2);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float dv = INFINITY;
    int iv = -1;
    if (j < n) key_out(keys[j], &dv, &iv);
    out_d[static_cast<size_t>(g) * k + j] = dv;
    out_i[static_cast<size_t>(g) * k + j] = iv;
  }
}

template <typename CodeT, bool VEC>
cudaError_t launch(const void* q, const void* codes, const void* scales, const void* offsets,
                   const void* n_rows, void* out_d, void* out_i, int G, int N, int D, int k,
                   int metric, cudaStream_t stream) {
  const size_t smem = align16(D * sizeof(float)) + static_cast<size_t>(pow2_at_least(N)) * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(grouped_topk_kernel<CodeT, VEC>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  grouped_topk_kernel<CodeT, VEC><<<G, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const CodeT*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(offsets),
      static_cast<const int*>(n_rows), static_cast<float*>(out_d), static_cast<int*>(out_i), N,
      D, k, metric);
  return cudaGetLastError();
}

}  // namespace ecp

extern "C" {

// Largest dynamic shared memory a block may opt in to (bytes).
int grouped_smem_optin() { return ecp::smem_optin(); }

// qformat: 0 = int8, 1 = float16.  metric: 0 = l2, 1 = ip, 2 = cosine.
// All pointers are device pointers of contiguous tensors; returns a
// cudaError_t (0 on success).
int grouped_distance_topk_launch(const void* q, const void* codes, const void* scales,
                                 const void* offsets, const void* n_rows, void* out_d,
                                 void* out_i, int G, int N, int D, int k, int metric,
                                 int qformat, void* stream) {
  if (G <= 0 || k <= 0) return 0;
  if (N < 0 || D <= 0 || metric < 0 || metric > 2) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) % 4) == 0;
  if (qformat == 0) {
    if (aligned && D % 4 == 0)
      return ecp::launch<int8_t, true>(q, codes, scales, offsets, n_rows, out_d, out_i, G, N, D,
                                       k, metric, st);
    return ecp::launch<int8_t, false>(q, codes, scales, offsets, n_rows, out_d, out_i, G, N, D,
                                      k, metric, st);
  }
  if (qformat == 1) {
    if (aligned && D % 2 == 0)
      return ecp::launch<__half, true>(q, codes, scales, offsets, n_rows, out_d, out_i, G, N, D,
                                       k, metric, st);
    return ecp::launch<__half, false>(q, codes, scales, offsets, n_rows, out_d, out_i, G, N, D,
                                      k, metric, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
