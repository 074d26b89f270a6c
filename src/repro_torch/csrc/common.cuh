// Shared device helpers of the two distance kernels (distance_topk.cu,
// grouped_distance_topk.cu): the order-preserving (distance, index) sort
// key, a block-wide bitonic sort over keys in shared memory, a warp sum,
// and the per-row scoring loop (warp over one row, lanes over D).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ecp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kMaxKey = ~0ull;

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };

// float -> uint32 whose unsigned order is the float order (negative
// floats flip all bits, non-negative ones flip the sign bit)
__device__ __forceinline__ unsigned int ord_of(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned int o) {
  unsigned int u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

// (distance, index) in one 64-bit key: ascending keys are ascending
// distances with ties to the lower index.  -0.0 is folded into +0.0 so
// that equal distances tie on the index as they do in a stable sort.
__device__ __forceinline__ unsigned long long make_key(float d, int idx) {
  if (d == 0.0f) d = 0.0f;
  return (static_cast<unsigned long long>(ord_of(d)) << 32) |
         static_cast<unsigned int>(idx);
}

// Decode one sort key into the output pair; anything that is not a finite
// distance (a masked row's inf, the kMaxKey pad, NaN) comes out (inf, -1).
__device__ __forceinline__ void key_out(unsigned long long key, float* d, int* i) {
  float x = float_of(static_cast<unsigned int>(key >> 32));
  if (x < INFINITY) {
    *d = x;
    *i = static_cast<int>(key & 0xffffffffu);
  } else {
    *d = INFINITY;
    *i = -1;
  }
}

// Ascending bitonic sort of n (a power of two) keys in shared memory by
// the whole block.  Callers synchronise before; it synchronises after.
__device__ void bitonic_sort(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        int i = 2 * stride * (t / stride) + (t % stride);
        int j = i + stride;
        bool asc = (i & size) == 0;
        unsigned long long x = a[i], y = a[j];
        if ((x > y) == asc) {
          a[i] = y;
          a[j] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- element decode: int8 codes dequantize as code*scale + offset (two
// roundings, as the host decode does), float16/bfloat16 widen, float32 is
// itself
__device__ __forceinline__ float dec(int8_t c, float s, float o) {
  return __fadd_rn(__fmul_rn(static_cast<float>(c), s), o);
}
__device__ __forceinline__ float dec(__half c, float, float) { return __half2float(c); }
__device__ __forceinline__ float dec(__nv_bfloat16 c, float, float) { return __bfloat162float(c); }
__device__ __forceinline__ float dec(float c, float, float) { return c; }

// Vector loads: 4 bytes a lane for the 1- and 2-byte types, 16 for float32.
template <typename T> struct Vec;
template <> struct Vec<int8_t> {
  using V = char4;
  static constexpr int W = 4;
};
template <> struct Vec<__half> {
  using V = __half2;
  static constexpr int W = 2;
};
template <> struct Vec<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static constexpr int W = 2;
};
template <> struct Vec<float> {
  using V = float4;
  static constexpr int W = 4;
};

__device__ __forceinline__ void dec_vec(char4 v, float s, float o, float* out) {
  out[0] = dec(static_cast<int8_t>(v.x), s, o);
  out[1] = dec(static_cast<int8_t>(v.y), s, o);
  out[2] = dec(static_cast<int8_t>(v.z), s, o);
  out[3] = dec(static_cast<int8_t>(v.w), s, o);
}
__device__ __forceinline__ void dec_vec(__half2 v, float, float, float* out) {
  float2 f = __half22float2(v);
  out[0] = f.x;
  out[1] = f.y;
}
__device__ __forceinline__ void dec_vec(__nv_bfloat162 v, float, float, float* out) {
  float2 f = __bfloat1622float2(v);
  out[0] = f.x;
  out[1] = f.y;
}
__device__ __forceinline__ void dec_vec(float4 v, float, float, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// One warp scores one row: dot = <q, c> and cc = <c, c>, float32
// accumulation, every lane gets both sums.  qs is the query in shared
// memory (float32, 16-byte aligned).  VEC: D is a multiple of the vector
// width and the rows are aligned to it.
template <typename T, bool VEC>
__device__ __forceinline__ void row_dot(const T* __restrict__ row, const float* qs, int D,
                                        float s, float o, int lane, float* dot, float* cc) {
  float a = 0.f, b = 0.f;
  if (VEC) {
    constexpr int W = Vec<T>::W;
    using V = typename Vec<T>::V;
    const V* rv = reinterpret_cast<const V*>(row);
    const int nv = D / W;
#pragma unroll 4
    for (int v = lane; v < nv; v += 32) {
      float c[W], x[W];
      dec_vec(__ldg(rv + v), s, o, c);
      // the query slice as one 8- or 16-byte shared load (no bank conflicts)
      if constexpr (W == 4) {
        float4 t = reinterpret_cast<const float4*>(qs)[v];
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
      } else {
        float2 t = reinterpret_cast<const float2*>(qs)[v];
        x[0] = t.x; x[1] = t.y;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        a = fmaf(x[w], c[w], a);
        b = fmaf(c[w], c[w], b);
      }
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      float c = dec(row[d], s, o);
      a = fmaf(qs[d], c, a);
      b = fmaf(c, c, b);
    }
  }
  *dot = warp_sum(a);
  *cc = warp_sum(b);
}

// The three metrics from the row sums, as the TPU kernels compute them
// (cosine normalizes both sides with rsqrt(sum(x*x) + 1e-12)).
__device__ __forceinline__ float metric_of(int metric, float qq, float dot, float cc) {
  if (metric == kL2) return qq + cc - 2.0f * dot;
  if (metric == kIP) return -dot;
  return 1.0f - dot * rsqrtf(qq + 1e-12f) * rsqrtf(cc + 1e-12f);
}

// Block-wide: load one float32 query row of type T into shared memory,
// then every warp computes qq = <q, q> for itself.
template <typename T>
__device__ __forceinline__ float load_query(const T* __restrict__ q, float* qs, int D) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) qs[d] = dec(q[d], 1.f, 0.f);
  __syncthreads();
  float a = 0.f;
  for (int d = threadIdx.x & 31; d < D; d += 32) a = fmaf(qs[d], qs[d], a);
  return warp_sum(a);
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

inline int smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

}  // namespace ecp
