// Shared device helpers of the two distance kernels (distance_topk.cu,
// grouped_distance_topk.cu): the order-preserving (distance, index) sort
// key, a block-wide bitonic sort and a merge of sorted key lists in shared
// memory (stages below stride 64 in registers), the "last block of a
// group" handshake, a warp sum, the per-row
// scoring loops (global memory, and rows staged in shared memory), and the
// mbarrier / bulk-copy primitives of the kernels' rings.
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

// One warp scores one row: dot = <q, c> and cc = <c, c>, float32
// accumulation, every lane gets both sums.  qs is the query in shared
// memory (float32).  Any width and alignment: an element a lane-step (the
// rows that allow 16-byte loads take rows_dot_wide or rows_dot_smem).
template <typename T>
__device__ __forceinline__ void row_dot(const T* __restrict__ row, const float* qs, int D,
                                        float s, float o, int lane, float* dot, float* cc) {
  float a = 0.f, b = 0.f;
  for (int d = lane; d < D; d += 32) {
    float c = dec(row[d], s, o);
    a = fmaf(qs[d], c, a);
    b = fmaf(c, c, b);
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

// ---- sorting and merging keys in shared memory, whole block.  Stages of
// stride 64 and more go through shared memory with a barrier each; the
// strides below 64 of a step run in registers, a warp per 64-key chunk
// (lane l holds chunk elements l and l + 32), with shuffles and no barrier.

// The merge's key order: whole 64-bit keys, so that of two equal distances
// the lower index stays in front.
__device__ __forceinline__ bool merge_less(unsigned long long a, unsigned long long b) {
  return a < b;
}

template <bool kMerge>
__device__ __forceinline__ bool key_less(unsigned long long a, unsigned long long b) {
  return kMerge ? merge_less(a, b) : (a < b);
}

// One compare-exchange of the pair (i, j), i < j: ascending (the smaller
// key at i) or descending.
template <bool kMerge>
__device__ __forceinline__ void cswap(unsigned long long* a, int i, int j, bool asc) {
  const unsigned long long x = a[i], y = a[j];
  if (key_less<kMerge>(y, x) == asc) {
    a[i] = y;
    a[j] = x;
  }
}

// In registers: for each step size = size_lo, 2*size_lo, .., size_hi, the
// strides min(size/2, 32, len/2) .. 1 over cnt segments of len keys (a
// power of two), segment i at a + i*stride; a pair (e, e + s) ascends when
// (e & size) == 0, e the index inside the segment plus e0.  Synchronises
// after.
template <bool kMerge>
__device__ void warp_strides(unsigned long long* a, int cnt, size_t stride, int len, int size_lo,
                             int size_hi, int e0 = 0) {
  const int lane = threadIdx.x & 31;
  const int cl = len < 64 ? len : 64, per = len / cl;
  for (int c = threadIdx.x >> 5; c < cnt * per; c += blockDim.x >> 5) {
    const int off = (c % per) * cl;
    unsigned long long* p = a + (c / per) * stride + off;
    const int e = e0 + off;
    unsigned long long v0 = lane < cl ? p[lane] : kMaxKey;
    unsigned long long v1 = 32 + lane < cl ? p[32 + lane] : kMaxKey;
    for (int size = size_lo;; size <<= 1) {
      for (int s = min(min(size >> 1, 32), cl >> 1); s > 0; s >>= 1) {
        if (s == 32) {  // both elements in this lane
          const bool asc = ((e + lane) & size) == 0;
          if (key_less<kMerge>(v1, v0) == asc) {
            const unsigned long long t = v0;
            v0 = v1;
            v1 = t;
          }
          continue;
        }
        const bool lower = (lane & s) == 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          unsigned long long& v = r ? v1 : v0;
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, s);
          const unsigned long long x = lower ? v : o, y = lower ? o : v;  // the pair, in order
          const bool asc = ((e + 32 * r + lane) & size) == 0;
          const bool swap = key_less<kMerge>(y, x) == asc;
          v = (lower != swap) ? x : y;
        }
      }
      if (size >= size_hi) break;
    }
    if (lane < cl) p[lane] = v0;
    if (32 + lane < cl) p[32 + lane] = v1;
  }
  __syncthreads();
}

// Ascending sort of n keys (a power of two) in shared memory by the whole
// block, the bitonic steps from size `from` on: the runs of from/2 keys
// must already be sorted, ascending and descending in turn (from = 2: no
// order asked).  Callers synchronise before; it synchronises after.
__device__ void block_sort(unsigned long long* a, int n, int from = 2) {
  if (from <= 64 && from <= n) warp_strides<false>(a, 1, 0, n, from, n < 64 ? n : 64);
  for (int size = from > 128 ? from : 128; size <= n; size <<= 1) {
    for (int s = size >> 1; s >= 64; s >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = ((t & ~(s - 1)) << 1) | (t & (s - 1));
        cswap<false>(a, i, i + s, (i & size) == 0);
      }
      __syncthreads();
    }
    warp_strides<false>(a, 1, 0, n, size, size);
  }
}

// m (a power of two) ascending lists of P keys each, list t at a + t*P,
// merged pairwise by the whole block into the ascending smallest
// min(m*P, cap) keys at a[0..) (P and cap powers of two, cap >= P).  Each
// round pairs lists A and B: a "flip" (A[j] against B[L-1-j]) leaves A and
// B bitonic with every key of A below every key of B, and half-cleaners
// then sort A, and B too while the merged length stays within cap (B then
// directly follows A, so the two make one sorted list of 2L).  Callers
// synchronise before; it synchronises after.
__device__ void merge_sorted_lists(unsigned long long* a, int m, int P, int cap) {
  int L = P;
  for (int span = P; span < m * P; span <<= 1) {
    const int pairs = (m * P) / (2 * span);
    const int lg = __ffs(L) - 1;
    for (int t = threadIdx.x; t < (pairs << lg); t += blockDim.x) {
      unsigned long long* A = a + static_cast<size_t>(t >> lg) * 2 * span;
      const int j = t & (L - 1);
      cswap<true>(A, j, span + L - 1 - j, true);
    }
    __syncthreads();
    const int two = 2 * L <= cap;  // 1: B is kept (and sorted) too
    // compare-exchanges a stage: L/2 in each half-list kept
    const int lgp = lg > 0 ? lg - 1 : 0, n = L > 1 ? pairs << (lgp + two) : 0;
    for (int s = L >> 1; s >= 64; s >>= 1) {
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int h = t >> lgp, u = t & ((L >> 1) - 1);
        unsigned long long* X = a + static_cast<size_t>(h >> two) * 2 * span + (h & two) * span;
        const int i = ((u & ~(s - 1)) << 1) | (u & (s - 1));
        cswap<true>(X, i, i + s, true);
      }
      __syncthreads();
    }
    if (L > 1) {  // strides below 64, all ascending: each kept half-list a segment
      const int segs = pairs << two;
      if (two)
        warp_strides<true>(a, segs, span, L, 1 << 30, 1 << 30);
      else
        warp_strides<true>(a, segs, 2 * span, L, 1 << 30, 1 << 30);
    }
    L <<= two;
  }
}

// Every block of a group calls this after writing its part to global
// memory; it returns true in exactly one of them, the last to arrive,
// which then sees every part.  That block resets the counter, so the next
// launch on the stream finds it at 0 again.
__device__ bool last_to_arrive(int* counter, int blocks) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == blocks - 1;
    if (last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// n keys from global memory (written by other blocks: read past L1) into
// shared memory, kMaxKey from n to n2; eight loads a thread in flight.
__device__ __forceinline__ void load_keys(unsigned long long* __restrict__ dst,
                                          const unsigned long long* __restrict__ src, int n, int n2) {
  for (int j0 = 0; j0 < n2; j0 += 8 * blockDim.x) {
    unsigned long long v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * blockDim.x + threadIdx.x;
      v[u] = j < n ? __ldcg(src + j) : kMaxKey;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * blockDim.x + threadIdx.x;
      if (j < n2) dst[j] = v[u];
    }
  }
}

// Writes k outputs of one row from the L ascending keys in a.
__device__ __forceinline__ void write_topk(const unsigned long long* a, int L, int k,
                                           float* __restrict__ out_d, int* __restrict__ out_i) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float dv = INFINITY;
    int iv = -1;
    if (j < L) key_out(a[j], &dv, &iv);
    out_d[j] = dv;
    out_i[j] = iv;
  }
}

// ---- rows staged in shared memory, four elements a lane-step: int8 codes
// as one 32-bit word, float16 as 64 bits.  int8 converts without the
// conversion unit: the byte (offset by 128) goes into the mantissa of 2^23
// by a byte permute, and one exact subtraction leaves the code as a float.
__device__ __forceinline__ void dec4(const int8_t* row, int w, float s, float o, float* out) {
  const uint32_t x = reinterpret_cast<const uint32_t*>(row)[w] ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float c = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + i)) - 8388736.0f;
    out[i] = __fadd_rn(__fmul_rn(c, s), o);
  }
}
__device__ __forceinline__ void dec4(const __half* row, int w, float, float, float* out) {
  const uint2 v = reinterpret_cast<const uint2*>(row)[w];
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// One warp scores NR rows at once from shared memory (D a multiple of 4):
// each query slice is read once for all NR rows.
template <typename CodeT, int NR>
__device__ __forceinline__ void rows_dot_smem(const CodeT* const (&rows)[NR], const float* qs, int D,
                                              float s, float o, int lane, float (&dot)[NR],
                                              float (&cc)[NR]) {
  float a[NR], b[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) a[j] = b[j] = 0.f;
  const int nw = D >> 2;
#pragma unroll 3
  for (int w = lane; w < nw; w += 32) {
    const float4 q4 = reinterpret_cast<const float4*>(qs)[w];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      float c[4];
      dec4(rows[j], w, s, o, c);
      a[j] = fmaf(q4.x, c[0], a[j]); b[j] = fmaf(c[0], c[0], b[j]);
      a[j] = fmaf(q4.y, c[1], a[j]); b[j] = fmaf(c[1], c[1], b[j]);
      a[j] = fmaf(q4.z, c[2], a[j]); b[j] = fmaf(c[2], c[2], b[j]);
      a[j] = fmaf(q4.w, c[3], a[j]); b[j] = fmaf(c[3], c[3], b[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    dot[j] = warp_sum(a[j]);
    cc[j] = warp_sum(b[j]);
  }
}

// One warp scores NR rows at once straight from global memory with 16-byte
// loads, U steps of every row in flight before any arithmetic (rows and
// the query 16-byte aligned, D a multiple of 16 / sizeof(T)).
template <typename T> struct Wide;
template <> struct Wide<float> { static constexpr int W = 4; };
template <> struct Wide<__half> { static constexpr int W = 8; };
template <> struct Wide<__nv_bfloat16> { static constexpr int W = 8; };

__device__ __forceinline__ void widen(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(const uint4& v, float* out, __half) {
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen(const uint4& v, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int NR, int U>
__device__ __forceinline__ void rows_dot_wide(const T* const (&rows)[NR], const float* qs, int D,
                                              int lane, float (&dot)[NR], float (&cc)[NR]) {
  constexpr int W = Wide<T>::W;
  float a[NR], b[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) a[j] = b[j] = 0.f;
  const int nv = D / W;
  for (int base = lane; base < nv; base += 32 * U) {
    uint4 v[U][NR];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NR; ++j)
        if (base + 32 * u < nv) v[u][j] = __ldg(reinterpret_cast<const uint4*>(rows[j]) + base + 32 * u);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + 32 * u;
      if (e >= nv) break;
      float x[W];
#pragma unroll
      for (int i = 0; i < W; i += 4) {
        const float4 t = reinterpret_cast<const float4*>(qs)[(e * W + i) >> 2];
        x[i] = t.x; x[i + 1] = t.y; x[i + 2] = t.z; x[i + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        float c[W];
        widen(v[u][j], c, T());
#pragma unroll
        for (int i = 0; i < W; ++i) {
          a[j] = fmaf(x[i], c[i], a[j]);
          b[j] = fmaf(c[i], c[i], b[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    dot[j] = warp_sum(a[j]);
    cc[j] = warp_sum(b[j]);
  }
}

// ---- mbarriers and 1-d bulk copies (global -> shared, the copy engine)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// Waits until the phase of the given parity has completed; a phase that
// never comes traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin == (1u << 26)) __trap();
  }
}
// bytes (a multiple of 16) from a 16-byte aligned global address into
// shared memory; completion is counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Dynamic shared memory above 48 KB needs an opt-in per kernel and device;
// asked for once and remembered by slot (one slot per kernel of a
// library).  The cache has internal linkage on purpose: a function-local
// static of a template or inline function is ONE object across every
// library loaded into the process (a GNU unique symbol), so a second build
// of the same source would find its kernels marked as opted in.
namespace {
int smem_allowed[32][16];

inline cudaError_t allow_smem(int slot, const void* kern, size_t smem) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && smem_allowed[slot][dev] >= static_cast<int>(smem)) return cudaSuccess;
  // the whole 228 KB an SM has as shared memory, so that the blocks the
  // registers allow also fit (the copies bypass L1, which gives way)
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess && dev < 16) smem_allowed[slot][dev] = smem > 0 ? static_cast<int>(smem) : 1;
  return e;
}

// Blocks of a kernel that the whole device holds at once (blocks an SM
// takes at this shared memory, times the SMs), remembered by slot.
int resident_at[16][16], resident_smem[16][16];

inline cudaError_t resident_blocks(int slot, const void* kern, int threads, size_t smem, int* out) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && resident_at[slot][dev] > 0 && resident_smem[slot][dev] == static_cast<int>(smem)) {
    *out = resident_at[slot][dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < 16) {
    resident_at[slot][dev] = *out;
    resident_smem[slot][dev] = static_cast<int>(smem);
  }
  return cudaSuccess;
}
}  // namespace

inline int smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

}  // namespace ecp
