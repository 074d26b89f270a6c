// Flash attention forward for Hopper (sm_90a): bfloat16 q, k, v at head
// width 128, tiles brought in by TMA through a ring of shared memory, both
// products on the tensor cores through wgmma.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py ::
//   flash_attention_pallas (body _kernel) for bfloat16 inputs at d = 128,
//   the head width of every full config in configs/lm_archs.py; the LM
//   prefill (models/attention.py, impl="flash") launches it once a layer.
//   float32 inputs and the other widths stay with csrc/flash_attention.cu.
//
// Computes what the TPU kernel computes: out[b, h, i, :] = sum_j p_ij
// v[b, h/g, j, :] / sum_j p_ij, p_ij = exp(s_ij - max_j s_ij) over the live
// keys j of query i, s_ij = scale <q[b,h,i,:], k[b,h/g,j,:]> in float32, g =
// Hq / Hkv.  Key j is live when j < kv_len[b] and, if causal, j <= i +
// kv_len[b] - Sq.  A row with no live key is 0.  Output float32 [B, Hq, Sq,
// 128].
//
// What bounds it on an H100: operations.  At the prefill's shape (B=1,
// Hq=24, Hkv=8, Sq=Skv=32768, causal) the work is 6.6e12 operations on
// 0.74 GB: 6.7 ms at the bf16 peak.  p v is issued twice (p in two bf16
// parts, below), so the tensor cores do 1.5x that work: ~10 ms at best.
//
// Design:
//  * one block per (query head, tile of 128 queries, batch row), the grid's
//    axes in that order, heaviest (latest) causal tiles first;
//  * three warpgroups.  Warpgroup 0 produces: one thread issues the TMA
//    loads (q once; k and v tiles of 64 keys into a ring of kStages stages,
//    each with full and empty barriers for k and for v, so that k is
//    refilled as soon as q k^T has read it), and the warpgroup gives
//    registers away (setmaxnreg.dec).  Warpgroups 1 and 2 consume, 64 query
//    rows each (setmaxnreg.inc);
//  * tensor maps (4-d: d, sequence, head, batch, with the caller's strides,
//    128-byte swizzle) are encoded on the host for every call and passed as
//    __grid_constant__ parameters.  A row of 128 bf16 is 256 bytes, two
//    boxes of 64 columns (by 128 rows of q, 64 of k or v);
//  * s = q k^T: wgmma m64n64k16, both operands K-major from the swizzled
//    tiles, 8 steps over d;
//  * the scale (log2 e folded in) on the float32 accumulators; the mask only
//    on the tiles that straddle the causal diagonal or kv_len of this
//    warpgroup's rows; the online softmax with the TPU kernel's guards
//    (m = -inf until a live key comes, 0 in its place inside exp2, p = 0 for
//    a masked score, 1 in place of l = 0 at the end);
//  * o += p v: wgmma m64n128k16 with A from registers.  The accumulator of
//    keys 16j..16j+15 is, element for element, the A fragment of step j.
//    p is float32 as in the TPU kernel and wgmma takes bf16, so p goes in
//    two parts, hi = bf16(p) and lo = bf16(p - hi), each times the same v
//    (p exact to 2^-18), written over the scores as runs of four registers;
//    v is used as loaded ([keys][d]: B MN-major, the transpose bit set),
//    never transposed in memory;
//  * epilogue: o / l stored from registers as float32 rows.
// Why 64-key tiles: at 128 a consumer holds 64 score and 64 output
// accumulators and p's fragments, more than its 240 registers; ptxas then
// spilled and serialized every wgmma (C7512).  At 64 nothing spills and the
// products of a step run back to back; a third stage brought the
// serialization back, a fourth gained nothing.
// Keys in [kv_len, Skv) are real memory: their p is exactly 0, so they add
// 0 * v (v must be finite there, as in the TPU kernel, whose p v spans the
// whole block).  Keys past Skv and queries past Sq are TMA's zero fill.
// Later work: ping-pong of the two consumers, overlap of one tile's softmax
// with the next tile's q k^T, persistent blocks, the query heads of a GQA
// group in one block.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ecp {
namespace flash_wgmma {

constexpr int kD = 128;
constexpr int kBQ = 128;       // queries a block: 64 per consumer warpgroup
constexpr int kBK = 64;        // keys a tile
constexpr int kStages = 2;     // k/v tiles in flight
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kNS = kBK / 2;   // score accumulators a consumer thread
static_assert(kBK == 64, "q k^T is written as m64n64k16 products");
constexpr uint32_t kQBox = 64 * 2 * kBQ;   // a box of q: 64 columns x kBQ rows of bf16
constexpr uint32_t kKVBox = 64 * 2 * kBK;  // a box of k or v: 64 columns x kBK rows
constexpr uint32_t kQBytes = 2 * kQBox, kKVBytes = 2 * kKVBox;  // two boxes a row of 128
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, from a 1024-byte aligned base (the swizzle's atom): q, then
// k and v of each stage, then the barriers
__host__ __device__ constexpr uint32_t kOffK(int s) { return kQBytes + kKVBytes * 2 * s; }
__host__ __device__ constexpr uint32_t kOffV(int s) { return kOffK(s) + kKVBytes; }
constexpr uint32_t kOffBar = kOffK(kStages);
constexpr int kBars = 1 + 4 * kStages;  // q full; k full, v full, k empty, v empty per stage
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65536
constexpr size_t kSmemBytes = kOffBar + 8 * kBars + 1024;

struct Params {
  const int* kv_lens;  // nullptr: every batch row has Skv keys
  float* out;
  int Hq, Hkv, Sq, Skv;
  float scale;
  int causal;
  int n_qt;  // query tiles
};

// ---- barriers and TMA
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.  A phase that
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

// one box of a 4-d tensor map into shared memory; completion is counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).  K-major tiles: 8 rows of 128
// bytes make an atom, atoms 1024 bytes apart (stride), the leading offset
// unused.  MN-major (v): the leading offset steps 64 columns (one box), the
// stride offset 8 rows (keys).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving reads or writes of r across an async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ECP_WG_D                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define ECP_WG_DOPS                                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),             \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),     \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),  \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),  \
      "+f"(d[63])

// d (+)= a b: a 64x16 and b 16x64, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a b: a 64x16 from registers (four bf16 pairs a thread), b 16x128
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ECP_WG_D
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ECP_WG_DOPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ECP_WG_D
#undef ECP_WG_DOPS

// ---- softmax helpers
// 2^x on the special-function unit (2 ulp; results below 2^-126 flush to 0,
// far below what a row sum of at least 1 can see); 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// two float32 values as bf16 pairs: hi = bf16(x), lo = bf16(x - hi); the
// first value in the low half of each
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Accumulator layout of an m64nN product, for thread (warp w, lane l) of
// a warpgroup: d[4i + u] holds row 16w + l/4 + 8(u/2), column 8i + 2(l%4) +
// (u%2).
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023u) & ~1023u;
  const uint32_t sQ = base, bars = base + kOffBar;
  auto q_full = [&]() { return bars; };
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int h = blockIdx.x;
  const int qt = p.causal ? (p.n_qt - 1 - static_cast<int>(blockIdx.y)) : static_cast<int>(blockIdx.y);
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * kBQ;

  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Skv;
  const int kv_valid = min(max(kv_len, 0), p.Skv);  // keys that exist and are valid
  const int off = kv_len - p.Sq;                    // causal alignment shift
  int kv_end = kv_valid;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBQ, p.Sq) + off);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival from each consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full(), kQBytes);
      tma_load(sQ, &tq, q_full(), 0, q0, h, b);
      tma_load(sQ + kQBox, &tq, q_full(), 64, q0, h, b);
      // k of a stage is refilled once q k^T has read it, v once p v has
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t parity = ((it / kStages) - 1) & 1;
        const int k0 = it * kBK;
        const uint32_t sK = base + kOffK(s), sV = base + kOffV(s);
        if (it >= kStages) mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), kKVBytes);
        tma_load(sK, &tk, k_full(s), 0, k0, hk, b);
        tma_load(sK + kKVBox, &tk, k_full(s), 64, k0, hk, b);
        if (it >= kStages) mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), kKVBytes);
        tma_load(sV, &tv, v_full(s), 0, k0, hk, b);
        tma_load(sV + kKVBox, &tv, v_full(s), 64, k0, hk, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int cw = wg - 1;
    const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31, t4 = lane & 3;
    const int row0 = q0 + 64 * cw + 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
    const int wq_first = q0 + 64 * cw;
    const int wq_last = min(wq_first + 63, p.Sq - 1);
    const float sl2 = p.scale * kLog2e;
    // q rows 64 cw.. of each box; steps over d move 32 bytes in a box, then to the next box
    const uint64_t dq = sw128_desc(sQ + 64u * 128u * cw, 16, 1024);
    auto d_step = [](uint32_t box, int kd) { return static_cast<uint64_t>((box * (kd >> 2) + 32u * (kd & 3)) >> 4); };

    float o[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    mbar_wait(q_full(), 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = it * kBK;
      // a tile past this warpgroup's last causal key is waited for and
      // released like any other, but not computed.  A warp releases a
      // buffer only after waiting for it to fill, so its arrival always
      // counts towards that fill's phase
      const bool live_tile = !p.causal || k0 <= wq_last + off;
      float sc[kNS];
      mbar_wait(k_full(s), ph);
      if (live_tile) {
        const uint64_t dk = sw128_desc(base + kOffK(s), 16, 1024);
#pragma unroll
        for (int i = 0; i < kNS; ++i) sc[i] = 0.f;
        fence_regs(sc);
        wg_fence();
#pragma unroll
        for (int kd = 0; kd < kD / 16; ++kd) wgmma_ss(sc, dq + d_step(kQBox, kd), dk + d_step(kKVBox, kd), kd > 0);
        wg_commit();
        wg_wait_all();
        fence_regs(sc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(s));
      if (live_tile) {
#pragma unroll
        for (int i = 0; i < kNS; ++i) sc[i] *= sl2;
        // the mask, on the tiles that straddle kv_len or this warpgroup's diagonal
        const bool full = k0 + kBK <= kv_valid && (!p.causal || k0 + kBK - 1 <= wq_first + off);
        if (!full) {
#pragma unroll
          for (int i = 0; i < kNS; ++i) {
            const int kj = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1), qi = row0 + 8 * ((i >> 1) & 1);
            const bool live = kj < kv_valid && (!p.causal || kj <= qi + off);
            sc[i] = live ? sc[i] : -INFINITY;
          }
        }
        // online softmax (base 2), two rows a thread, each shared by the four lanes of a quad
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int i = 0; i < kBK / 8; ++i) mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
          const float m_new = fmaxf(m[r], quad_max(mx));
          const float safe = m_new == -INFINITY ? 0.f : m_new;  // no live key yet
          float rs = 0.f;
#pragma unroll
          for (int i = 0; i < kBK / 8; ++i) {
            // a masked score is -inf: exp2 gives exactly 0
            sc[4 * i + 2 * r] = fast_exp2(sc[4 * i + 2 * r] - safe);
            sc[4 * i + 2 * r + 1] = fast_exp2(sc[4 * i + 2 * r + 1] - safe);
            rs += sc[4 * i + 2 * r] + sc[4 * i + 2 * r + 1];
          }
          corr[r] = fast_exp2(m[r] - safe);  // 0 while m was -inf
          l[r] = l[r] * corr[r] + rs;    // this lane's part of the row sum
          m[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          o[4 * i] *= corr[0];
          o[4 * i + 1] *= corr[0];
          o[4 * i + 2] *= corr[1];
          o[4 * i + 3] *= corr[1];
        }
      }
      mbar_wait(v_full(s), ph);
      if (live_tile) {
        // p in place: step j over keys takes the four pairs sc[8j + 2u],
        // sc[8j + 2u + 1] (rows g, g+8 of keys 16j + 2(l%4), then of keys
        // 16j + 8 + 2(l%4)) as its A fragment; their hi bf16 pairs go to
        // sc[8j..8j+3] and their lo pairs to sc[8j+4..8j+7], each a run of
        // four registers as wgmma reads an A fragment, so p takes no
        // registers beyond the scores'
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) split_bf16(sc[8 * j + 2 * u], sc[8 * j + 2 * u + 1], hi[u], lo[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            sc[8 * j + u] = __uint_as_float(hi[u]);
            sc[8 * j + 4 + u] = __uint_as_float(lo[u]);
          }
        }
        const uint64_t dv = sw128_desc(base + kOffV(s), kKVBox, 1024);
        fence_regs(o);
        fence_regs(sc);
        wg_fence();
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          const uint64_t dvj = dv + ((2048u * j) >> 4);  // 16 keys of 128 bytes
          const float* f = sc + 8 * j;
          const uint32_t hi[4] = {__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                                  __float_as_uint(f[3])};
          const uint32_t lo[4] = {__float_as_uint(f[4]), __float_as_uint(f[5]), __float_as_uint(f[6]),
                                  __float_as_uint(f[7])};
          wgmma_rs(o, lo, dvj);
          wgmma_rs(o, hi, dvj);
        }
        wg_commit();
        wg_wait_all();
        fence_regs(o);
        fence_regs(sc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(s));
    }

    float* og = p.out + (static_cast<size_t>(b) * p.Hq + h) * static_cast<size_t>(p.Sq) * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      const float lr = quad_sum(l[r]);
      const float den = lr == 0.f ? 1.f : lr;
      if (qi >= p.Sq) continue;
      float* orow = og + static_cast<size_t>(qi) * kD + 2 * t4;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<float2*>(orow + 8 * i) = make_float2(o[4 * i + 2 * r] / den, o[4 * i + 2 * r + 1] / den);
    }
  }
}

// ---- host: tensor maps and the launch
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &qr);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &qr);
#endif
    if (e == cudaSuccess && qr == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// [batch, heads, rows, 128] bf16 with element strides (sb, sh, ss) and a
// contiguous last dimension; boxes of 64 columns x 128 rows, 128-byte
// swizzle, zero fill past the edges.  The stride of a dimension of size 1
// is never used; it is replaced by a valid one.
inline bool make_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int box_rows, int batch, int heads, int rows,
                     long long sb, long long sh, long long ss) {
  if (rows == 1) ss = kD;
  if (heads == 1) sh = ss * rows;
  if (batch == 1) sb = sh * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash_wgmma
}  // namespace ecp

extern "C" {

// q [B,Hq,Sq,128], k/v [B,Hkv,Skv,128] bfloat16 with element strides
// (batch, head, seq), a contiguous last dimension, 16-byte aligned bases and
// strides that are multiples of 8 elements (TMA's rule); out [B,Hq,Sq,128]
// float32 contiguous; kv_lens [B] int32 or NULL.  Returns a cudaError_t (0
// on success).
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, const void* kv_lens, void* out,
                                 int B, int Hq, int Hkv, int Sq, int Skv, long long q_sb, long long q_sh,
                                 long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                                 long long v_sh, long long v_ss, float scale, int causal, void* stream) {
  namespace fw = ecp::flash_wgmma;
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Skv == 0)  // no key at all: every row is 0
    return cudaMemsetAsync(out, 0, sizeof(float) * B * Hq * static_cast<size_t>(Sq) * fw::kD, st);
  const fw::EncodeTiled fn = fw::encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!fw::make_map(fn, &tq, q, fw::kBQ, B, Hq, Sq, q_sb, q_sh, q_ss) ||
      !fw::make_map(fn, &tk, k, fw::kBK, B, Hkv, Skv, k_sb, k_sh, k_ss) ||
      !fw::make_map(fn, &tv, v, fw::kBK, B, Hkv, Skv, v_sb, v_sh, v_ss))
    return cudaErrorInvalidValue;
  const fw::Params p{static_cast<const int*>(kv_lens), static_cast<float*>(out), Hq, Hkv, Sq, Skv,
                     scale, causal, (Sq + fw::kBQ - 1) / fw::kBQ};
  const void* kern = reinterpret_cast<const void*>(fw::flash_fwd_wgmma_kernel);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(fw::kSmemBytes));
  if (e != cudaSuccess) return e;
  dim3 grid(Hq, p.n_qt, B);
  fw::flash_fwd_wgmma_kernel<<<grid, fw::kThreads, fw::kSmemBytes, st>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// dynamic shared memory a block of the kernel takes, in bytes
int flash_attention_wgmma_smem_bytes() { return static_cast<int>(ecp::flash_wgmma::kSmemBytes); }

}  // extern "C"
