// Flash attention forward (online softmax), GQA-aware: the LM prefill's
// attention on the GPU.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py ::
//   flash_attention_pallas (body _kernel), the TPU kernel that
//   src/repro/models/attention.py calls with impl="flash" for every
//   prefill layer (transformer._prefill_layer).
//
// Computes out[b, h, i, :] = sum_j p_ij v[b, h/g, j, :] / sum_j p_ij with
// p_ij = exp(s_ij - max_j s_ij) over the live keys j of query i, where
// s_ij = <q[b,h,i,:] * scale, k[b,h/g,j,:]> in float32 from the inputs cast
// to float32 (scale applied to q first, as the TPU kernel does), g =
// Hq / Hkv.  Key j is live when j < kv_len[b] and, if causal, j <= i +
// kv_len[b] - Sq (the last query aligned with the last valid key, so
// chunked prefill and decode with Sq < Skv work).  A row with no live key
// is 0.  Output float32 [B, Hq, Sq, d].
//
// What bounds it on an H100: operations.  At the prefill path's shape (B=1,
// Hq=24, Hkv=8, Sq=Skv=32768, d=128, bf16, causal) the work is
// 4*B*Hq*Sq*Skv*d/2 = 6.6e12 operations on 0.74 GB of inputs and output:
// ~9000 operations a byte, thirty times above the ~295 where the card's
// bf16 tensor cores (989 TFLOP/s) rather than its memory (3.35 TB/s) are
// the limit, so the least time is ~6.7 ms a layer.
//
// Design, shared by the two kernels below (float32 inputs take the first,
// bfloat16 the second; both are simple, with no pipelining of tiles):
//  * one block per (b, query head, tile of 64 queries); the grid's x axis
//    is the query head and its y axis the tile, heaviest (latest) causal
//    tiles first, so every wave mixes heads;
//  * a loop over 64-key tiles takes the place of the TPU's sequential grid
//    axis; only the tiles that hold a live key for some query of the block
//    are loaded (the causal future and the part past kv_len are skipped);
//  * q, k and v tiles are staged in shared memory; the kv head is h / g,
//    nothing is repeated; the running max m, the sum l, the rescaling and
//    the accumulator stay in registers of the threads that own the rows;
//  * the online-softmax guards of the TPU kernel: m = -inf until a live key
//    is seen (exp uses 0 in its place), masked scores give p = 0, and the
//    final division uses 1 where l = 0, so a dead row is 0, never NaN;
//  * the ragged edges of Sq and Skv are masked in the kernel: query rows
//    past Sq load 0 and are not stored, key rows past min(kv_len, Skv)
//    load 0 (p = 0 times a zero row).
// float32 (flash_fwd_kernel): FMA units from float32 tiles, 256 threads,
// each owning 4 query rows (ty + 16 i) by 4 keys (tx + 16 j) of the score
// tile and the same rows by d/16 accumulator columns; rows reduce across
// their 16 lanes by shuffles.  Shared memory at d=128: 98 KB (two blocks
// an SM), so the launch opts in above the 48 KB default.
// bfloat16 (tc::flash_fwd_mma_kernel): tensor cores through mma.sync
// m16n8k16 (bf16 in, float32 accumulate), 4 warps of 16 query rows each.
// q stays in registers as A fragments; s = q k^T takes k rows from shared
// memory as B fragments; scale, mask and softmax run on the float32
// accumulators; the score fragments of two 8-key tiles are the A fragment
// of the next product, p v.  p is float32 there, as in the TPU kernel, and
// an mma takes bf16, so p goes in two parts, hi = bf16(p) and lo = bf16(p -
// hi), each a product with the same v fragments: a relative error of p of
// at most 2^-18, where hi alone would leave 2^-9 (the two products cost
// twice what q k^T costs, not once).  v is stored transposed so
// that its B fragments are 32-bit loads.  The scale multiplies the float32
// scores instead of q, which differs from scaling q first only by float32
// rounding.  Shared memory at d=128: 52 KB.
// The LM prefill's case, bfloat16 at d = 128, goes to the TMA + wgmma kernel
// in flash_attention_wgmma.cu; the wrapper sends the other widths and
// float32 here (and chip_smoke.py times this file's bf16 kernel at d = 128
// beside that one, as the kernel it replaced).
#include "common.cuh"

namespace ecp {
namespace flash {

constexpr int kBQ = 64;       // queries a block
constexpr int kBK = 64;       // keys a tile
constexpr int kThreadsF = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_lens;  // nullptr: every batch row has Skv keys
  float* out;
  int Hq, Hkv, Sq, Skv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
  int causal;
  int n_qt;  // query tiles
};

template <int D>
struct Layout {
  static constexpr int QS = D + 4;                                // q row stride (floats)
  static constexpr int KS = (D + 4 > kBK + 4) ? D + 4 : kBK + 4;  // k rows, then p rows
  static constexpr int PS = kBK + 4;
  static constexpr size_t kFloats = static_cast<size_t>(kBQ) * QS + static_cast<size_t>(kBK) * KS +
                                    static_cast<size_t>(kBK) * D;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreadsF, 2) flash_fwd_kernel(const Params p) {
  constexpr int QS = Layout<D>::QS, KS = Layout<D>::KS, PS = Layout<D>::PS;
  constexpr int NC = D / 16;  // accumulator columns a thread
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                 // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;      // [kBK][KS]: k tile, then the p tile [kBQ][PS]
  float* Vs = Ks + kBK * KS;      // [kBK][D]
  float* Ps = Ks;

  const int h = blockIdx.x;
  const int qt = p.causal ? (p.n_qt - 1 - static_cast<int>(blockIdx.y)) : static_cast<int>(blockIdx.y);
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Skv;
  const int kv_valid = min(max(kv_len, 0), p.Skv);  // keys that exist and are valid
  const int off = kv_len - p.Sq;                    // causal alignment shift
  int kv_end = kv_valid;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBQ, p.Sq) - 1 + off + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  // q tile, scaled, float32; rows past Sq are 0
  for (int e = tid; e < kBQ * D; e += kThreadsF) {
    const int r = e / D, c = e % D, qi = q0 + r;
    Qs[r * QS + c] = qi < p.Sq ? qg[qi * p.q_ss + c] * p.scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's p and v are read (and the q tile written)
    for (int e = tid; e < kBK * D; e += kThreadsF) {
      const int r = e / D, c = e % D, kj = k0 + r;
      const bool ok = kj < kv_valid;
      Ks[r * KS + c] = ok ? kg[kj * p.k_ss + c] : 0.f;
      Vs[r * D + c] = ok ? vg[kj * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    // s = (q * scale) k^T for this thread's 4 x 4 entries
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * KS + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax; p overwrites s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = kj < kv_valid && (!p.causal || kj <= qi + off);
        s[i][j] = live ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float safe = m_new == -INFINITY ? 0.f : m_new;  // no live key yet
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - safe);
        rs += s[i][j];
      }
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - safe);
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every thread is done reading the k tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc += p v
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = Vs[(kk + u) * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }

  float* og = p.out + ((static_cast<size_t>(b) * p.Hq + h) * p.Sq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) og[static_cast<size_t>(qi) * D + tx + 16 * c] = acc[i][c] / den;
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  const void* kern = reinterpret_cast<const void*>(flash_fwd_kernel<D>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(p.Hq, p.n_qt, B);
  flash_fwd_kernel<D><<<grid, kThreadsF, smem, stream>>>(p);
  return cudaGetLastError();
}


// ---- bfloat16: tensor-core products (mma.sync m16n8k16, float32 accumulate)
namespace tc {

constexpr int kBQ = 64;   // queries a block: 16 per warp
constexpr int kBK = 64;   // keys a tile
constexpr int kThreadsT = 128;

template <int D>
struct Layout {
  static constexpr int QS = D + 8;    // q and k rows (bf16), 16-byte aligned, banks shifted by 4 words
  static constexpr int VS = kBK + 8;  // v^T rows: one per head dimension, kBK keys
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (static_cast<size_t>(kBQ + kBK) * QS + static_cast<size_t>(D) * VS);
};

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Needs 16-byte aligned rows: the batch, head and sequence strides are
// multiples of 8 elements and the base pointers 16-byte aligned (the
// wrapper checks).
template <int D>
__global__ void __launch_bounds__(kThreadsT) flash_fwd_mma_kernel(const Params p) {
  constexpr int QS = Layout<D>::QS, VS = Layout<D>::VS;
  constexpr int KD = D / 16;   // k-steps of q k^T over d
  constexpr int NO = D / 8;    // 8-column tiles of the output
  constexpr int NS = kBK / 8;  // 8-key tiles of the scores
  constexpr int CH = D / 8;    // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smraw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smraw);  // [kBQ][QS]
  __nv_bfloat16* Ks = Qs + kBQ * QS;                             // [kBK][QS]
  __nv_bfloat16* Vt = Ks + kBK * QS;                             // [D][VS]: v transposed

  const int h = blockIdx.x;
  const int qt = p.causal ? (p.n_qt - 1 - static_cast<int>(blockIdx.y)) : static_cast<int>(blockIdx.y);
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Skv;
  const int kv_valid = min(max(kv_len, 0), p.Skv);
  const int off = kv_len - p.Sq;
  int kv_end = kv_valid;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBQ, p.Sq) - 1 + off + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  for (int e = tid; e < kBQ * CH; e += kThreadsT) {
    const int r = e / CH, c = (e % CH) * 8, qi = q0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (qi < p.Sq) x = *reinterpret_cast<const uint4*>(qg + qi * p.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = x;
  }
  __syncthreads();
  const int r0 = warp * 16 + gid;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    qa[kd][0] = ld32(Qs + r0 * QS + kd * 16 + tig * 2);
    qa[kd][1] = ld32(Qs + (r0 + 8) * QS + kd * 16 + tig * 2);
    qa[kd][2] = ld32(Qs + r0 * QS + kd * 16 + 8 + tig * 2);
    qa[kd][3] = ld32(Qs + (r0 + 8) * QS + kd * 16 + 8 + tig * 2);
  }
  const int qi[2] = {q0 + r0, q0 + r0 + 8};

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's k and v are read
    for (int e = tid; e < kBK * CH; e += kThreadsT) {
      const int r = e / CH, c = (e % CH) * 8, kj = k0 + r;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (kj < kv_valid) {
        kx = *reinterpret_cast<const uint4*>(kg + kj * p.k_ss + c);
        vx = *reinterpret_cast<const uint4*>(vg + kj * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * QS + c) = kx;
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * VS + r] = vh[i];
    }
    __syncthreads();

    // s = q k^T (float32), then scale, mask
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const __nv_bfloat16* kp = Ks + (n * 8 + gid) * QS + kd * 16 + tig * 2;
        mma16816(s[n], qa[kd], ld32(kp), ld32(kp + 8));
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = u >> 1, kj = k0 + n * 8 + tig * 2 + (u & 1);
        const bool live = kj < kv_valid && (!p.causal || kj <= qi[row] + off);
        s[n][u] = live ? s[n][u] * p.scale : -INFINITY;
        mx[row] = fmaxf(mx[row], s[n][u]);
      }
    // online softmax, two rows a thread, each shared by the four lanes of a quad
    float corr[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const float m_new = fmaxf(m[row], quad_max(mx[row]));
      const float safe = m_new == -INFINITY ? 0.f : m_new;  // no live key yet
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int u = 2 * row; u < 2 * row + 2; ++u) {
          s[n][u] = s[n][u] == -INFINITY ? 0.f : expf(s[n][u] - safe);
          rs += s[n][u];
        }
      corr[row] = m[row] == -INFINITY ? 0.f : expf(m[row] - safe);
      l[row] = l[row] * corr[row] + quad_sum(rs);
      m[row] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // o += p v: the score fragments of key tiles 2j, 2j+1 are the A
    // fragment of k-step j, p in two bf16 parts (hi + lo), both times v
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vp = Vt + (n * 8 + gid) * VS + j * 16 + tig * 2;
        const uint32_t b0 = ld32(vp), b1 = ld32(vp + 8);
        mma16816(o[n], pl, b0, b1);
        mma16816(o[n], ph, b0, b1);
      }
    }
  }

  float* og = p.out + ((static_cast<size_t>(b) * p.Hq + h) * p.Sq) * D;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (qi[row] >= p.Sq) continue;
    const float den = l[row] == 0.f ? 1.f : l[row];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(og + static_cast<size_t>(qi[row]) * D + n * 8 + tig * 2) =
          make_float2(o[n][2 * row] / den, o[n][2 * row + 1] / den);
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  const void* kern = reinterpret_cast<const void*>(flash_fwd_mma_kernel<D>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(p.Hq, p.n_qt, B);
  flash_fwd_mma_kernel<D><<<grid, kThreadsT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// float32 inputs take the FMA kernel, bfloat16 the tensor-core one
inline cudaError_t launch_d(const Params& p, int B, int D, bool bf16, cudaStream_t stream) {
  switch (D) {
#define ECP_FLASH_D(d) \
    case d: return bf16 ? tc::launch<d>(p, B, stream) : launch<d>(p, B, stream);
    ECP_FLASH_D(16) ECP_FLASH_D(32) ECP_FLASH_D(48) ECP_FLASH_D(64)
    ECP_FLASH_D(80) ECP_FLASH_D(96) ECP_FLASH_D(112) ECP_FLASH_D(128)
#undef ECP_FLASH_D
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace ecp

extern "C" {

// q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] with element strides (batch, head, seq)
// and a contiguous last dimension; out [B,Hq,Sq,D] float32 contiguous;
// kv_lens [B] int32 or NULL.  dtype: 0 = float32, 2 = bfloat16.  D is a
// multiple of 16 up to 128.  Returns a cudaError_t (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v, const void* kv_lens,
                           void* out, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                           long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                           long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                           long long v_ss, float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < 0) return cudaErrorInvalidValue;
  ecp::flash::Params p{q, k, v, static_cast<const int*>(kv_lens), static_cast<float*>(out),
                       Hq, Hkv, Sq, Skv,
                       q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                       scale, causal, (Sq + ecp::flash::kBQ - 1) / ecp::flash::kBQ};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 2) return cudaErrorInvalidValue;
  return ecp::flash::launch_d(p, B, D, dtype == 2, st);
}

}  // extern "C"
