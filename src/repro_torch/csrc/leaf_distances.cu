// Packed mode's leaf scoring: for every (query, slot) pair of a scan chunk
// whose slot is valid, the distances of the query to the real rows of the
// slot's leaf, read in place from the resident block of leaves padded to
// the largest ([n_leaves, cap, D] float32).  out[pair, r] for r < n_rows of
// the leaf; no other entry is written (the merge masks them).
//
// Replaces no TPU kernel: the JAX package's packed search
// (src/repro/core/batched.py) scores leaves with XLA's products.  Added
// because the plain version (kernels/leaf_distances/ref.py: the distinct
// visited leaves gathered in blocks, padded to the largest, one product
// against every query, then each query's own leaves picked out) scored 165
// rows for each row a query needed at the benchmark's shape (B = 128 queries,
// b = 64 leaves each, leaves padded to 5248 rows, median 250).
//
// What bounds it on an H100: bytes.  A chunk reads its distinct visited
// leaves' real rows (0.3-0.5 M rows of 1152 float32 at that shape, 1.3-2.5
// GB: 0.4-0.75 ms at 3.35 TB/s) and writes the [B, b, cap] output (172 MB);
// its 2 * D operations for each real row of each valid pair (6-9 GFLOP) take
// 0.1-0.15 ms at the 67 TFLOP/s of float32 outside the tensor cores.
//
// Design.  The wrapper groups the pairs by leaf on the device (a stable
// sort of the pairs' leaf ids, invalid slots last), and gives for each leaf
// the position of its first pair and the inclusive sum of its work items,
// no host synchronisation.  A work item is one leaf, one tile of kTR of its
// real rows and one group of up to kQG of its pairs: ceil(pairs / kQG) x
// ceil(n_rows / kTR) items a leaf, the groups of one row tile adjacent, so
// that blocks reading the same rows run together and share them in L2.
// Persistent blocks, as many as the card holds at once, take items off an
// atomic counter.  A block streams its rows and its queries in K-slices of
// kKS floats through a ring of kStages stages in shared memory (cp.async,
// zero-filled past the rows, the pairs and D; a staged row's stride of kKS
// + 4 floats makes the 16-byte reads below free of bank conflicts).  Each
// warp takes 4 of the group's queries (a warp past the group's pairs skips
// the arithmetic), each lane 4 rows, and a thread keeps its 4 x 4 sums in
// registers: every output is one thread's sum over k in ascending order,
// full float32 multiply-adds (no tensor cores: TF32 fails the benchmark's
// limits), no split of K and no atomics on the results, so a launch is
// deterministic.  The epilogue adds the metric's terms as the plain version
// does ((|q|^2 + |x|^2) - 2 dot, -dot, 1 - dot; cosine's rows and queries
// come unit-normalised) and writes each query's part of the tile, a warp's
// 32 consecutive rows at a time.
#include "common.cuh"

namespace ecp {

constexpr int kLThreads = 256;
constexpr int kTR = 128;                 // rows of a work item: 4 a lane
constexpr int kQG = 32;                  // pairs of a work item: 4 a warp
constexpr int kKS = 32;                  // floats of a K-slice
constexpr int kKP = kKS + 4;             // a staged row's stride (floats)
constexpr int kStages = 3;
constexpr int kStageFloats = (kTR + kQG) * kKP;
constexpr size_t kLSmem = kStages * kStageFloats * sizeof(float);
static_assert(kLThreads == 8 * 32 && kTR == 4 * 32 && kQG == 4 * (kLThreads / 32), "thread tiles");

struct LArgs {
  const float* q;      // [B, D] prepared queries
  const float* q_sq;   // [B] their squared norms (l2), else null
  const float* emb;    // [L, cap, D] rows padded to cap
  const float* sq;     // [L, cap] the rows' squared norms (l2), else null
  const int* n_rows;   // [L] real rows of each leaf (a prefix)
  const int* perm;     // [B * b] pair ids (query * b + slot), grouped by leaf
  const int* first;    // [L + 1] position in perm of each leaf's first pair
  const int* ends;     // [L] inclusive sums of the leaves' work items
  int* next;           // the work counter, 0 at launch
  float* out;          // [B * b, cap]
  int b, L, cap, D, metric;
};

// V floats (4 or 1) from global to shared memory, zeros where !ok
template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool ok) {
  const int n = ok ? 4 * V : 0;
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// One stage: kTR rows then kQG query rows, kKS floats of each from k0 on.
template <int V>
__device__ __forceinline__ void load_stage(float* st, const float* rows, int nr, const float* q,
                                           const int* qid, int cnt, int D, int k0) {
  constexpr int C = kKS / V;  // copies a staged row
  const uint32_t base = smem_u32(st);
  for (int c = threadIdx.x; c < (kTR + kQG) * C; c += kLThreads) {
    const int r = c / C, e = (c % C) * V, k = k0 + e;
    const float* src = rows;
    bool ok = k < D;
    if (r < kTR) {
      ok = ok && r < nr;
      if (ok) src = rows + static_cast<size_t>(r) * D + k;
    } else {
      ok = ok && r - kTR < cnt;
      if (ok) src = q + static_cast<size_t>(qid[r - kTR]) * D + k;
    }
    cp_async<V>(base + static_cast<uint32_t>((r * kKP + e) * 4), src, ok);
  }
}

// A warp's 4 queries against its lanes' 4 rows over one staged K-slice.
__device__ __forceinline__ void score_stage(const float* st, int lane, int warp, float (&acc)[4][4]) {
  const float* xs = st + lane * kKP;
  const float* qs = st + (kTR + 4 * warp) * kKP;
#pragma unroll
  for (int kk = 0; kk < kKS; kk += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(xs + i * 32 * kKP + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(qs + j * kKP + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// V = 4: rows and queries 16-byte aligned, D a multiple of 4; else V = 1.
template <int V>
__global__ void __launch_bounds__(kLThreads, 3) leaf_distances_kernel(const LArgs a) {
  extern __shared__ __align__(16) float ring[];
  __shared__ int s_item, s_pair[kQG], s_qid[kQG];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = a.ends[a.L - 1];
  const int nk = (a.D + kKS - 1) / kKS;
  for (;;) {
    if (tid == 0) s_item = atomicAdd(a.next, 1);
    __syncthreads();
    const int w = s_item;
    if (w >= total) break;
    // the item's leaf: the first whose inclusive sum passes w
    int lo = 0, hi = a.L - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.ends[mid] > w) hi = mid; else lo = mid + 1;
    }
    const int u = lo, rows_u = a.n_rows[u], f0 = a.first[u], pairs_u = a.first[u + 1] - f0;
    const int groups = (pairs_u + kQG - 1) / kQG, tiles = (rows_u + kTR - 1) / kTR;
    const int local = w - (a.ends[u] - groups * tiles);
    const int tile = local / groups, grp = local - tile * groups;
    const int r0 = tile * kTR, nr = min(kTR, rows_u - r0);
    const int cnt = min(kQG, pairs_u - grp * kQG);
    if (tid < cnt) {
      const int p = a.perm[f0 + grp * kQG + tid];
      s_pair[tid] = p;
      s_qid[tid] = p / a.b;
    }
    __syncthreads();
    const float* rows = a.emb + (static_cast<size_t>(u) * a.cap + r0) * a.D;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_stage<V>(ring + s * kStageFloats, rows, nr, a.q, s_qid, cnt, a.D, s * kKS);
      cp_commit();
    }
    const bool active = 4 * warp < cnt;
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<kStages - 2>();
      __syncthreads();  // slice kt has landed for all; slice kt - 1's stage is free
      const int ahead = kt + kStages - 1;
      if (ahead < nk)
        load_stage<V>(ring + (ahead % kStages) * kStageFloats, rows, nr, a.q, s_qid, cnt, a.D, ahead * kKS);
      cp_commit();
      if (active) score_stage(ring + (kt % kStages) * kStageFloats, lane, warp, acc);
    }
    cp_wait<0>();
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = 4 * warp + j;
        if (g >= cnt) break;
        float* o = a.out + static_cast<size_t>(s_pair[g]) * a.cap + r0;
        const float qq = a.metric == kL2 ? a.q_sq[s_qid[g]] : 0.f;
        const float* xsq = a.metric == kL2 ? a.sq + static_cast<size_t>(u) * a.cap + r0 : nullptr;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = lane + 32 * i;
          if (r >= nr) break;
          const float dot = acc[i][j];
          float d;
          if (a.metric == kL2) d = __fsub_rn(__fadd_rn(qq, xsq[r]), __fmul_rn(2.f, dot));
          else if (a.metric == kIP) d = -dot;
          else d = __fsub_rn(1.f, dot);
          o[r] = d;
        }
      }
    }
  }
}

template <int V>
cudaError_t launch_leaf(const LArgs& a, cudaStream_t st) {
  const void* kern = reinterpret_cast<const void*>(leaf_distances_kernel<V>);
  const int slot = V == 4 ? 0 : 1;
  cudaError_t e = allow_smem(slot, kern, kLSmem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = resident_blocks(slot, kern, kLThreads, kLSmem, &blocks);
  if (e != cudaSuccess) return e;
  leaf_distances_kernel<V><<<blocks, kLThreads, kLSmem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace ecp

extern "C" {

// metric: 0 = l2, 1 = ip, 2 = cosine (q_sq and sq given for l2 alone).
// All pointers are device pointers of contiguous tensors: q [B, D], q_sq
// [B], emb [L, cap, D], sq [L, cap] float32; n_rows [L], perm [B * b],
// first [L + 1], ends [L] int32 (ops.leaf_work); next one int32 at 0; out
// [B * b, cap] float32, of which only the real rows of valid pairs are
// written.  Returns a cudaError_t (0 on success).
int leaf_distances_launch(const void* q, const void* q_sq, const void* emb, const void* sq,
                          const void* n_rows, const void* perm, const void* first, const void* ends,
                          void* next, void* out, int b, int L, int cap, int D, int metric,
                          void* stream) {
  if (b <= 0 || L <= 0 || cap <= 0) return 0;
  if (D <= 0 || metric < 0 || metric > 2 || (metric == 0 && (q_sq == nullptr || sq == nullptr)))
    return cudaErrorInvalidValue;
  ecp::LArgs a{static_cast<const float*>(q), static_cast<const float*>(q_sq),
               static_cast<const float*>(emb), static_cast<const float*>(sq),
               static_cast<const int*>(n_rows), static_cast<const int*>(perm),
               static_cast<const int*>(first), static_cast<const int*>(ends),
               static_cast<int*>(next), static_cast<float*>(out), b, L, cap, D, metric};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  if (aligned && D % 4 == 0) return ecp::launch_leaf<4>(a, st);
  return ecp::launch_leaf<1>(a, st);
}

}  // extern "C"
