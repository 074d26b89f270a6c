// Packed mode's merge: for every query, the C smallest (distance, position)
// pairs of its sorted candidate buffer and the real rows of its scan
// chunk's valid slots, read in place from leaf_distances' [B, b, cap]
// output, written as the query's new sorted buffer.  A pair's position is
// its place in the buffer (p < C) or C + slot * cap + row: the order of the
// concatenation the plain version sorts, so equal distances keep that
// order.  -0.0 ties with +0.0.  A row whose distance is +inf or NaN is no
// candidate: entries past the finite ones are (+inf, -1).
//
// Replaces no TPU kernel: the JAX package's packed search
// (src/repro/core/batched.py) merges with XLA's argsort.  Added because
// the plain version (kernels/leaf_merge/ref.py: mask the padding, append
// the chunk's [B, b * cap] distances to the buffer, a stable sort, keep C)
// sorted 336 272 keys a query at the benchmark's shape (C = 400, b = 64
// leaves padded to 5248 rows) to keep 400, of which about 30 000 were real
// rows and the rest +inf padding: 82% of the scan's device time.
//
// What bounds it on an H100: bytes and latency, not arithmetic.  A chunk's
// real rows (about 30 000 a query, 15 MB for 128 queries) are read once
// from device memory, most of them still in the 50 MB L2 that the scoring
// kernel wrote them to; the buffers are 0.6 MB.  No [B, C + b * cap] key
// tensor is ever made.
//
// Design.  One block of 1024 threads a query (128 queries fill 128 of the
// 132 SMs in one wave).  The block first turns its slots' real rows
// (n_rows of each valid slot's leaf) into inclusive sums, so that a flat
// index over the real rows walks forward to its slot.  A candidate's key is
// ord(distance) << 32 | position: unique, and ascending keys are the stable
// sort's order.  Radix selection over the keys, 11 bits a pass from the
// top, finds the C-th smallest: each pass reads the candidates again (from
// L2), histograms those inside the range chosen so far into shared memory,
// and a block-wide scan picks the bin that holds the C-th.  It stops as
// soon as everything up to the end of the chosen bin, at least C keys,
// fits the sort area (S keys, a power of two >= C; at the benchmark's
// shape usually after the first or second pass), and then only: one more
// read collects those keys, a bitonic sort (common.cuh) orders them, and
// the first C are written, each pair's distance and id read back by its
// position.  The sort area is shared memory up to kSortSmem keys and a
// global scratch beyond (the wrapper allocates it), as are the slots' sums
// beyond kSlotsSmem slots.
#include "common.cuh"

namespace ecp {

constexpr int kMThreads = 1024;
constexpr int kDigit = 11;                 // bits a radix pass
constexpr int kBins = 1 << kDigit;         // 2 a thread
constexpr int kSlotsSmem = 8192;           // slot sums in shared memory up to this b
constexpr int kSortSmem = 16384;           // sort area in shared memory up to this S
static_assert(kBins == 2 * kMThreads, "two bins a thread");

struct MArgs {
  const float* buf_d;           // [B, C] the sorted buffer's distances
  const long long* buf_i;       // [B, C] its ids
  const float* d;               // [B, b, cap] the chunk's distances (real rows of valid slots)
  const long long* leaf_ids;    // [L, cap] item ids of the leaves' rows
  const int* n_rows;            // [L] real rows of each leaf (a prefix)
  const long long* leaf_c;      // [B, b] the slots' leaves
  const bool* lvalid;           // [B, b] the slots that count
  float* out_d;                 // [B, C]
  long long* out_i;             // [B, C]
  int* ends_g;                  // [B, b] scratch when b > kSlotsSmem, else null
  unsigned long long* keys_g;   // [B, S] scratch when S > kSortSmem, else null
  int C, b, cap, L, S;
};

__device__ __forceinline__ unsigned long long low_bits(int n) {
  return n >= 64 ? ~0ull : (1ull << n) - 1;
}

// The tie part of a key from a position, and back (its own inverse).
__device__ __forceinline__ unsigned tie_of(unsigned pos) { return pos; }

// A candidate's key: ascending keys are ascending distances, equal ones in
// position order; -0.0 is folded into +0.0.
__device__ __forceinline__ unsigned long long cand_key(float v, unsigned pos) {
  if (v == 0.0f) v = 0.0f;
  return (static_cast<unsigned long long>(ord_of(v)) << 32) | tie_of(pos);
}

// Inclusive sum over the block of one value a thread; *total gets the
// block's sum.  Synchronises before it returns.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* warp_tot, unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned w = warp_tot[lane];  // kMThreads / 32 = 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  *total = warp_tot[31];
  __syncthreads();  // warp_tot is free again
  return v;
}

// f(key) for every candidate of query i: the buffer's finite entries, then
// the real rows of its valid slots (ends: the slots' inclusive row sums),
// four loads a thread in flight.
template <typename F>
__device__ __forceinline__ void each_candidate(const MArgs& a, int i, const int* ends, int total, F&& f) {
  const float* bd = a.buf_d + static_cast<size_t>(i) * a.C;
  for (int p = threadIdx.x; p < a.C; p += kMThreads) {
    const float v = bd[p];
    if (v < INFINITY) f(cand_key(v, static_cast<unsigned>(p)));
  }
  const float* dq = a.d + static_cast<size_t>(i) * a.b * a.cap;
  constexpr int U = 4;
  int j = 0;
  for (int t0 = threadIdx.x; t0 < total; t0 += U * kMThreads) {
    float v[U];
    unsigned pos[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kMThreads;
      v[u] = INFINITY;
      pos[u] = 0;
      if (t < total) {
        while (ends[j] <= t) ++j;
        const int off = j * a.cap + t - (j ? ends[j - 1] : 0);
        v[u] = __ldg(dq + off);
        pos[u] = static_cast<unsigned>(a.C + off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v[u] < INFINITY) f(cand_key(v[u], pos[u]));
  }
}

__global__ void __launch_bounds__(kMThreads, 1) leaf_merge_kernel(const MArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_warp[32], s_bin, s_before, s_nbin, s_cnt;
  const int i = blockIdx.x, tid = threadIdx.x;
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  const size_t ends_smem = a.ends_g ? 0 : align16(static_cast<size_t>(a.b) * sizeof(int));
  int* ends = a.ends_g ? a.ends_g + static_cast<size_t>(i) * a.b : reinterpret_cast<int*>(smem + kBins * 4);
  unsigned long long* keys = a.keys_g ? a.keys_g + static_cast<size_t>(i) * a.S
                                      : reinterpret_cast<unsigned long long*>(smem + kBins * 4 + ends_smem);

  // each slot's real rows (none in a slot left out), summed
  unsigned carry = 0;
  for (int j0 = 0; j0 < a.b; j0 += kMThreads) {
    const int j = j0 + tid;
    unsigned v = 0;
    if (j < a.b && a.lvalid[static_cast<size_t>(i) * a.b + j]) {
      const long long leaf = a.leaf_c[static_cast<size_t>(i) * a.b + j];
      if (leaf >= 0 && leaf < a.L) v = static_cast<unsigned>(min(max(a.n_rows[leaf], 0), a.cap));
    }
    unsigned tot;
    const unsigned incl = block_scan(v, s_warp, &tot);
    if (j < a.b) ends[j] = static_cast<int>(carry + incl);
    carry += tot;
  }
  __syncthreads();
  const int total = static_cast<int>(carry);

  // radix selection: the keys <= thr are at least C and at most S
  unsigned long long thr = ~0ull;
  if (a.C + total > a.S) {
    unsigned long long prefix = 0, decided = 0;
    unsigned base = 0, rank = static_cast<unsigned>(a.C);  // keys below the range; the C-th's rank in it
    int shift = 64;
    for (;;) {
      const int nb = min(kDigit, shift);
      shift -= nb;
      const unsigned dmask = (1u << nb) - 1;
      for (int q = tid; q < kBins; q += kMThreads) hist[q] = 0;
      __syncthreads();
      each_candidate(a, i, ends, total, [&](unsigned long long k) {
        if ((k & decided) == prefix) atomicAdd(&hist[(k >> shift) & dmask], 1u);
      });
      __syncthreads();
      const unsigned h0 = hist[2 * tid], h1 = hist[2 * tid + 1];
      unsigned in_range;
      const unsigned incl = block_scan(h0 + h1, s_warp, &in_range);
      // fewer than S keys in all (first pass only: later ranges hold more)
      if (base + in_range <= static_cast<unsigned>(a.S)) {
        thr = prefix | low_bits(shift + nb);
        break;
      }
      const unsigned b0 = incl - h0 - h1, b1 = incl - h1;
      if (b0 < rank && rank <= b0 + h0) {
        s_bin = 2 * tid;
        s_before = b0;
        s_nbin = h0;
      }
      if (b1 < rank && rank <= b1 + h1) {
        s_bin = 2 * tid + 1;
        s_before = b1;
        s_nbin = h1;
      }
      __syncthreads();
      base += s_before;
      rank -= s_before;
      prefix |= static_cast<unsigned long long>(s_bin) << shift;
      decided |= static_cast<unsigned long long>(dmask) << shift;
      if (base + s_nbin <= static_cast<unsigned>(a.S) || shift == 0) {
        thr = prefix | low_bits(shift);
        break;
      }
      __syncthreads();  // s_bin and the histogram are rewritten by the next pass
    }
  }

  // collect the keys <= thr, sort them, write the first C
  if (tid == 0) s_cnt = 0;
  __syncthreads();
  each_candidate(a, i, ends, total, [&](unsigned long long k) {
    if (k <= thr) {
      const unsigned at = atomicAdd(&s_cnt, 1u);
      if (at < static_cast<unsigned>(a.S)) keys[at] = k;
    }
  });
  __syncthreads();
  const int n = min(static_cast<int>(s_cnt), a.S);
  const int n2 = pow2_at_least(n > 0 ? n : 1);
  for (int q = n + tid; q < n2; q += kMThreads) keys[q] = kMaxKey;
  __syncthreads();
  block_sort(keys, n2);
  const int m = min(n, a.C);
  const size_t row = static_cast<size_t>(i) * a.C;
  for (int q = tid; q < a.C; q += kMThreads) {
    float v = INFINITY;
    long long id = -1;
    if (q < m) {
      const unsigned pos = tie_of(static_cast<unsigned>(keys[q] & 0xffffffffu));
      if (pos < static_cast<unsigned>(a.C)) {
        v = a.buf_d[row + pos];
        id = a.buf_i[row + pos];
      } else {
        const int off = static_cast<int>(pos - a.C), slot = off / a.cap;
        v = a.d[static_cast<size_t>(i) * a.b * a.cap + off];
        id = a.leaf_ids[static_cast<size_t>(a.leaf_c[static_cast<size_t>(i) * a.b + slot]) * a.cap + off % a.cap];
      }
    }
    a.out_d[row + q] = v;
    a.out_i[row + q] = id;
  }
}

}  // namespace ecp

extern "C" {

// All pointers are device pointers of contiguous tensors: buf_d [B, C]
// float32, buf_i [B, C] int64, d [B, b, cap] float32, leaf_ids [L, cap]
// int64, n_rows [L] int32, leaf_c [B, b] int64, lvalid [B, b] bool; out_d
// [B, C] float32 and out_i [B, C] int64 written whole; ends [B, b] int32
// scratch when b > 8192, else null; keys [B, S] uint64 scratch when S >
// 16384, else null.  S: the sort area's keys, a power of two >= C.  C + b
// * cap must stay below 2^31.  Returns a cudaError_t (0 on success).
int leaf_merge_launch(const void* buf_d, const void* buf_i, const void* d, const void* leaf_ids,
                      const void* n_rows, const void* leaf_c, const void* lvalid, void* out_d, void* out_i,
                      void* ends, void* keys, int B, int C, int b, int cap, int L, int S, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (b < 0 || cap < 0 || L < 0 || S < C || (S & (S - 1)) != 0 ||
      static_cast<long long>(C) + static_cast<long long>(b) * cap >= (1ll << 31) ||
      (b > ecp::kSlotsSmem && ends == nullptr) || (S > ecp::kSortSmem && keys == nullptr))
    return cudaErrorInvalidValue;
  ecp::MArgs a{static_cast<const float*>(buf_d), static_cast<const long long*>(buf_i),
               static_cast<const float*>(d), static_cast<const long long*>(leaf_ids),
               static_cast<const int*>(n_rows), static_cast<const long long*>(leaf_c),
               static_cast<const bool*>(lvalid), static_cast<float*>(out_d), static_cast<long long*>(out_i),
               b > ecp::kSlotsSmem ? static_cast<int*>(ends) : nullptr,
               S > ecp::kSortSmem ? static_cast<unsigned long long*>(keys) : nullptr, C, b, cap, L, S};
  size_t smem = ecp::kBins * sizeof(unsigned);
  if (a.ends_g == nullptr) smem += ecp::align16(static_cast<size_t>(b) * sizeof(int));
  if (a.keys_g == nullptr) smem += static_cast<size_t>(S) * sizeof(unsigned long long);
  const void* kern = reinterpret_cast<const void*>(ecp::leaf_merge_kernel);
  cudaError_t e = ecp::allow_smem(0, kern, smem);
  if (e != cudaSuccess) return e;
  ecp::leaf_merge_kernel<<<B, ecp::kMThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
