// Kernel A: fused inverse-CDF resample (forward only).
//
// Replaces the TPU kernel _invert_cdf_kernel of
// nerfsr_tpu/ops/experimental/pallas_sampling.py (pallas_invert_cdf). It
// computes what core/sampling.py:_invert_cdf computes: eps 1e-5 added to
// the weights, normalised PDF (each weight divided by the total, then
// scanned), inclusive cumsum with a zero prefix, searchsorted (right),
// below/above clamp, degenerate denominator -> 1, then the lerp inside
// the bin. Any bin count B >= 2, as the JAX package takes, and any u
// (sorted or not, inside [0, 1) or not).
//
// Bound on the card: bytes. Per ray it reads B - 1 weights, Q queries and
// the bins the queries land in, and writes Q; the arithmetic is O(B + Q
// log B). A call at the slice's shapes (N = 4096, B <= 47) moves ~1 MB, a
// third of a microsecond at the memory rate, so what bounds it in
// practice is latency: the launch, the number of warps in flight to hide
// load latency with, and the longest chain of dependent loads a ray
// takes. No triangular matmul and no one-hot selects: those were TPU
// formulations of a prefix sum and a gather.
//
// Three routes, picked by the launcher for (N, B) (make_plan; the
// launch is exported as nerfsr_invert_cdf_route):
// - register (B <= kMaxBins = 128, every preset): one warp per ray,
//   kWarps rays a block. Lane l reads elements l, l + 32, ... of the
//   ray's rows (coalesced) into registers with compile-time indices, the
//   total is a shuffle-xor tree (every lane ends with the same bits), the
//   CDF a lane-local serial sum over each lane's ceil((B-1)/32)
//   contiguous elements plus a shuffle-up scan of the lane sums, in
//   static shared memory beside the bins; each lane then takes queries
//   lane, lane + 32, ...: a binary search (searchsorted-right; the CDF is
//   non-decreasing, so it equals the TPU kernel's compare-all count), the
//   bins gathered from shared memory, z written coalesced.
// - shared (128 < B <= kEightWarpBins = 16384): a warp a ray to
//   kOneWarpBins (8 rays a block), then a block of 8 warps a ray. The
//   row is read coalesced, kLoadU loads in flight, its w + eps parked in
//   dynamic shared memory where its CDF entry goes, laid out linearly (no
//   padding). scan_chunk then makes the CDF in place: each warp takes a
//   segment of consecutive entries and scans it 128 at a time, lane l
//   taking entries 4l .. 4l + 3 as one float4 (conflict-free), a 4-entry
//   serial sum, a shuffle scan of the lane sums, a carry from sub-chunk
//   to sub-chunk; the segments' offsets follow from their last entries,
//   and a second pass adds them: two barriers a ray whatever B. The
//   queries are spread over every thread of the ray, kQU at a time, each
//   a search of a fixed ceil(log2 B) halvings by selects, so no lane
//   diverges; the two bins are gathered from the input row (past ~2 Q
//   bins a ray most of the row is never needed).
// - streamed (past that; measured faster at 30,000 bins than 8 warps a
//   ray holding the whole CDF in shared memory): a block of kStreamWarps
//   warps a ray and no workspace. One pass over w gives the total; a
//   second reads the row kChunk entries at a time into shared memory and
//   scans them the same way, keeping only the current chunk's CDF (and
//   the entry before it); each query whose u falls in the chunk is
//   searched and finished there, its bins gathered from the input row;
//   those at or above the row's last CDF entry take the clamp at the
//   end. A call allocates nothing but z.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                // rays a block
constexpr int kMaxBins = 128;            // the register route's widest row
constexpr int kPerLane = kMaxBins / 32;  // row elements a lane
constexpr float kEps = 1e-5f;

// Each lane's queries q = lane, lane + 32, ...: searchsorted-right by a
// binary search over the ray's CDF, the below/above clamp, the degenerate
// denominator -> 1 and the lerp between the gathered bins.
__device__ __forceinline__ void queries(const float* cdf, const float* sb,
                                        const float* __restrict__ ur,
                                        float* __restrict__ zr, int nb,
                                        int nq, int lane, float u_first) {
  for (int q = lane; q < nq; q += 32) {
    const float uq = q == lane ? u_first : ur[q];
    int lo = 0, hi = nb;  // first index with cdf > uq == #{cdf <= uq}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= uq) lo = mid + 1;
      else hi = mid;
    }
    const int below = max(lo - 1, 0);
    const int above = min(lo, nb - 1);
    const float cb = cdf[below], ca = cdf[above];
    const float bb = sb[below], ba = sb[above];
    float denom = ca - cb;
    if (denom < kEps) denom = 1.f;
    const float t = (uq - cb) / denom;
    zr[q] = bb + t * (ba - bb);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
invert_cdf_kernel(const float* __restrict__ bins, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ z, int n,
                  int nb, int nq) {
  __shared__ float s_cdf[kWarps][kMaxBins];
  __shared__ float s_bins[kWarps][kMaxBins];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= n) return;  // a whole warp leaves together
  const int nw = nb - 1;
  const float* wr = w + (size_t)r * nw;
  const float* br = bins + (size_t)r * nb;
  float* cdf = s_cdf[warp];
  float* sb = s_bins[warp];
  const float* ur = u + (size_t)r * nq;
  float* zr = z + (size_t)r * nq;
  // the lane's first query, loaded with the row rather than after the CDF
  const float u_first = lane < nq ? ur[lane] : 0.f;

  // coalesced loads: lane l holds weights l, l + 32, ... (0 past the row)
  float v[kPerLane];
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < nw ? wr[i] + kEps : 0.f;
    total += v[k];
    if (i < nb) sb[i] = br[i];
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    total += __shfl_xor_sync(kFull, total, m);
  // pdf_i parked at cdf[i + 1]
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int i = lane + 32 * k;
    if (i < nw) cdf[i + 1] = v[k] / total;
  }
  __syncwarp();

  // CDF: lane l sums its contiguous run [l * run, l * run + run) serially,
  // then the lane sums are scanned; each lane rewrites only its own run
  const int run = (nw + 31) >> 5;
  const int first = lane * run;
  float pre[kPerLane];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (j < run && first + j < nw) acc += cdf[first + j + 1];
    pre[j] = acc;
  }
  float incl = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (j < run && first + j < nw) cdf[first + j + 1] = excl + pre[j];
  if (lane == 0) cdf[0] = 0.f;
  __syncwarp();

  queries(cdf, sb, ur, zr, nb, nq, lane, u_first);
}

// ---------------------------------------------------------------------
// The wide routes (B > kMaxBins)

constexpr int kQU = 2;          // queries a thread searches side by side
constexpr int kLoadU = 8;       // row loads a thread keeps in flight
constexpr int kSub = 128;       // CDF entries a warp scans at a time
// warps a ray on the shared route, by bin count, and where streaming
// starts (measured on the H100: PERF.md)
constexpr int kOneWarpBins = 1024;    // up to here a warp a ray
constexpr int kEightWarpBins = 16384; // then 8; past it the streamed route
constexpr int kStreamWarps = 8;       // warps a ray on the streamed route
constexpr int kChunk = 2048;          // CDF entries a chunk when streamed

// Geometry of a wide kernel with WPR warps a ray (1, or a block of 8):
// T threads a ray, R rays a block of 256 threads, and the floats a ray
// keeps after its row (the warp totals, the segments' last entries;
// 16-byte multiples).
template <int WPR>
struct Wide {
  static_assert(WPR == 1 || WPR == 8, "a warp a ray, or a block");
  static constexpr int T = 32 * WPR;
  static constexpr int R = 8 / WPR;
  static constexpr int kThreads = R * T;
  static constexpr int kTail = 4 * ((2 * WPR + 3) / 4);
};

// the barrier of one ray's threads: the warp's, or the block's
template <int WPR>
__device__ __forceinline__ void ray_sync() {
  if constexpr (WPR == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// inclusive scan across the warp (Hillis-Steele, shuffle-up)
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// the register route's arithmetic after the search: clamp, eps rule, lerp
__device__ __forceinline__ float lerp_bin(float uq, float cb, float ca,
                                          float bb, float ba) {
  float denom = ca - cb;
  if (denom < kEps) denom = 1.f;
  const float t = (uq - cb) / denom;
  return bb + t * (ba - bb);
}

// #{p < len : a[p] <= x}, searchsorted-right on a non-decreasing a: a
// fixed ceil(log2 len) halvings, each a select, so the lanes of a warp
// never diverge
__device__ __forceinline__ int upper_bound(const float* a, int len,
                                           float x) {
  int base = 0;
  for (int m = len; m > 1;) {
    const int half = m >> 1;
    base = a[base + half] <= x ? base + half : base;
    m -= half;
  }
  return base + (a[base] <= x);
}

// Copies w + eps of entries [i0, i1) of the row wr into dst (entry i at
// dst[i - i0]), threads t, t + T, ... coalesced with kLoadU loads in
// flight, and returns each thread's serial sum of what it copied.
template <int WPR>
__device__ __forceinline__ float load_row(const float* __restrict__ wr,
                                          int i0, int i1, float* dst,
                                          int t) {
  constexpr int T = Wide<WPR>::T;
  float sum = 0.f;
  for (int j0 = i0 + t; j0 < i1; j0 += T * kLoadU) {
    float v[kLoadU];
#pragma unroll
    for (int k = 0; k < kLoadU; ++k) {
      const int i = j0 + k * T;
      v[k] = i < i1 ? __ldg(wr + i) + kEps : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kLoadU; ++k) {
      const int i = j0 + k * T;
      if (dst != nullptr && i < i1) dst[i - i0] = v[k];
      sum += v[k];
    }
  }
  return sum;
}

// The ray's total from each thread's serial sum: a shuffle-xor tree over
// the warp, then the warp totals in warp order (s_red: WPR floats).
// Every thread of the ray returns the same bits.
template <int WPR>
__device__ __forceinline__ float ray_total(float sum, int t,
                                           float* s_red) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(kFull, sum, m);
  if constexpr (WPR > 1) {
    if ((t & 31) == 0) s_red[t >> 5] = sum;
    ray_sync<WPR>();
    sum = 0.f;
#pragma unroll
    for (int k = 0; k < WPR; ++k) sum += s_red[k];
  }
  return sum;
}

// The CDF of m entries in place: row[i] (16-byte aligned) holds w_i +
// eps on entry and CDF entry i + 1 on exit; row[-1] is the entry before
// (0, or the previous chunk's last). Warp w takes the segment [w S, (w +
// 1) S) of S (a multiple of kSub) consecutive entries and scans it kSub
// at a time: lane l loads entries 4l .. 4l + 3 of the sub-chunk as one
// float4 (conflict-free), divides them by the total, sums them serially,
// the lane sums are scanned by shuffles and a carry runs from sub-chunk
// to sub-chunk. Then each warp's offset is row[-1] plus the segments
// before it (their last local entries, in order: the same bits as their
// final last entries) and a second pass adds it. Two barriers, whatever
// m. s_last: WPR floats.
template <int WPR>
__device__ __forceinline__ void scan_chunk(float* row, int m, float total,
                                           float* s_last, int t) {
  const int lane = t & 31, warp = t >> 5;
  const int seg = (m + WPR * kSub - 1) / (WPR * kSub) * kSub;
  const int s0 = min(warp * seg, m), s1 = min(s0 + seg, m);
  float carry = 0.f;
  for (int c = s0; c < s1; c += kSub) {
    const int i = c + 4 * lane;
    const float4 v = *reinterpret_cast<const float4*>(row + i);
    const float p0 = i < s1 ? v.x / total : 0.f;
    const float p1 = p0 + (i + 1 < s1 ? v.y / total : 0.f);
    const float p2 = p1 + (i + 2 < s1 ? v.z / total : 0.f);
    const float p3 = p2 + (i + 3 < s1 ? v.w / total : 0.f);
    const float incl = warp_scan(p3, lane);
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float b = carry + excl;
    const float4 o = make_float4(b + p0, b + p1, b + p2, b + p3);
    if (i + 3 < s1) {
      *reinterpret_cast<float4*>(row + i) = o;
    } else {
      if (i < s1) row[i] = o.x;
      if (i + 1 < s1) row[i + 1] = o.y;
      if (i + 2 < s1) row[i + 2] = o.z;
    }
    carry = __shfl_sync(kFull, o.w, 31);
  }
  if constexpr (WPR > 1) {
    if (lane == 0) s_last[warp] = carry;
    ray_sync<WPR>();
  }
  float off = row[-1];
  for (int k = 0; k < warp; ++k) off = off + s_last[k];
  if (off != 0.f) {  // 0 + x is x: warp 0 of a chunk that starts at 0
    for (int c = s0; c < s1; c += kSub) {
      const int i = c + 4 * lane;
      if (i + 3 < s1) {
        float4 v = *reinterpret_cast<const float4*>(row + i);
        v.x = off + v.x;
        v.y = off + v.y;
        v.z = off + v.z;
        v.w = off + v.w;
        *reinterpret_cast<float4*>(row + i) = v;
      } else {
        for (int k = i; k < s1; ++k) row[k] = off + row[k];
      }
    }
  }
  ray_sync<WPR>();
}

// Floats of dynamic shared memory a ray on the shared route: 4 (the zero
// prefix at index 3, so that the entries start 16-byte aligned), the row
// rounded up to kSub, the warp totals and the segments' last entries.
template <int WPR>
__host__ __device__ __forceinline__ int shared_floats(int nb) {
  return 4 + (nb - 1 + kSub - 1) / kSub * kSub + Wide<WPR>::kTail;
}

// and on the streamed route (a ray a block): two chunk buffers of the
// same layout, the warp totals, the segments' last entries
template <int WPR>
__host__ __device__ __forceinline__ int streamed_floats() {
  return 2 * (4 + kChunk) + Wide<WPR>::kTail;
}

// The shared route: R rays a block, WPR warps a ray. The row's w + eps
// goes to shared memory at CDF entry i + 1 as it is summed; scan_chunk
// makes the CDF in place; then the ray's threads take its queries, kQU
// at a time, each a branch-free search over the CDF in shared memory,
// and gather the two bins from the input row.
template <int WPR>
__global__ void __launch_bounds__(Wide<WPR>::kThreads)
invert_cdf_wide_kernel(const float* __restrict__ bins,
                       const float* __restrict__ w,
                       const float* __restrict__ u, float* __restrict__ z,
                       int n, int nb, int nq) {
  using G = Wide<WPR>;
  extern __shared__ __align__(16) float s_wide[];
  const int slot = threadIdx.x / G::T, t = threadIdx.x % G::T;
  const int r = blockIdx.x * G::R + slot;
  if (r >= n) return;  // a ray's threads leave together
  const int nw = nb - 1;
  float* base = s_wide + (size_t)slot * shared_floats<WPR>(nb);
  float* cdf = base + 3;
  float* s_red = base + shared_floats<WPR>(nb) - G::kTail;
  float* s_last = s_red + WPR;
  const float* br = bins + (size_t)r * nb;
  const float* ur = u + (size_t)r * nq;
  float* zr = z + (size_t)r * nq;

  // the first queries, loaded with the row rather than after the CDF
  float uq[kQU];
#pragma unroll
  for (int k = 0; k < kQU; ++k) {
    const int q = t + k * G::T;
    uq[k] = q < nq ? __ldg(ur + q) : 0.f;
  }
  const float sum = load_row<WPR>(w + (size_t)r * nw, 0, nw, cdf + 1, t);
  const float total = ray_total<WPR>(sum, t, s_red);
  if (t == 0) cdf[0] = 0.f;
  ray_sync<WPR>();
  scan_chunk<WPR>(cdf + 1, nw, total, s_last, t);

  for (int q0 = t; q0 < nq; q0 += G::T * kQU) {
    // queries q0 + k T of this thread; those with k >= active are past
    // nq for every thread of the ray
    const int active = min(kQU, (nq - (q0 - t) + G::T - 1) / G::T);
    if (q0 != t) {
#pragma unroll
      for (int k = 0; k < kQU; ++k) {
        const int q = q0 + k * G::T;
        uq[k] = q < nq ? __ldg(ur + q) : 0.f;
      }
    }
    int lo[kQU];
#pragma unroll
    for (int k = 0; k < kQU; ++k) lo[k] = 0;
    for (int m = nb; m > 1;) {  // upper_bound, the searches side by side
      const int half = m >> 1;
#pragma unroll
      for (int k = 0; k < kQU; ++k)
        if (k < active)
          lo[k] = cdf[lo[k] + half] <= uq[k] ? lo[k] + half : lo[k];
      m -= half;
    }
#pragma unroll
    for (int k = 0; k < kQU; ++k) {
      const int q = q0 + k * G::T;
      if (q >= nq) continue;
      const int cnt = lo[k] + (cdf[lo[k]] <= uq[k]);
      const int below = max(cnt - 1, 0), above = min(cnt, nb - 1);
      zr[q] = lerp_bin(uq[k], cdf[below], cdf[above], __ldg(br + below),
                       __ldg(br + above));
    }
  }
}

// The streamed route, for rays past kEightWarpBins (and whatever a
// block's shared memory holds): a block a ray. One pass over w gives the
// total; a second reads the row kChunk entries at a time into one of two
// chunk buffers, whose entry 0 is the entry before the chunk, and
// scan_chunk makes its CDF.
// After each chunk, each query with lo <= u < hi (the chunk's first and
// last entries) is searched inside the chunk and finished there, its
// bins gathered from the input row. Chunk c + 1 starts at the stored last
// entry of chunk c, so the ranges tile [0, the row's last entry) and
// every query is finished once; those at or above the last entry (and
// below 0) take the clamp at the end.
template <int WPR>
__global__ void __launch_bounds__(Wide<WPR>::kThreads)
invert_cdf_stream_kernel(const float* __restrict__ bins,
                         const float* __restrict__ w,
                         const float* __restrict__ u, float* __restrict__ z,
                         int n, int nb, int nq) {
  using G = Wide<WPR>;
  static_assert(G::R == 1 && kChunk % kSub == 0, "a ray a block");
  extern __shared__ __align__(16) float s_wide[];
  const int t = threadIdx.x, r = blockIdx.x;
  if (r >= n) return;
  const int nw = nb - 1;
  float* s_red = s_wide + 2 * (4 + kChunk);
  float* s_last = s_red + WPR;
  const float* wr = w + (size_t)r * nw;
  const float* br = bins + (size_t)r * nb;
  const float* ur = u + (size_t)r * nq;
  float* zr = z + (size_t)r * nq;

  const float total =
      ray_total<WPR>(load_row<WPR>(wr, 0, nw, nullptr, t), t, s_red);
  float carry = 0.f;
  for (int c0 = 0, c = 0; c0 < nw; c0 += kChunk, ++c) {
    float* buf = s_wide + (c & 1) * (4 + kChunk) + 3;
    const int m = min(kChunk, nw - c0);
    if (t == 0) buf[0] = carry;
    load_row<WPR>(wr, c0, c0 + m, buf + 1, t);
    ray_sync<WPR>();
    scan_chunk<WPR>(buf + 1, m, total, s_last, t);
    const float lo = buf[0], hi = buf[m];
    carry = hi;
    for (int q = t; q < nq; q += G::T) {
      const float uq = __ldg(ur + q);
      if (lo <= uq && uq < hi) {
        const int cnt = upper_bound(buf, m + 1, uq);  // 1 <= cnt <= m
        zr[q] = lerp_bin(uq, buf[cnt - 1], buf[cnt],
                         __ldg(br + c0 + cnt - 1), __ldg(br + c0 + cnt));
      }
    }
  }
  const float b0 = __ldg(br), blast = __ldg(br + nw);
  for (int q = t; q < nq; q += G::T) {
    const float uq = __ldg(ur + q);
    if (uq >= carry)  // searchsorted gives B: below = above = B - 1
      zr[q] = lerp_bin(uq, carry, carry, blast, blast);
    else if (!(uq >= 0.f))  // below the zero prefix (or NaN): 0 and 0
      zr[q] = lerp_bin(uq, 0.f, 0.f, b0, b0);
  }
}

// does nothing: timing it gives the cost of a launch itself
__global__ void empty_kernel() {}

enum Route { kRegisterRoute = 0, kSharedRoute = 1, kStreamedRoute = 2 };

// The launch kernel A takes for (n, nb) on this card.
struct Plan {
  int route, blocks, threads, smem, wpr, chunk;
};

template <int WPR>
cudaError_t opt_in(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      invert_cdf_wide_kernel<WPR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if constexpr (WPR == kStreamWarps) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(invert_cdf_stream_kernel<WPR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
  }
  return err;
}

// The largest dynamic shared memory a block may take on this card (the
// port runs on one), and the wide kernels' opt-in to it: once, at the
// first call, which runs before any CUDA graph captures kernel A.
int wide_setup(int* smem_max) {
  static int max_bytes = -1;
  if (max_bytes < 0) {
    int dev = 0, bytes = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = opt_in<1>(bytes);
    if (err == cudaSuccess) err = opt_in<8>(bytes);
    if (err != cudaSuccess) return (int)err;
    max_bytes = bytes;
  }
  *smem_max = max_bytes;
  return 0;
}

template <int WPR>
bool shared_plan(int n, int nb, int smem_max, Plan* p) {
  using G = Wide<WPR>;
  const size_t bytes = sizeof(float) * G::R * shared_floats<WPR>(nb);
  if (bytes > (size_t)smem_max) return false;
  *p = {kSharedRoute, (n + G::R - 1) / G::R, G::kThreads, (int)bytes, WPR,
        0};
  return true;
}

int make_plan(int n, int nb, Plan* p) {
  if (nb <= kMaxBins) {
    *p = {kRegisterRoute, (n + kWarps - 1) / kWarps, kWarps * 32, 0, 1, 0};
    return 0;
  }
  int smem_max = 0;
  const int err = wide_setup(&smem_max);
  if (err) return err;
  const bool shared = nb <= kOneWarpBins ? shared_plan<1>(n, nb, smem_max, p)
                      : nb <= kEightWarpBins
                          ? shared_plan<8>(n, nb, smem_max, p)
                          : false;
  if (!shared)
    *p = {kStreamedRoute, n, Wide<kStreamWarps>::kThreads,
          (int)(sizeof(float) * streamed_floats<kStreamWarps>()),
          kStreamWarps, kChunk};
  return 0;
}

}  // namespace

// The launch kernel A takes for bins (n, nb) on this card: out[0] the
// route (0 register, 1 shared, 2 streamed), out[1] blocks, out[2]
// threads a block, out[3] dynamic shared bytes a block, out[4] warps a
// ray, out[5] CDF entries a chunk (streamed).
NERFSR_API int nerfsr_invert_cdf_route(int n, int nb, int* out) {
  if (nb < 2) return (int)cudaErrorInvalidValue;
  Plan p;
  const int err = make_plan(n, nb, &p);
  if (err) return err;
  const int fields[6] = {p.route, p.blocks, p.threads,
                         p.smem,  p.wpr,    p.chunk};
  for (int k = 0; k < 6; ++k) out[k] = fields[k];
  return 0;
}

// bins (n, nb), w (n, nb - 1), u (n, nq) -> z (n, nq), f32, row-major;
// any nb >= 2, no workspace
NERFSR_API int nerfsr_invert_cdf(const void* bins, const void* w,
                                 const void* u, void* z, int n, int nb,
                                 int nq, void* stream) {
  if (nb < 2) return (int)cudaErrorInvalidValue;
  if (n <= 0 || nq <= 0) return 0;
  Plan p;
  const int err = make_plan(n, nb, &p);
  if (err) return err;
  auto st = (cudaStream_t)stream;
  auto b = (const float*)bins;
  auto wf = (const float*)w;
  auto uf = (const float*)u;
  auto zf = (float*)z;
  if (p.route == kRegisterRoute) {
    invert_cdf_kernel<<<p.blocks, p.threads, 0, st>>>(b, wf, uf, zf, n, nb,
                                                      nq);
  } else if (p.route == kStreamedRoute) {
    invert_cdf_stream_kernel<kStreamWarps>
        <<<p.blocks, p.threads, p.smem, st>>>(b, wf, uf, zf, n, nb, nq);
  } else if (p.wpr == 1) {
    invert_cdf_wide_kernel<1><<<p.blocks, p.threads, p.smem, st>>>(
        b, wf, uf, zf, n, nb, nq);
  } else {
    invert_cdf_wide_kernel<8><<<p.blocks, p.threads, p.smem, st>>>(
        b, wf, uf, zf, n, nb, nq);
  }
  return (int)cudaGetLastError();
}

// the launch floor, a measurement aid: an empty kernel on this grid
NERFSR_API int nerfsr_empty_kernel(int blocks, int threads, void* stream) {
  if (blocks <= 0 || threads <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// error text for the Python side (one definition for the whole library)
NERFSR_API const char* nerfsr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
