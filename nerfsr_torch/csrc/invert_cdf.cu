// Kernel A: fused inverse-CDF resample (forward only).
//
// Replaces the TPU kernel _invert_cdf_kernel of
// nerfsr_tpu/ops/experimental/pallas_sampling.py (pallas_invert_cdf). It
// computes what core/sampling.py:_invert_cdf computes: eps 1e-5 added to
// the weights, normalised PDF (each weight divided by the total, then
// scanned), inclusive cumsum with a zero prefix, searchsorted (right),
// below/above clamp, degenerate denominator -> 1, then the lerp inside
// the bin. Any bin count B >= 2, as the JAX package takes.
//
// Bound on the card: bytes. Per ray it reads B + (B-1) + Q floats and
// writes Q; the arithmetic is O(B + Q log B). A call at the slice's
// shapes (N = 4096, B <= 47) moves ~1 MB, a third of a microsecond at the
// memory rate, so what bounds it in practice is latency: the launch, the
// number of warps in flight to hide load latency with, and the longest
// chain of dependent loads a ray takes.
//
// Design: one warp per ray, kWarps rays a block (N warps in all, so the
// serving chunk puts 4096 warps on 132 SMs). Lane l reads elements l,
// l + 32, ... of the ray's rows, so every warp load is coalesced, and each
// row is read once. The total is a shuffle-xor tree (every lane ends with
// the same bits). The normalised weights go to shared memory; the CDF is
// a lane-local serial sum over each lane's ceil((B-1)/32) contiguous
// elements plus an inclusive shuffle-up scan of the lane sums, written
// back in place beside the row's bins. Each lane then takes queries
// lane, lane + 32, ...: u is read coalesced (the first query with the
// row, so its load overlaps the CDF's build), a binary search over the
// shared CDF gives searchsorted-right (the CDF is non-decreasing, so it
// equals the TPU kernel's compare-all count), the bins are gathered from
// shared memory and z is written coalesced. No triangular matmul and no
// one-hot selects: those were TPU formulations of a prefix sum and a
// gather.
//
// Two routes of that design:
// - B <= kMaxBins (128, every preset): invert_cdf_kernel keeps a lane's
//   row elements in registers with compile-time indices (kPerLane of
//   them) and the row in static shared memory, so nothing lives in local
//   memory.
// - B > kMaxBins: invert_cdf_wide_kernel keeps the ray's CDF and bins in
//   dynamic shared memory (8 B + 128 bytes a ray, as many rays a block as
//   fit, at most kWarps) and replaces the register arrays by loops whose
//   trip counts are known at run time: the weights (+ eps) go straight to
//   shared memory, each lane sums its contiguous run there serially
//   (leaving its local prefix in place), the lane totals are scanned
//   across the warp and a last pass adds each lane's offset. A run is
//   the power of two at or above (B-1)/32 elements, and the CDF is laid
//   out with one padding word after each run (Padded), so the 32 lanes'
//   runs start an odd number of words apart and every lane-serial access
//   of the warp falls in its own bank: unpadded, runs of 32 or 128
//   elements put all 32 lanes in one bank, and bank conflicts took ~75%
//   of the time at 1024 and 4097 bins. Where one ray's CDF and bins
//   exceed a block's shared memory (~29 K bins on the H100), the same
//   kernel keeps the CDF, in the same layout, in a device-memory
//   workspace of B + 32 floats a ray that the wrapper allocates, and
//   gathers the bins from the input row. That route is slower than the
//   plain version (PERF.md); no preset comes near it.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                // rays a block
constexpr int kMaxBins = 128;            // the register route's widest row
constexpr int kPerLane = kMaxBins / 32;  // row elements a lane
constexpr float kEps = 1e-5f;

// Where CDF entry p (p = 0 the zero prefix, p = i + 1 after weight i)
// lies: contiguous on the register route; on the wide route, whose lane
// l owns the run of weights [l * 2^lg, (l + 1) * 2^lg), one padding word
// after each run (weight i at i + 1 + i / 2^lg).
struct Flat {
  __device__ __forceinline__ int operator()(int p) const { return p; }
};
struct Padded {
  int lg;
  __device__ __forceinline__ int operator()(int p) const {
    return p + max((p - 1) >> lg, 0);
  }
};

// Each lane's queries q = lane, lane + 32, ...: searchsorted-right by a
// binary search over the ray's CDF, the below/above clamp, the degenerate
// denominator -> 1 and the lerp between the gathered bins.
template <class At>
__device__ __forceinline__ void queries(const float* cdf, At at,
                                        const float* sb,
                                        const float* __restrict__ ur,
                                        float* __restrict__ zr, int nb,
                                        int nq, int lane, float u_first) {
  for (int q = lane; q < nq; q += 32) {
    const float uq = q == lane ? u_first : ur[q];
    int lo = 0, hi = nb;  // first index with cdf > uq == #{cdf <= uq}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[at(mid)] <= uq) lo = mid + 1;
      else hi = mid;
    }
    const int below = max(lo - 1, 0);
    const int above = min(lo, nb - 1);
    const float cb = cdf[at(below)], ca = cdf[at(above)];
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

  queries(cdf, Flat{}, sb, ur, zr, nb, nq, lane, u_first);
}

// Floats of CDF a ray on the wide route: B entries and a padding word
// after each lane's run.
__host__ __device__ __forceinline__ int wide_cdf_floats(int nb) {
  return nb + 32;
}

// The wide route (B > kMaxBins). Rays a block: `rays` (<= kWarps), each
// with 2 B + 32 floats of dynamic shared memory (the padded CDF, then the
// bins), or, when ws is given, with its CDF at ws + r * (B + 32) in device
// memory and its bins read from the input row.
__global__ void __launch_bounds__(kWarps * 32)
invert_cdf_wide_kernel(const float* __restrict__ bins,
                       const float* __restrict__ w,
                       const float* __restrict__ u, float* __restrict__ z,
                       float* __restrict__ ws, int n, int nb, int nq,
                       int rays) {
  extern __shared__ float s_wide[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * rays + warp;
  if (warp >= rays || r >= n) return;  // whole warps leave together
  const int nw = nb - 1;
  const float* wr = w + (size_t)r * nw;
  const float* br = bins + (size_t)r * nb;
  float* cdf;
  const float* sb;
  const int cdf_floats = wide_cdf_floats(nb);
  if (ws != nullptr) {
    cdf = ws + (size_t)r * cdf_floats;
    sb = br;
  } else {
    cdf = s_wide + (size_t)warp * (cdf_floats + nb);
    float* bs = cdf + cdf_floats;
    for (int i = lane; i < nb; i += 32) bs[i] = br[i];
    sb = bs;
  }
  const float* ur = u + (size_t)r * nq;
  float* zr = z + (size_t)r * nq;
  const float u_first = lane < nq ? ur[lane] : 0.f;

  // a lane's run: the power of two at or above ceil(nw / 32) (>= 4)
  const int lg = 32 - __clz((nw + 31) / 32 - 1);
  const int run = 1 << lg;

  // coalesced loads: weights + eps parked at entry i + 1, and the total
  float total = 0.f;
  for (int i = lane; i < nw; i += 32) {
    const float v = wr[i] + kEps;
    cdf[i + 1 + (i >> lg)] = v;
    total += v;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    total += __shfl_xor_sync(kFull, total, m);
  __syncwarp();

  // CDF: lane l normalises and sums its contiguous run [l * run, l * run +
  // run) serially, leaving the run's inclusive prefix in place; the lane
  // sums are scanned; each lane then adds its offset to its own run. The
  // run's entries lie at i + 1 + lane: a stride of run + 1 (odd) between
  // lanes, one bank each.
  const int first = lane * run;
  const int last = min(first + run, nw);
  float* mine = cdf + 1 + lane;
  float acc = 0.f;
  for (int i = first; i < last; ++i) {
    acc += mine[i] / total;
    mine[i] = acc;
  }
  float incl = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int i = first; i < last; ++i) mine[i] = excl + mine[i];
  if (lane == 0) cdf[0] = 0.f;
  __syncwarp();

  queries(cdf, Padded{lg}, sb, ur, zr, nb, nq, lane, u_first);
}

// does nothing: timing it gives the cost of a launch itself
__global__ void empty_kernel() {}

// The largest dynamic shared memory a block may take on this card (the
// port runs on one), and the wide kernel's opt-in to it: once, at the
// first call, which runs before any CUDA graph captures kernel A.
int wide_setup(int* smem_max) {
  static int max_bytes = -1;
  if (max_bytes < 0) {
    int dev = 0, bytes = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(invert_cdf_wide_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err != cudaSuccess) return (int)err;
    max_bytes = bytes;
  }
  *smem_max = max_bytes;
  return 0;
}

// Rays a block of the wide route, and the shared memory they take; 0
// rays when one ray's CDF and bins do not fit (the workspace route).
int wide_rays(int nb, int smem_max, size_t* smem) {
  const size_t per_ray = sizeof(float) * ((size_t)wide_cdf_floats(nb) + nb);
  const size_t fit = (size_t)smem_max / per_ray;
  const int rays = fit < (size_t)kWarps ? (int)fit : kWarps;
  *smem = rays * per_ray;
  return rays;
}

}  // namespace

// Device floats of workspace a ray that kernel A needs at nb bins: nb +
// 32 where one ray's CDF and bins exceed a block's shared memory, else 0.
NERFSR_API int nerfsr_invert_cdf_workspace(int nb, int* floats_per_ray) {
  int smem_max = 0;
  const int err = wide_setup(&smem_max);
  if (err) return err;
  size_t smem = 0;
  *floats_per_ray = nb > kMaxBins && wide_rays(nb, smem_max, &smem) == 0
                        ? wide_cdf_floats(nb)
                        : 0;
  return 0;
}

// bins (n, nb), w (n, nb - 1), u (n, nq) -> z (n, nq), f32, row-major;
// ws: null, or as many floats a ray as nerfsr_invert_cdf_workspace asks
// for.
NERFSR_API int nerfsr_invert_cdf_ws(const void* bins, const void* w,
                                    const void* u, void* z, void* ws, int n,
                                    int nb, int nq, void* stream) {
  if (nb < 2) return (int)cudaErrorInvalidValue;
  if (n <= 0 || nq <= 0) return 0;
  auto st = (cudaStream_t)stream;
  if (nb <= kMaxBins) {
    invert_cdf_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        (const float*)bins, (const float*)w, (const float*)u, (float*)z, n,
        nb, nq);
    return (int)cudaGetLastError();
  }
  int smem_max = 0;
  const int err = wide_setup(&smem_max);
  if (err) return err;
  size_t smem = 0;
  int rays = wide_rays(nb, smem_max, &smem);
  if (rays == 0) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    rays = kWarps;
  } else {
    ws = nullptr;
  }
  invert_cdf_wide_kernel<<<(n + rays - 1) / rays, kWarps * 32, smem, st>>>(
      (const float*)bins, (const float*)w, (const float*)u, (float*)z,
      (float*)ws, n, nb, nq, rays);
  return (int)cudaGetLastError();
}

// the same with no workspace: every bin count whose rays fit in shared
// memory
NERFSR_API int nerfsr_invert_cdf(const void* bins, const void* w,
                                 const void* u, void* z, int n, int nb,
                                 int nq, void* stream) {
  return nerfsr_invert_cdf_ws(bins, w, u, z, nullptr, n, nb, nq, stream);
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
