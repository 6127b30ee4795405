// Kernel B: fused alpha compositing, forward; kernel D: its backward.
//
// Kernel B replaces the TPU kernel _fwd_kernel of
// nerfsr_tpu/ops/experimental/pallas_composite.py (_run_fwd, in
// pallas_volumetric_rendering). It computes what
// core/rendering.py:volumetric_rendering computes: deltas with a 1e10
// terminal, relu or shifted softplus, alpha = 1 - exp(-delta * act),
// exclusive transmittance prod(1 - alpha + 1e-10), weights, the rgb /
// depth / opacity sums and the white-background blend.
//
// Kernel D replaces the TPU kernel _bwd_kernel of the same file
// (_run_bwd, the custom VJP's backward): the analytic VJP of B,
//   gw_i = gc . rgb_i + gd z_i + go' + gw_in_i   (go' = go - sum(gc) on a
//          white background)
//   da_j = T_j gw_j - (sum_{i>j} gw_i w_i) / (1 - a_j + 1e-10)
//   dsigma = da delta (1-a) act'(sigma),  ddelta = da act (1-a),
//   grgb_i = w_i gc, dz through the depth sum and the deltas (the
//   terminal delta is a constant).
//
// Bound on the card: bytes. B reads 5 S floats per ray and writes S + 5;
// D reads 6 S + 5 and writes 5 S. About 20 (B) and 40 (D) flops per
// sample. A call at the slice's shapes (N <= 4096, S = 16) moves under
// 1.7 MB, half a microsecond at the memory rate, so what bounds them in
// practice is latency: the launch, the warps in flight, and each ray's
// chain of dependent steps.
//
// B's design: a segment of lanes per ray, one lane per sample. A segment
// is S lanes rounded up to a power of two, at most 32 (two rays a warp at
// S = 16, so the serving chunk runs 65,536 threads); for S > 32 each lane
// takes ceil(S / 32) consecutive samples serially. Neighbouring lanes read
// neighbouring sigma and z (rgb as 3 floats a lane, contiguous across the
// segment), so warp loads are coalesced; a lane's first sample is loaded
// whole before any arithmetic, so at S <= 32 every load is one round
// trip. delta_i takes z_{i+1} from the next lane by a shuffle-down, with
// the 1e10 terminal in the ray's last sample. The exclusive transmittance
// is a segmented multiplicative shuffle-up scan of the lanes' products of
// (1 - alpha + 1e-10); a second walk over the lane's samples (the first
// sample's alpha kept, the others' recomputed from L1) writes the weights
// coalesced and sums rgb, depth and opacity, which a segmented
// shuffle-xor tree reduces; the segment's first lane writes them. One
// code path for every S >= 1 and ragged N; no per-thread array.
// The scan rounds differently from a serial cumprod (the plain version's
// on the card is torch.cumprod, itself scanned): f32 rounding only.
//
// D's design: one thread per ray walks its samples twice: forward,
// rebuilding T_i and w_i as a serial product (parking T_i, gw_i and w_i in
// the row's own grgb slots), then in reverse, carrying the suffix sum of
// gw_i w_i and writing each sample's gradients. Its serial T_i differ from
// B's scanned ones by f32 rounding only. The TPU kernels' log-space
// triangular matmuls were a way to get a prefix product and the
// backward's suffix sums onto the matrix unit; a thread-serial walk over
// S <= a few hundred samples needs no such detour.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 64;      // D: rays a block
constexpr int kFwdWarps = 8;      // B: warps a block

template <bool kSoftplus>
__device__ __forceinline__ float act_of(float x) {
  return kSoftplus ? nerfsr::softplus(x - 1.f) : fmaxf(x, 0.f);
}

template <bool kSoftplus>
__device__ __forceinline__ float act_grad(float x) {
  if (kSoftplus) return 1.f / (1.f + expf(1.f - x));  // sigmoid(x - 1)
  return x > 0.f ? 1.f : 0.f;
}

// seg: lanes a ray (a power of two <= 32); per_lane: samples a lane
template <bool kSoftplus, bool kWhite>
__global__ void __launch_bounds__(kFwdWarps * 32)
composite_fwd_kernel(const float* __restrict__ rgb,
                     const float* __restrict__ sigma,
                     const float* __restrict__ z, float* __restrict__ comp,
                     float* __restrict__ depth, float* __restrict__ opacity,
                     float* __restrict__ weights, int n, int s, int seg,
                     int per_lane) {
  const int lane = threadIdx.x & 31;
  const int sl = lane & (seg - 1);  // lane within the ray's segment
  const int r = (blockIdx.x * kFwdWarps + (threadIdx.x >> 5)) * (32 / seg) +
                lane / seg;
  // every lane stays to the end: the shuffles take the whole warp
  const size_t row = (size_t)r * s;
  const int first = sl * per_lane;
  const bool has = r < n && first < s;  // the lane holds samples

  // the run's first sample, loaded up front (for S <= 32 that is every
  // load of the lane, in one round trip)
  const size_t i0 = row + first;
  const float z0 = has ? z[i0] : 0.f;
  const float x0 = has ? sigma[i0] : 0.f;
  const float r0 = has ? rgb[3 * i0] : 0.f;
  const float g0 = has ? rgb[3 * i0 + 1] : 0.f;
  const float b0 = has ? rgb[3 * i0 + 2] : 0.f;
  const float z_after = __shfl_down_sync(kFull, z0, 1, seg);

  // alpha of sample first + j at depth zi; znext: the next sample's depth
  // (from the next lane at the run's end)
  auto alpha_of = [&](int j, float zi, float x, float& znext) {
    const int i = first + j;
    const bool inner = i + 1 < s;
    znext = j + 1 < per_lane ? (inner ? z[row + i + 1] : 0.f) : z_after;
    const float delta = inner ? znext - zi : 1e10f;
    return 1.f - expf(-delta * act_of<kSoftplus>(x));
  };
  float z1 = 0.f;
  const float a0 = has ? alpha_of(0, z0, x0, z1) : 0.f;

  // walk 1: the product of the run's factors (1 - alpha + 1e-10)
  float trans = has ? 1.f - a0 + 1e-10f : 1.f;
  if (has) {
    float zi = z1;
    for (int j = 1; j < per_lane && first + j < s; ++j) {
      float zn;
      const float a = alpha_of(j, zi, sigma[row + first + j], zn);
      trans *= 1.f - a + 1e-10f;
      zi = zn;
    }
  }
  // segmented inclusive product scan, then T before the run's first sample
  float incl = trans;
  for (int k = 1; k < seg; k <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, k, seg);
    if (sl >= k) incl *= y;
  }
  const float excl = __shfl_up_sync(kFull, incl, 1, seg);
  trans = sl == 0 ? 1.f : excl;

  // walk 2: weights and the lane's sums
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, d = 0.f, op = 0.f;
  if (has) {
    float w = a0 * trans;
    weights[i0] = w;
    c0 += w * r0;
    c1 += w * g0;
    c2 += w * b0;
    d += w * z0;
    op += w;
    trans *= 1.f - a0 + 1e-10f;
    float zi = z1;
    for (int j = 1; j < per_lane && first + j < s; ++j) {
      const size_t i = row + first + j;
      float zn;
      const float a = alpha_of(j, zi, sigma[i], zn);
      w = a * trans;
      weights[i] = w;
      c0 += w * rgb[3 * i];
      c1 += w * rgb[3 * i + 1];
      c2 += w * rgb[3 * i + 2];
      d += w * zi;
      op += w;
      trans *= 1.f - a + 1e-10f;
      zi = zn;
    }
  }
  for (int m = seg >> 1; m > 0; m >>= 1) {
    c0 += __shfl_xor_sync(kFull, c0, m, seg);
    c1 += __shfl_xor_sync(kFull, c1, m, seg);
    c2 += __shfl_xor_sync(kFull, c2, m, seg);
    d += __shfl_xor_sync(kFull, d, m, seg);
    op += __shfl_xor_sync(kFull, op, m, seg);
  }
  if (r >= n || sl != 0) return;
  if (kWhite) {
    c0 += 1.f - op;
    c1 += 1.f - op;
    c2 += 1.f - op;
  }
  comp[3 * (size_t)r] = c0;
  comp[3 * (size_t)r + 1] = c1;
  comp[3 * (size_t)r + 2] = c2;
  depth[r] = d;
  opacity[r] = op;
}

template <bool kSoftplus, bool kWhite>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ rgb,
                     const float* __restrict__ sigma,
                     const float* __restrict__ z,
                     const float* __restrict__ gc,
                     const float* __restrict__ gd,
                     const float* __restrict__ go,
                     const float* __restrict__ gw_in,
                     float* __restrict__ grgb, float* __restrict__ gsigma,
                     float* __restrict__ gz, int n, int s) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* sr = sigma + (size_t)r * s;
  const float* zr = z + (size_t)r * s;
  const float* cr = rgb + (size_t)r * s * 3;
  const float* gwr = gw_in + (size_t)r * s;
  float* gcr = grgb + (size_t)r * s * 3;
  float* gsr = gsigma + (size_t)r * s;
  float* gzr = gz + (size_t)r * s;
  const float gc0 = gc[3 * (size_t)r], gc1 = gc[3 * (size_t)r + 1],
              gc2 = gc[3 * (size_t)r + 2];
  const float gdr = gd[r];
  const float gor = kWhite ? go[r] - (gc0 + gc1 + gc2) : go[r];

  // forward walk: T_i, gw_i, w_i parked in this row's grgb slots
  float trans = 1.f;
  float zi = zr[0];
  for (int i = 0; i < s; ++i) {
    const float znext = (i + 1 < s) ? zr[i + 1] : 0.f;
    const float delta = (i + 1 < s) ? znext - zi : 1e10f;
    const float alpha = 1.f - expf(-delta * act_of<kSoftplus>(sr[i]));
    const float w = alpha * trans;
    const float gw = gc0 * cr[3 * i] + gc1 * cr[3 * i + 1] +
                     gc2 * cr[3 * i + 2] + gdr * zi + gor + gwr[i];
    gcr[3 * i] = trans;
    gcr[3 * i + 1] = gw;
    gcr[3 * i + 2] = w;
    trans *= 1.f - alpha + 1e-10f;
    zi = znext;
  }

  // reverse walk: suffix = sum_{i>j} gw_i w_i; gz_{j+1} is finished once
  // d(delta_j) is known, so it is written one step late
  float suffix = 0.f, pending = 0.f;
  for (int i = s - 1; i >= 0; --i) {
    const float t_i = gcr[3 * i], gw = gcr[3 * i + 1], w = gcr[3 * i + 2];
    const bool inner = i + 1 < s;
    const float delta = inner ? zr[i + 1] - zr[i] : 1e10f;
    const float x = sr[i];
    const float sa = act_of<kSoftplus>(x);
    const float oma = expf(-delta * sa);
    const float ga = gw * t_i - suffix / (oma + 1e-10f);
    suffix += gw * w;
    gsr[i] = ga * delta * oma * act_grad<kSoftplus>(x);
    const float gdelta = ga * sa * oma;
    if (inner) gzr[i + 1] = pending + gdelta;
    pending = w * gdr - (inner ? gdelta : 0.f);
    gcr[3 * i] = w * gc0;
    gcr[3 * i + 1] = w * gc1;
    gcr[3 * i + 2] = w * gc2;
  }
  gzr[0] = pending;
}

template <bool kSoftplus, bool kWhite>
void launch(const float* rgb, const float* sigma, const float* z, float* comp,
            float* depth, float* opacity, float* weights, int n, int s,
            cudaStream_t stream) {
  int seg = 1;
  while (seg < s && seg < 32) seg <<= 1;
  const int per_lane = (s + seg - 1) / seg;
  const int rays_a_block = kFwdWarps * (32 / seg);
  const int grid = (n + rays_a_block - 1) / rays_a_block;
  composite_fwd_kernel<kSoftplus, kWhite><<<grid, kFwdWarps * 32, 0,
                                            stream>>>(
      rgb, sigma, z, comp, depth, opacity, weights, n, s, seg, per_lane);
}

template <bool kSoftplus, bool kWhite>
void launch_bwd(const float* rgb, const float* sigma, const float* z,
                const float* gc, const float* gd, const float* go,
                const float* gw, float* grgb, float* gsigma, float* gz,
                int n, int s, cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  composite_bwd_kernel<kSoftplus, kWhite><<<grid, kThreads, 0, stream>>>(
      rgb, sigma, z, gc, gd, go, gw, grgb, gsigma, gz, n, s);
}

}  // namespace

NERFSR_API int nerfsr_composite_fwd(const void* rgb, const void* sigma,
                                    const void* z, void* comp, void* depth,
                                    void* opacity, void* weights, int n,
                                    int s, int softplus, int white_bkgd,
                                    void* stream) {
  if (s < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  auto* args_rgb = (const float*)rgb;
  auto* args_sigma = (const float*)sigma;
  auto* args_z = (const float*)z;
  auto* c = (float*)comp;
  auto* d = (float*)depth;
  auto* o = (float*)opacity;
  auto* w = (float*)weights;
  auto st = (cudaStream_t)stream;
  if (softplus) {
    if (white_bkgd)
      launch<true, true>(args_rgb, args_sigma, args_z, c, d, o, w, n, s, st);
    else
      launch<true, false>(args_rgb, args_sigma, args_z, c, d, o, w, n, s, st);
  } else {
    if (white_bkgd)
      launch<false, true>(args_rgb, args_sigma, args_z, c, d, o, w, n, s, st);
    else
      launch<false, false>(args_rgb, args_sigma, args_z, c, d, o, w, n, s,
                           st);
  }
  return (int)cudaGetLastError();
}

// gc (n, 3), gd, go (n), gw (n, s): cotangents of comp, depth, opacity,
// weights -> grgb (n, s, 3), gsigma (n, s), gz (n, s).
NERFSR_API int nerfsr_composite_bwd(const void* rgb, const void* sigma,
                                    const void* z, const void* gc,
                                    const void* gd, const void* go,
                                    const void* gw, void* grgb,
                                    void* gsigma, void* gz, int n, int s,
                                    int softplus, int white_bkgd,
                                    void* stream) {
  if (s < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  auto* a_rgb = (const float*)rgb;
  auto* a_sigma = (const float*)sigma;
  auto* a_z = (const float*)z;
  auto* a_gc = (const float*)gc;
  auto* a_gd = (const float*)gd;
  auto* a_go = (const float*)go;
  auto* a_gw = (const float*)gw;
  auto* o_rgb = (float*)grgb;
  auto* o_sigma = (float*)gsigma;
  auto* o_z = (float*)gz;
  auto st = (cudaStream_t)stream;
  if (softplus) {
    if (white_bkgd)
      launch_bwd<true, true>(a_rgb, a_sigma, a_z, a_gc, a_gd, a_go, a_gw,
                             o_rgb, o_sigma, o_z, n, s, st);
    else
      launch_bwd<true, false>(a_rgb, a_sigma, a_z, a_gc, a_gd, a_go, a_gw,
                              o_rgb, o_sigma, o_z, n, s, st);
  } else {
    if (white_bkgd)
      launch_bwd<false, true>(a_rgb, a_sigma, a_z, a_gc, a_gd, a_go, a_gw,
                              o_rgb, o_sigma, o_z, n, s, st);
    else
      launch_bwd<false, false>(a_rgb, a_sigma, a_z, a_gc, a_gd, a_go, a_gw,
                               o_rgb, o_sigma, o_z, n, s, st);
  }
  return (int)cudaGetLastError();
}
