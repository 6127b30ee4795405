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
// sample. At the training path's shapes (N = 2048, S = 16) a call moves
// under 1.5 MB, so both are launch-latency bound in practice.
//
// Design: one thread per ray walks its samples, carrying the
// transmittance as a serial product -- the same product the plain
// version's cumprod takes. The TPU kernels' log-space triangular matmuls
// were a way to get a prefix product and the backward's suffix sums onto
// the matrix unit; a thread-serial walk over S <= a few hundred samples
// needs no such detour and keeps the plain version's rounding. D walks
// twice: forward to rebuild T_i and w_i exactly as B does (parking T_i,
// gw_i and w_i in the row's own grgb slots), then in reverse, carrying
// the suffix sum of gw_i w_i and writing each sample's gradients.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;

template <bool kSoftplus, bool kWhite>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ rgb,
                     const float* __restrict__ sigma,
                     const float* __restrict__ z, float* __restrict__ comp,
                     float* __restrict__ depth, float* __restrict__ opacity,
                     float* __restrict__ weights, int n, int s) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* sr = sigma + (size_t)r * s;
  const float* zr = z + (size_t)r * s;
  const float* cr = rgb + (size_t)r * s * 3;
  float* wr = weights + (size_t)r * s;

  float trans = 1.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, d = 0.f, op = 0.f;
  float zi = zr[0];
  for (int i = 0; i < s; ++i) {
    const float znext = (i + 1 < s) ? zr[i + 1] : 0.f;
    const float delta = (i + 1 < s) ? znext - zi : 1e10f;
    const float x = sr[i];
    const float act = kSoftplus ? nerfsr::softplus(x - 1.f) : fmaxf(x, 0.f);
    const float alpha = 1.f - expf(-delta * act);
    const float w = alpha * trans;
    wr[i] = w;
    c0 += w * cr[3 * i];
    c1 += w * cr[3 * i + 1];
    c2 += w * cr[3 * i + 2];
    d += w * zi;
    op += w;
    trans *= 1.f - alpha + 1e-10f;
    zi = znext;
  }
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

template <bool kSoftplus>
__device__ __forceinline__ float act_of(float x) {
  return kSoftplus ? nerfsr::softplus(x - 1.f) : fmaxf(x, 0.f);
}

template <bool kSoftplus>
__device__ __forceinline__ float act_grad(float x) {
  if (kSoftplus) return 1.f / (1.f + expf(1.f - x));  // sigmoid(x - 1)
  return x > 0.f ? 1.f : 0.f;
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
  const int grid = (n + kThreads - 1) / kThreads;
  composite_fwd_kernel<kSoftplus, kWhite><<<grid, kThreads, 0, stream>>>(
      rgb, sigma, z, comp, depth, opacity, weights, n, s);
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
