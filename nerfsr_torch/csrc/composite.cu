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
//   grgb_i = w_i gc, dz_i = w_i gd + ddelta_{i-1} - ddelta_i (the
//   terminal delta is a constant, so it gets no ddelta).
//
// Bound on the card: bytes. B reads 5S floats a ray and writes S + 5, D
// reads 6S + 5 and writes 5S: 4N(11S + 5) bytes, 1.5 MB at the training
// step's N = 2048, S = 16 (0.44 us at the memory rate) and 11.6 MB at the
// parity preset's S = 128. About 20 (B) and 60 (D) flops a sample. What
// bounds both in practice is latency: the launch, the warps in flight, and
// each ray's chain of dependent steps.
//
// Both kernels give a segment of lanes to a ray, one lane to a sample. A
// segment is S lanes rounded up to a power of two, at most 32 (two rays a
// warp at S = 16); for S > 32 each lane takes ceil(S / 32) consecutive
// samples. At S <= 32 neighbouring lanes read and write neighbouring
// sigma and z (rgb as 3 floats a lane, contiguous across the segment), so
// warp loads and stores are coalesced; beyond, a lane's run comes from L1
// after its first load, and its stores land per_lane samples from its
// neighbours'. A lane's first sample is loaded whole before any
// arithmetic, so at S <= 32 every load is one round trip. The chain a ray
// waits on is log2(seg) shuffles and the lane's run, not S serial steps.
// One code path for every S >= 1 and ragged N; no per-thread array.
//
// The forward half, which both kernels share (run_start): delta_i takes
// z_{i+1} from the next lane by a shuffle-down, with the 1e10 terminal in
// the ray's last sample; the exclusive transmittance before a lane's run
// is a segmented multiplicative shuffle-up scan of the lanes' products of
// (1 - alpha + 1e-10). Each kernel then walks its run from that T: D's w_i
// are the same bits as the weights B returned. The scan rounds differently
// from a serial cumprod (the plain version's on the card is torch.cumprod,
// itself scanned): f32 rounding only.
//
// B's walk writes the weights and sums rgb, depth and opacity, which a
// segmented shuffle-xor tree reduces; the segment's first lane writes
// them. D's first walk sums the lane's gw_i w_i; a segmented shuffle-down
// scan of those sums gives each lane the suffix of the later lanes' runs;
// a backward walk over the run carries the suffix sum from there and
// writes each sample's gradients. At S <= 32 a run is one sample and both
// walks are one step; for longer runs the backward walk takes T_j by the
// forward product from the run's start (the same products, so the same
// bits as the forward walk), with sigma and z reread from L1. dz_i needs
// ddelta_{i-1}: within a run it is written one step late, and at a run's
// start it comes from the previous lane by a shuffle-up. Nothing is parked
// in device memory between the walks. The TPU kernels' log-space
// triangular matmuls were a way to get the prefix product and the suffix
// sums onto the matrix unit; on this card a warp's shuffles do both.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;         // warps a block, B and D

template <bool kSoftplus>
__device__ __forceinline__ float act_of(float x) {
  return kSoftplus ? nerfsr::softplus(x - 1.f) : fmaxf(x, 0.f);
}

template <bool kSoftplus>
__device__ __forceinline__ float act_grad(float x) {
  if (kSoftplus) return 1.f / (1.f + expf(1.f - x));  // sigmoid(x - 1)
  return x > 0.f ? 1.f : 0.f;
}

// one sample, as compositing sees it
struct Sample {
  float act;     // act(sigma)
  float delta;   // z_{i+1} - z_i, or the 1e10 terminal
  float oma;     // exp(-delta act) = 1 - alpha
  float alpha;
  float znext;   // the next sample's depth
  bool inner;    // not the ray's last sample
};

// A lane's run of one ray's samples: first, first + 1, ..., at most
// per_lane of them and none at or past s.
template <bool kSoftplus>
struct Run {
  const float* __restrict__ sigma;
  const float* __restrict__ z;
  size_t row;     // index of the ray's sample 0
  int first;      // the lane's first sample within the ray
  int per_lane, s;
  float z_after;  // the next lane's first depth (set by run_start)

  __device__ __forceinline__ bool holds(int j) const {
    return j < per_lane && first + j < s;
  }

  // sample first + j, density x, at depth zi
  __device__ __forceinline__ Sample at(int j, float zi, float x) const {
    const int i = first + j;
    Sample o;
    o.inner = i + 1 < s;
    o.znext = j + 1 < per_lane ? (o.inner ? z[row + i + 1] : 0.f) : z_after;
    o.delta = o.inner ? o.znext - zi : 1e10f;
    o.act = act_of<kSoftplus>(x);
    o.oma = expf(-o.delta * o.act);
    o.alpha = 1.f - o.oma;
    return o;
  }
};

// The forward half of kernels B and D. Every lane of the warp calls it
// (it shuffles); z0 and x0 are the depth and density of the lane's first
// sample, `has` whether it holds one. Sets s0 to that sample and returns
// the exclusive transmittance before it.
template <bool kSoftplus>
__device__ __forceinline__ float run_start(Run<kSoftplus>& run, bool has,
                                           float z0, float x0, int sl,
                                           int seg, Sample& s0) {
  run.z_after = __shfl_down_sync(kFull, z0, 1, seg);
  // the product of the run's factors (1 - alpha + 1e-10)
  float trans = 1.f;
  if (has) {
    s0 = run.at(0, z0, x0);
    trans = 1.f - s0.alpha + 1e-10f;
    float zi = s0.znext;
    for (int j = 1; run.holds(j); ++j) {
      const Sample sj = run.at(j, zi, run.sigma[run.row + run.first + j]);
      trans *= 1.f - sj.alpha + 1e-10f;
      zi = sj.znext;
    }
  }
  // segmented inclusive product scan, then T before the run's first sample
  float incl = trans;
  for (int k = 1; k < seg; k <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, k, seg);
    if (sl >= k) incl *= y;
  }
  const float excl = __shfl_up_sync(kFull, incl, 1, seg);
  return sl == 0 ? 1.f : excl;
}

// seg: lanes a ray (a power of two <= 32); per_lane: samples a lane
template <bool kSoftplus, bool kWhite>
__global__ void __launch_bounds__(kWarps * 32)
composite_fwd_kernel(const float* __restrict__ rgb,
                     const float* __restrict__ sigma,
                     const float* __restrict__ z, float* __restrict__ comp,
                     float* __restrict__ depth, float* __restrict__ opacity,
                     float* __restrict__ weights, int n, int s, int seg,
                     int per_lane) {
  const int lane = threadIdx.x & 31;
  const int sl = lane & (seg - 1);  // lane within the ray's segment
  const int r = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / seg) +
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

  Run<kSoftplus> run{sigma, z, row, first, per_lane, s, 0.f};
  Sample s0{};
  float trans = run_start(run, has, z0, x0, sl, seg, s0);

  // weights and the lane's sums
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, d = 0.f, op = 0.f;
  if (has) {
    float w = s0.alpha * trans;
    weights[i0] = w;
    c0 += w * r0;
    c1 += w * g0;
    c2 += w * b0;
    d += w * z0;
    op += w;
    trans *= 1.f - s0.alpha + 1e-10f;
    float zi = s0.znext;
    for (int j = 1; run.holds(j); ++j) {
      const size_t i = row + first + j;
      const Sample sj = run.at(j, zi, sigma[i]);
      w = sj.alpha * trans;
      weights[i] = w;
      c0 += w * rgb[3 * i];
      c1 += w * rgb[3 * i + 1];
      c2 += w * rgb[3 * i + 2];
      d += w * zi;
      op += w;
      trans *= 1.f - sj.alpha + 1e-10f;
      zi = sj.znext;
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

// seg, per_lane as for B
template <bool kSoftplus, bool kWhite>
__global__ void __launch_bounds__(kWarps * 32)
composite_bwd_kernel(const float* __restrict__ rgb,
                     const float* __restrict__ sigma,
                     const float* __restrict__ z,
                     const float* __restrict__ gc,
                     const float* __restrict__ gd,
                     const float* __restrict__ go,
                     const float* __restrict__ gw_in,
                     float* __restrict__ grgb, float* __restrict__ gsigma,
                     float* __restrict__ gz, int n, int s, int seg,
                     int per_lane) {
  const int lane = threadIdx.x & 31;
  const int sl = lane & (seg - 1);
  const int r = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / seg) +
                lane / seg;
  const size_t row = (size_t)r * s;
  const int first = sl * per_lane;
  const bool live = r < n;
  const bool has = live && first < s;

  // the run's first sample and the ray's cotangents (one broadcast
  // address each), all loaded up front
  const size_t i0 = row + first;
  const float z0 = has ? z[i0] : 0.f;
  const float x0 = has ? sigma[i0] : 0.f;
  const float r0 = has ? rgb[3 * i0] : 0.f;
  const float g0 = has ? rgb[3 * i0 + 1] : 0.f;
  const float b0 = has ? rgb[3 * i0 + 2] : 0.f;
  const float gw0 = has ? gw_in[i0] : 0.f;
  const float gc0 = live ? gc[3 * (size_t)r] : 0.f;
  const float gc1 = live ? gc[3 * (size_t)r + 1] : 0.f;
  const float gc2 = live ? gc[3 * (size_t)r + 2] : 0.f;
  const float gdr = live ? gd[r] : 0.f;
  const float go_r = live ? go[r] : 0.f;
  const float gor = kWhite ? go_r - (gc0 + gc1 + gc2) : go_r;

  Run<kSoftplus> run{sigma, z, row, first, per_lane, s, 0.f};
  Sample s0{};
  const float t0 = run_start(run, has, z0, x0, sl, seg, s0);

  // the cotangent of sample i's weight, from every output
  auto grad_w = [&](float cr, float cg, float cb, float zi, float gwi) {
    return gc0 * cr + gc1 * cg + gc2 * cb + gdr * zi + gor + gwi;
  };

  // walk 1: the lane's sum of gw_i w_i
  float run_sum = 0.f;
  if (has) {
    float trans = t0;
    run_sum += grad_w(r0, g0, b0, z0, gw0) * (s0.alpha * trans);
    trans *= 1.f - s0.alpha + 1e-10f;
    float zi = s0.znext;
    for (int j = 1; run.holds(j); ++j) {
      const size_t i = row + first + j;
      const Sample sj = run.at(j, zi, sigma[i]);
      run_sum += grad_w(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], zi,
                        gw_in[i]) * (sj.alpha * trans);
      trans *= 1.f - sj.alpha + 1e-10f;
      zi = sj.znext;
    }
  }
  // segmented inclusive reverse scan; the suffix of the later lanes' runs
  float incl = run_sum;
  for (int k = 1; k < seg; k <<= 1) {
    const float y = __shfl_down_sync(kFull, incl, k, seg);
    if (sl + k < seg) incl += y;
  }
  const float later = __shfl_down_sync(kFull, incl, 1, seg);
  float suffix = sl == seg - 1 ? 0.f : later;

  // walk 2, backward over the run: suffix = sum_{i>j} gw_i w_i. gz_{j+1}
  // is finished once ddelta_j is known, so it is written one step late.
  float pending = 0.f;     // gz_{j+1} - ddelta_j
  float gdelta_last = 0.f;  // ddelta of the run's last sample
  if (has) {
    int last = 0;
    while (run.holds(last + 1)) ++last;
    for (int j = last; j >= 0; --j) {
      // T_j and sample j by the forward product from the run's start
      float trans = t0, zj = z0, x = x0;
      Sample sj = s0;
      for (int k = 0; k < j; ++k) {
        trans *= 1.f - sj.alpha + 1e-10f;
        zj = sj.znext;
        x = sigma[row + first + k + 1];
        sj = run.at(k + 1, zj, x);
      }
      const size_t i = row + first + j;
      const float cr = j ? rgb[3 * i] : r0;
      const float cg = j ? rgb[3 * i + 1] : g0;
      const float cb = j ? rgb[3 * i + 2] : b0;
      const float w = sj.alpha * trans;
      const float gw = grad_w(cr, cg, cb, zj, j ? gw_in[i] : gw0);
      const float ga = gw * trans - suffix / (sj.oma + 1e-10f);
      suffix += gw * w;
      gsigma[i] = ga * sj.delta * sj.oma * act_grad<kSoftplus>(x);
      const float gdelta = sj.inner ? ga * sj.act * sj.oma : 0.f;
      if (j == last) gdelta_last = gdelta;
      else gz[i + 1] = pending + gdelta;
      pending = w * gdr - gdelta;
      grgb[3 * i] = w * gc0;
      grgb[3 * i + 1] = w * gc1;
      grgb[3 * i + 2] = w * gc2;
    }
  }
  // ddelta of the sample before the run: the previous lane's last
  const float gdelta_before = __shfl_up_sync(kFull, gdelta_last, 1, seg);
  if (has) gz[i0] = sl == 0 ? pending : pending + gdelta_before;
}

// the launch of B and D: a segment of `seg` lanes a ray (S rounded up to
// a power of two, at most 32), `per_lane` samples a lane, `grid` blocks
struct Lanes {
  int seg, per_lane, grid;
  Lanes(int n, int s) : seg(1) {
    while (seg < s && seg < 32) seg <<= 1;
    per_lane = (s + seg - 1) / seg;
    const int rays_a_block = kWarps * (32 / seg);
    grid = (n + rays_a_block - 1) / rays_a_block;
  }
};

template <bool kSoftplus, bool kWhite>
void launch(const float* rgb, const float* sigma, const float* z, float* comp,
            float* depth, float* opacity, float* weights, int n, int s,
            cudaStream_t stream) {
  const Lanes l(n, s);
  composite_fwd_kernel<kSoftplus, kWhite><<<l.grid, kWarps * 32, 0,
                                            stream>>>(
      rgb, sigma, z, comp, depth, opacity, weights, n, s, l.seg, l.per_lane);
}

template <bool kSoftplus, bool kWhite>
void launch_bwd(const float* rgb, const float* sigma, const float* z,
                const float* gc, const float* gd, const float* go,
                const float* gw, float* grgb, float* gsigma, float* gz,
                int n, int s, cudaStream_t stream) {
  const Lanes l(n, s);
  composite_bwd_kernel<kSoftplus, kWhite><<<l.grid, kWarps * 32, 0,
                                            stream>>>(
      rgb, sigma, z, gc, gd, go, gw, grgb, gsigma, gz, n, s, l.seg,
      l.per_lane);
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
