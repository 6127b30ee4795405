// Kernel E, f32: fused NeRF MLP backward (weight and bias gradients) on
// SIMT FMAs. The bf16 ("mixed") path runs on the tensor cores instead
// (fused_mlp_bwd_tc.cu).
//
// Replaces the TPU kernel _bwd_kernel_v3 of
// nerfsr_tpu/ops/experimental/pallas_mlp.py (_bwd, the custom VJP's
// backward with bwd_mode="pallas"): recompute the D8/W256 forward per
// point tile, backpropagate the rgb and sigma cotangents, and sum all 12
// weight gradients (in, out) and 12 bias gradients over the points, all
// in f32. The gradients of the inputs are zero by the JAX contract and are
// not computed.
//
// Bound on the card: operations. Per point, 593,408 multiply-adds of
// recompute, 557,696 of input gradients (every layer but layer 0's input,
// the skip's x0 rows and the direction layer's dmb rows) and 593,408 of
// weight gradients: ~3.49 MFLOP, ~114 GFLOP at P = 32,768 (1.71 ms at 67
// TFLOP/s f32) against a few hundred MB of scratch traffic.
//
// Design (first version: right and simple, SIMT FMAs). The TPU kernel
// carries the weight-gradient sums in VMEM scratch across its sequential
// grid; on the card blocks run in parallel, so the sum over points takes
// three launches:
//   E1 (tile):   a block of 128 threads owns 32 points, recomputes the
//                forward with kernel C's dense_acc and backpropagates down
//                the trunk against a transposed copy of the weights (so a
//                thread's weight row is read coalesced). It writes every
//                layer's input activation and output gradient to global
//                scratch, point-major, in f32.
//   E2 (wgrad):  dW_l = A_l^T G_l and db = sum_p G over a fixed number of
//                point splits: block (tile, split) owns a 64 x 64 tile of
//                one dW (or 64 bias columns) and walks its split's points
//                32 at a time through shared memory, 4 x 4 outputs per
//                thread, f32 accumulation. One partial buffer per split.
//   E3 (reduce): sums the partials in split order.
// No atomics: the result is the same from run to run.

#include "mlp_tile.cuh"

namespace {

using namespace nerfsr_mlp;

// Scratch rows, one per point, f32. Activations:
//   a0 | a1 | a2 | x0 | a3 | a4 | a5 | a6 | a7 | feat | dmb | g
// so every layer's input is one contiguous column range ([x0, a3] for the
// skip layer, [feat, dmb] for the direction layer). Gradients, in the
// packed bias layout, so db is the column sum:
//   gh0 .. gh7 | gfeat | gsigma | gg | grgb_pre
constexpr int kAOffX0 = 3 * kW;
__host__ __device__ constexpr int kAOffAct(int l) {
  return l < 3 ? l * kW : kAOffX0 + kCPos + (l - 3) * kW;
}
constexpr int kAOffFeat = kAOffAct(kD);
constexpr int kAOffDmb = kAOffFeat + kW;
constexpr int kAOffG = kAOffDmb + kCDir;
constexpr int kAW = kAOffG + kWHalf;
constexpr int kGW = kNBiases;
static_assert(kAW == 2522, "activation scratch row of kernels/mlp.py");

struct Prod {
  int a_off, k, g_off, n, w_off;
};
// the 12 weight gradients: input columns in the activation row, rows of
// dW, gradient columns, columns of dW, offset in the packed weights
__constant__ Prod kProds[12] = {
    {kAOffX0, kCPos, 0 * kW, kW, kWOff(0)},
    {kAOffAct(0), kW, 1 * kW, kW, kWOff(1)},
    {kAOffAct(1), kW, 2 * kW, kW, kWOff(2)},
    {kAOffAct(2), kW, 3 * kW, kW, kWOff(3)},
    {kAOffX0, kCPos + kW, 4 * kW, kW, kWOff(4)},
    {kAOffAct(4), kW, 5 * kW, kW, kWOff(5)},
    {kAOffAct(5), kW, 6 * kW, kW, kWOff(6)},
    {kAOffAct(6), kW, 7 * kW, kW, kWOff(7)},
    {kAOffAct(7), kW, kBOffFin, kW, kWOffFin},
    {kAOffAct(7), kW, kBOffSig, 1, kWOffSig},
    {kAOffFeat, kW + kCDir, kBOffDir, kWHalf, kWOffDir},
    {kAOffG, kWHalf, kBOffRgb, 3, kWOffRgb},
};
static_assert(kAOffX0 + kCPos == kAOffAct(3), "skip input [x0, a3]");

constexpr int kSplits = 16;      // point splits of E2 (partial buffers)

// E3: the sum over the splits, in split order
__global__ void mlp_bwd_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out) {
  reduce_splits(partial, out, kSplits);
}
constexpr int kBT = 64;          // E2 tile edge
constexpr int kBP = 32;          // E2 points per shared-memory chunk
constexpr int kE2Threads = 256;

// forward store: out[p][col] = relu?(acc + bias[col]) in shared memory
// and in the activation scratch (column offset already applied)
template <int NC, bool kRelu>
__device__ __forceinline__ void store_fwd(const float (&acc)[NC][kTP],
                                          const float* __restrict__ bias,
                                          float* __restrict__ out,
                                          float* __restrict__ arow, int p0,
                                          int n_points) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = threadIdx.x + c * kThreads;
    const float b = bias[col];
#pragma unroll
    for (int p = 0; p < kTP; ++p) {
      float v = acc[c][p] + b;
      if (kRelu) v = fmaxf(v, 0.f);
      out[p * kW + col] = v;
      if (p0 + p < n_points) arow[(size_t)(p0 + p) * kAW + col] = v;
    }
  }
}

// backward store: v = acc, zeroed where the layer's activation (read back
// from the scratch; null = no mask) is not positive; to shared memory and
// the gradient scratch. The same thread wrote that activation column, so
// it reads its own writes.
__device__ __forceinline__ void store_bwd(const float (&acc)[2][kTP],
                                          const float* __restrict__ mask,
                                          float* __restrict__ out,
                                          float* __restrict__ grow, int p0,
                                          int n_points) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int col = threadIdx.x + c * kThreads;
#pragma unroll
    for (int p = 0; p < kTP; ++p) {
      const bool valid = p0 + p < n_points;
      float v = acc[c][p];
      if (mask != nullptr) {
        const float m = valid ? mask[(size_t)(p0 + p) * kAW + col] : 0.f;
        v = m > 0.f ? v : 0.f;
      }
      out[p * kW + col] = v;
      if (valid) grow[(size_t)(p0 + p) * kGW + col] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mlp_bwd_tile_kernel(const float* __restrict__ x0,
                    const float* __restrict__ dmb,
                    const float* __restrict__ grgb,
                    const float* __restrict__ gsig,
                    const float* __restrict__ wts,
                    const float* __restrict__ wts_t,
                    const float* __restrict__ bs, float* __restrict__ acts,
                    float* __restrict__ grads, int n_points) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // kTP x kXS
  float* ds = xs + kTP * kXS;                   // kTP x kDS
  float* ha = ds + kTP * kDS;                   // kTP x kW
  float* hb = ha + kTP * kW;                    // kTP x kW
  __shared__ float gr[kTP][4];                  // rgb pre-activation grads
  __shared__ float gs[kTP];                     // sigma cotangent
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * kTP;

  for (int i = tid; i < kTP * kXS; i += kThreads) {
    const int p = i / kXS, k = i % kXS;
    const bool ok = k < kCPos && p0 + p < n_points;
    const float v = ok ? x0[(size_t)(p0 + p) * kCPos + k] : 0.f;
    xs[i] = v;
    if (ok) acts[(size_t)(p0 + p) * kAW + kAOffX0 + k] = v;
  }
  for (int i = tid; i < kTP * kDS; i += kThreads) {
    const int p = i / kDS, k = i % kDS;
    const bool ok = k < kCDir && p0 + p < n_points;
    const float v = ok ? dmb[(size_t)(p0 + p) * kCDir + k] : 0.f;
    ds[i] = v;
    if (ok) acts[(size_t)(p0 + p) * kAW + kAOffDmb + k] = v;
  }
  __syncthreads();

  // ---- forward recompute (kernel C's products) ----
  float acc[2][kTP];
  float* in = ha;
  float* out = hb;
  zero(acc);
  dense_acc<2>(acc, xs, kXS, kCPos, wts, kW);
  store_fwd<2, true>(acc, bs, in, acts + kAOffAct(0), p0, n_points);
  __syncthreads();
  for (int l = 1; l < kD; ++l) {
    zero(acc);
    const float* w = wts + kWOff(l);
    if (l == kSkip) {
      dense_acc<2>(acc, xs, kXS, kCPos, w, kW);
      dense_acc<2>(acc, in, kW, kW, w + (size_t)kCPos * kW, kW);
    } else {
      dense_acc<2>(acc, in, kW, kW, w, kW);
    }
    store_fwd<2, true>(acc, bs + l * kW, out, acts + kAOffAct(l), p0,
                              n_points);
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }
  // `in` holds a7; feat = a7 @ w_fin + b_fin (no activation) -> `out`
  zero(acc);
  dense_acc<2>(acc, in, kW, kW, wts + kWOffFin, kW);
  store_fwd<2, false>(acc, bs + kBOffFin, out, acts + kAOffFeat, p0,
                             n_points);
  __syncthreads();
  // g = relu([feat, dmb] @ w_dir + b_dir), 128 wide -> `in`
  {
    float acc1[1][kTP];
    zero(acc1);
    dense_acc<1>(acc1, out, kW, kW, wts + kWOffDir, kWHalf);
    dense_acc<1>(acc1, ds, kDS, kCDir, wts + kWOffDir + (size_t)kW * kWHalf,
                 kWHalf);
    store_fwd<1, true>(acc1, bs + kBOffDir, in, acts + kAOffG, p0,
                              n_points);
  }
  __syncthreads();
  // rgb head (128 -> 3, sigmoid) and its pre-activation gradient: one
  // warp per point
  const float* w_rgb = wts + kWOffRgb;
  for (int p = warp; p < kTP; p += kWarps) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < kWHalf; k += 32) {
      const float g = in[p * kW + k];
      s0 = fmaf(g, w_rgb[3 * k], s0);
      s1 = fmaf(g, w_rgb[3 * k + 1], s1);
      s2 = fmaf(g, w_rgb[3 * k + 2], s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane < 4) {
      const bool valid = p0 + p < n_points;
      const size_t row = (size_t)(p0 + p);
      float v = 0.f;
      if (lane < 3) {
        const float pre = (lane == 0 ? s0 : lane == 1 ? s1 : s2) +
                          bs[kBOffRgb + lane];
        const float rgb = 1.f / (1.f + expf(-pre));
        v = valid ? grgb[row * 3 + lane] * rgb * (1.f - rgb) : 0.f;
        if (valid) grads[row * kGW + kBOffRgb + lane] = v;
      } else {
        const float sg = valid ? gsig[row] : 0.f;
        gs[p] = sg;
        if (valid) grads[row * kGW + kBOffSig] = sg;
      }
      gr[p][lane] = v;
    }
  }
  __syncthreads();

  // ---- backward ----
  // gg = relu'(g) * (grgb_pre @ w_rgb^T), thread tid owns column tid -> `out`
  {
    const float w0 = w_rgb[3 * tid];
    const float w1 = w_rgb[3 * tid + 1];
    const float w2 = w_rgb[3 * tid + 2];
    for (int p = 0; p < kTP; ++p) {
      float v = gr[p][0] * w0 + gr[p][1] * w1 + gr[p][2] * w2;
      v = in[p * kW + tid] > 0.f ? v : 0.f;
      out[p * kW + tid] = v;
      if (p0 + p < n_points)
        grads[(size_t)(p0 + p) * kGW + kBOffDir + tid] = v;
    }
  }
  __syncthreads();
  // gfeat = gg @ w_dir[:256]^T -> `in`
  zero(acc);
  dense_acc<2>(acc, out, kW, kWHalf, wts_t + kWOffDir, kW + kCDir);
  store_bwd(acc, nullptr, in, grads + kBOffFin, p0, n_points);
  __syncthreads();
  // gh7 (pre-mask) = gfeat @ w_fin^T + gsigma * w_sig^T
  zero(acc);
  dense_acc<2>(acc, in, kW, kW, wts_t + kWOffFin, kW);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float ws = wts[kWOffSig + tid + c * kThreads];
#pragma unroll
    for (int p = 0; p < kTP; ++p) acc[c][p] = fmaf(gs[p], ws, acc[c][p]);
  }
  // down the trunk: mask with a_l, store gh_l, then gh_{l-1} (pre-mask) =
  // gh_l @ w_l[h rows]^T
  for (int l = kD - 1; l >= 0; --l) {
    store_bwd(acc, acts + kAOffAct(l), out, grads + l * kW, p0,
                     n_points);
    __syncthreads();
    if (l > 0) {
      zero(acc);
      const int hoff = l == kSkip ? kCPos : 0;
      dense_acc<2>(acc, out, kW, kW, wts_t + kWOff(l) + hoff, kInDim(l));
    }
    float* t = in;
    in = out;
    out = t;
  }
}

// E2: block (tile, split). Tiles: the 12 products' 64 x 64 dW tiles in
// order, then the 64-column bias tiles.
__global__ void __launch_bounds__(kE2Threads)
mlp_bwd_wgrad_kernel(const float* __restrict__ acts,
                     const float* __restrict__ grads,
                     float* __restrict__ partial, int n_points) {
  __shared__ __align__(16) float as[kBP][kBT];
  __shared__ __align__(16) float gsm[kBP][kBT];
  const int tid = threadIdx.x;
  const int split = blockIdx.y;
  const int per = (n_points + kSplits - 1) / kSplits;
  const int pb = split * per;
  const int pe = min(n_points, pb + per);
  float* part = partial + (size_t)split * kTotal;

  int t = blockIdx.x;
  int prod = -1;
  for (int i = 0; i < 12; ++i) {
    const int nt = ((kProds[i].k + kBT - 1) / kBT) *
                   ((kProds[i].n + kBT - 1) / kBT);
    if (t < nt) {
      prod = i;
      break;
    }
    t -= nt;
  }

  if (prod < 0) {  // bias tile: column sums of the gradient rows
    float* red = &as[0][0];  // 4 x 64
    const int c0 = t * kBT;
    const int col = tid % kBT, q = tid / kBT;
    const bool ok = c0 + col < kGW;
    float s = 0.f;
    if (ok)
      for (int p = pb + q; p < pe; p += kE2Threads / kBT)
        s += grads[(size_t)p * kGW + c0 + col];
    red[q * kBT + col] = s;
    __syncthreads();
    if (q == 0 && ok)
      part[kNWeights + c0 + col] =
          ((red[col] + red[kBT + col]) + red[2 * kBT + col]) +
          red[3 * kBT + col];
    return;
  }

  const Prod pr = kProds[prod];
  const int tiles_n = (pr.n + kBT - 1) / kBT;
  const int k0 = (t / tiles_n) * kBT, n0 = (t % tiles_n) * kBT;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int pc = pb; pc < pe; pc += kBP) {
    for (int i = tid; i < kBP * kBT; i += kE2Threads) {
      const int p = i / kBT, kk = i % kBT;
      const int pp = pc + p;
      const bool prow = pp < pe;
      as[p][kk] = (prow && k0 + kk < pr.k)
                      ? acts[(size_t)pp * kAW + pr.a_off + k0 + kk]
                      : 0.f;
      gsm[p][kk] = (prow && n0 + kk < pr.n)
                       ? grads[(size_t)pp * kGW + pr.g_off + n0 + kk]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < kBP; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(&as[p][ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&gsm[p][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= pr.k) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < pr.n) part[pr.w_off + (size_t)k * pr.n + n] = acc[i][j];
    }
  }
}

int n_tiles() {
  int n = (kGW + kBT - 1) / kBT;
  const int dims[12][2] = {{kCPos, kW}, {kW, kW}, {kW, kW}, {kW, kW},
                           {kCPos + kW, kW}, {kW, kW}, {kW, kW}, {kW, kW},
                           {kW, kW}, {kW, 1}, {kW + kCDir, kWHalf},
                           {kWHalf, 3}};
  for (auto& d : dims) n += ((d[0] + kBT - 1) / kBT) * ((d[1] + kBT - 1) / kBT);
  return n;
}

int launch(const float* x0, const float* dmb, const float* grgb,
           const float* gsig, const float* w, const float* wt, const float* b,
           float* acts, float* grads, float* partial, float* out,
           int n_points, cudaStream_t stream) {
  auto tile = mlp_bwd_tile_kernel;
  // once in this process (the port runs on one card)
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  tile<<<(n_points + kTP - 1) / kTP, kThreads, kSmemBytes, stream>>>(
      x0, dmb, grgb, gsig, w, wt, b, acts, grads, n_points);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_wgrad_kernel<<<dim3(n_tiles(), kSplits), kE2Threads, 0, stream>>>(
      acts, grads, partial, n_points);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_reduce_kernel
      <<<(kTotal + 255) / 256, 256, 0, stream>>>(partial, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x0 (P, 63), dmb (P, 27), grgb (P, 3), gsig (P) f32; w / wt: packed
// weights and their per-layer transposes (out, in), same offsets, f32;
// b: packed f32 biases. Scratch, f32: acts (P, 2522), grads (P, 2436),
// partial (16, 595844). out (595844) f32: the packed weight gradients,
// then the bias gradients.
NERFSR_API int nerfsr_fused_mlp_bwd(const void* x0, const void* dmb,
                                    const void* grgb, const void* gsig,
                                    const void* w, const void* wt,
                                    const void* b, void* acts, void* grads,
                                    void* partial, void* out, int n_points,
                                    void* stream) {
  auto st = (cudaStream_t)stream;
  if (n_points <= 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * kTotal, st);
  return launch((const float*)x0, (const float*)dmb, (const float*)grgb,
                (const float*)gsig, (const float*)w, (const float*)wt,
                (const float*)b, (float*)acts, (float*)grads,
                (float*)partial, (float*)out, n_points, st);
}

// The scratch shapes the wrapper allocates.
NERFSR_API int nerfsr_fused_mlp_bwd_layout(int* act_width, int* grad_width,
                                           int* splits, int* total) {
  *act_width = kAW;
  *grad_width = kGW;
  *splits = kSplits;
  *total = kTotal;
  return 0;
}
