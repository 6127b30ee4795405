// Kernel C, f32: fused NeRF MLP forward (D8/W256, skip at layer 4) on
// SIMT FMAs. The bf16 ("mixed") path runs on the tensor cores instead
// (fused_mlp_tc.cu).
//
// Replaces the TPU kernel _fwd_kernel of
// nerfsr_tpu/ops/experimental/pallas_mlp.py (_fwd, in fused_nerf_mlp), on
// the math of _fwd_pass: pre-embedded inputs x0 (P, 63) and dmb (P, 27) ->
// 8-layer ReLU trunk with [x0, h] concatenated before layer 4 -> f32 sigma
// head, 256-wide feature layer, 283 -> 128 ReLU direction branch, 128 -> 3
// sigmoid rgb head, all in f32. (In mixed precision the port fixes one
// rule, bf16 inputs, weights and activations with f32 accumulation and
// f32 biases; the JAX megakernel multiplies bf16 activations by f32
// weights, and flax Dense(bf16) also rounds the matmul output and the
// bias: the tests hold the rule against both with a loose bar.)
//
// Bound on the card: operations. 593,408 multiply-adds per point
// (~1.19 MFLOP); at P = 65,536 a call is ~78 GFLOP against ~27 MB of
// inputs and outputs, 1.16 ms at the H100's 67 TFLOP/s f32 rate.
//
// Design (first version: right and simple). A block of 128 threads owns a
// tile of 32 points and keeps all of the tile's activations in dynamic
// shared memory (x0, dmb and two ping-pong 32 x 256 f32 buffers, ~76 KB,
// set with cudaFuncSetAttribute). Weights stream from L2 (2.4 MB, which
// fits the 50 MB L2 many times over): thread t owns output columns t and
// t + 128, so each weight row is read coalesced, and its 64 accumulators
// stay in registers while the point activations are read from shared
// memory as float4 broadcasts. The next four weight rows are prefetched
// into registers while the current four are used. The skip layer and the
// direction layer read their two inputs (x0 | h, feat | dmb) against the
// matching row ranges of the one (in, out) weight, so no 319- or 283-wide
// concat is built. The two narrow heads (sigma: 256 -> 1, rgb: 128 -> 3)
// are warp reductions.

#include "mlp_tile.cuh"

namespace {

using namespace nerfsr_mlp;

// out[p][col] = relu?(acc + bias[col]), col = tid + c * 128
template <int NC, bool kRelu>
__device__ __forceinline__ void store(const float (&acc)[NC][kTP],
                                      const float* __restrict__ bias,
                                      float* __restrict__ out) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = threadIdx.x + c * kThreads;
    const float b = bias[col];
#pragma unroll
    for (int p = 0; p < kTP; ++p) {
      float v = acc[c][p] + b;
      if (kRelu) v = fmaxf(v, 0.f);
      out[p * kW + col] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_fwd_kernel(const float* __restrict__ x0,
                     const float* __restrict__ dmb,
                     const float* __restrict__ wts,
                     const float* __restrict__ bs,
                     float* __restrict__ rgb, float* __restrict__ sigma,
                     int n_points) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // kTP x kXS
  float* ds = xs + kTP * kXS;                   // kTP x kDS
  float* ha = ds + kTP * kDS;                   // kTP x kW
  float* hb = ha + kTP * kW;                    // kTP x kW
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * kTP;

  for (int i = tid; i < kTP * kXS; i += kThreads) {
    const int p = i / kXS, k = i % kXS;
    xs[i] = (k < kCPos && p0 + p < n_points)
                ? x0[(size_t)(p0 + p) * kCPos + k] : 0.f;
  }
  for (int i = tid; i < kTP * kDS; i += kThreads) {
    const int p = i / kDS, k = i % kDS;
    ds[i] = (k < kCDir && p0 + p < n_points)
                ? dmb[(size_t)(p0 + p) * kCDir + k] : 0.f;
  }
  __syncthreads();

  // trunk; the packed weights and biases are walked in layer order
  const float* w = wts;
  const float* b = bs;
  float acc[2][kTP];
  float* in = ha;
  float* out = hb;
  zero(acc);
  dense_acc<2>(acc, xs, kXS, kCPos, w, kW);
  store<2, true>(acc, b, in);
  w += (size_t)kCPos * kW;
  b += kW;
  __syncthreads();
  for (int l = 1; l < kD; ++l) {
    zero(acc);
    if (l == kSkip) {
      dense_acc<2>(acc, xs, kXS, kCPos, w, kW);
      dense_acc<2>(acc, in, kW, kW, w + (size_t)kCPos * kW, kW);
      w += (size_t)(kCPos + kW) * kW;
    } else {
      dense_acc<2>(acc, in, kW, kW, w, kW);
      w += (size_t)kW * kW;
    }
    store<2, true>(acc, b, out);
    b += kW;
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }
  // `in` holds the last trunk activation h
  const float* w_fin = w;
  const float* b_fin = b;
  const float* w_sig = w_fin + (size_t)kW * kW;
  const float b_sig = b_fin[kW];
  const float* w_dir = w_sig + kW;
  const float* b_dir = b_fin + kW + 1;
  const float* w_rgb = w_dir + (size_t)(kW + kCDir) * kWHalf;
  const float* b_rgb = b_dir + kWHalf;

  // sigma head (256 -> 1, f32 out): one warp per point
  for (int p = warp; p < kTP; p += kWarps) {
    float s = 0.f;
    for (int k = lane; k < kW; k += 32)
      s = fmaf(in[p * kW + k], w_sig[k], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && p0 + p < n_points) sigma[p0 + p] = s + b_sig;
  }

  // feat = h @ w_fin + b_fin (no activation)
  zero(acc);
  dense_acc<2>(acc, in, kW, kW, w_fin, kW);
  store<2, false>(acc, b_fin, out);
  __syncthreads();

  // g = relu([feat, dmb] @ w_dir + b_dir), 128 wide, written over h
  {
    float acc1[1][kTP];
    zero(acc1);
    dense_acc<1>(acc1, out, kW, kW, w_dir, kWHalf);
    dense_acc<1>(acc1, ds, kDS, kCDir, w_dir + (size_t)kW * kWHalf, kWHalf);
    store<1, true>(acc1, b_dir, in);
  }
  __syncthreads();

  // rgb head (128 -> 3, sigmoid): one warp per point
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
    if (lane == 0 && p0 + p < n_points) {
      float* o = rgb + (size_t)(p0 + p) * 3;
      o[0] = 1.f / (1.f + expf(-(s0 + b_rgb[0])));
      o[1] = 1.f / (1.f + expf(-(s1 + b_rgb[1])));
      o[2] = 1.f / (1.f + expf(-(s2 + b_rgb[2])));
    }
  }
}

int launch(const float* x0, const float* dmb, const float* w, const float* b,
           float* rgb, float* sigma, int n_points, cudaStream_t stream) {
  auto kernel = fused_mlp_fwd_kernel;
  // once in this process (the port runs on one card), so a CUDA graph
  // capture after the first call never meets it
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int grid = (n_points + kTP - 1) / kTP;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(x0, dmb, w, b, rgb, sigma,
                                                 n_points);
  return (int)cudaGetLastError();
}

}  // namespace

// w: packed (in, out) row-major f32 weights of every layer in PARAM_NAMES
// order; b: packed f32 biases, same order.
NERFSR_API int nerfsr_fused_mlp_fwd(const void* x0, const void* dmb,
                                    const void* w, const void* b, void* rgb,
                                    void* sigma, int n_points, void* stream) {
  if (n_points <= 0) return 0;
  return launch((const float*)x0, (const float*)dmb, (const float*)w,
                (const float*)b, (float*)rgb, (float*)sigma, n_points,
                (cudaStream_t)stream);
}
