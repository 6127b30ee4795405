// Kernel C, mixed precision (bf16): the fused NeRF MLP forward on Hopper's
// tensor cores.
//
// Replaces the TPU kernel _fwd_kernel of
// nerfsr_tpu/ops/experimental/pallas_mlp.py (_fwd, in fused_nerf_mlp) for
// compute dtype bf16; the f32 route is fused_mlp_tf32.cu. The math is
// _fwd_pass's, the numerics rule kernels/mlp.py's: bf16 inputs, weights and
// activations; products accumulated in f32 (wgmma's f32 accumulator);
// biases added in f32; sigma and rgb_pre in f32.
//
// Bound on the card: operations. 593,408 multiply-adds per point; at
// P = 65,536 a call is 77.8 GFLOP, 0.079 ms at the H100's 989 TFLOP/s bf16
// rate, against ~25 MB of inputs and outputs (0.008 ms at 3.35 TB/s).
//
// Design (mlp_tc.cuh): 128 points a block, two consumer warpgroups of 64
// points issuing wgmma m64n256k16 (m64n128k16 for the direction layer)
// from shared memory, a producer warpgroup streaming the pre-packed bf16
// weight image through a 3-stage ring of 32 KB chunks with cp.async.bulk
// and mbarriers, bf16 activation tiles rewritten in place by each layer's
// epilogue. The sigma head is summed from the last trunk layer's epilogue
// registers and the rgb head from the direction layer's, across the four
// lanes that share a row; neither goes through shared memory.

#include "mlp_tc.cuh"

namespace {

using namespace nerfsr_tc;
using nerfsr_mlp::kBOffDir;
using nerfsr_mlp::kBOffFin;
using nerfsr_mlp::kBOffRgb;
using nerfsr_mlp::kBOffSig;

__global__ void __launch_bounds__(kTileThreads, 1)
fused_mlp_fwd_tc_kernel(const float* __restrict__ x0,
                        const float* __restrict__ dmb,
                        const char* __restrict__ wimg,
                        const float* __restrict__ bs,
                        const float* __restrict__ heads,
                        float* __restrict__ rgb, float* __restrict__ sigma,
                        int n_points) {
  extern __shared__ __align__(128) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmBar);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp_uniform_div(128) == 2) {  // producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads)
      produce(wimg, nullptr, kFwdChunks, smem, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp_uniform_div(128), t128 = threadIdx.x & 127;
  const int p0 = blockIdx.x * kBlockPoints + wg * kWgPoints;
  char* h = smem + kSmH + wg * (kWgPoints * kW * 2);
  char* xs = smem + kSmX0 + wg * (kWgPoints * kX0K * 2);
  char* ds = smem + kSmDmb + wg * (kWgPoints * kDmbK * 2);
  const uint32_t ha = smem_u32(h), xa = smem_u32(xs), da = smem_u32(ds);
  const int bar = 1 + wg;
  Ring ring{smem_u32(smem + kSmRing), full, empty, 0};

  load_input(xs, x0, kCPos, kX0K, p0, n_points, t128);
  load_input(ds, dmb, kCDir, kDmbK, p0, n_points, t128);
  fence_proxy_async();
  bar_sync(bar, 128);

  float acc[128];
  // trunk
  for (int l = 0; l < kD; ++l) {
    trunk_product(acc, ring, l, xa, ha);
    bar_sync(bar, 128);  // every warp's wgmmas have read h
    epilogue<128, true>(acc, bs + l * kW, h);
    fence_proxy_async();
    bar_sync(bar, 128);
  }
  // sigma head, from the rounded last trunk activation in acc
  {
    float s[2];
    sigma_head(acc, heads + kHeadSig, s);
    const float b = __ldg(bs + kBOffSig);
    if ((threadIdx.x & 3) == 0)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (p0 + acc_row(j) < n_points) sigma[p0 + acc_row(j)] = s[j] + b;
  }
  // feat = h @ w_fin + b_fin (no activation), over h
  mma_chunks<4, kChunkK, false>(acc, ring, ha, kW * 16);
  bar_sync(bar, 128);
  epilogue<128, false>(acc, bs + kBOffFin, h);
  fence_proxy_async();
  bar_sync(bar, 128);
  // g = relu([feat, dmb] @ w_dir + b_dir), 128 wide, in registers
  float acc64[64];  // acc is dead here: the two share registers
  mma_chunks<4, kChunkK, false>(acc64, ring, ha, kW * 16);
  mma_chunks<1, kDmbK, true>(acc64, ring, da, kDmbK * 16);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = acc_col(i);
    const float b0 = __ldg(bs + kBOffDir + col);
    const float b1 = __ldg(bs + kBOffDir + col + 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc64[4 * i + 2 * j] = round_bf16(fmaxf(acc64[4 * i + 2 * j] + b0, 0.f));
      acc64[4 * i + 2 * j + 1] =
          round_bf16(fmaxf(acc64[4 * i + 2 * j + 1] + b1, 0.f));
    }
  }
  float pre[2][3];
  rgb_head(acc64, heads + kHeadRgb, pre);
  if ((threadIdx.x & 3) == 0)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = p0 + acc_row(j);
      if (p < n_points)
#pragma unroll
        for (int o = 0; o < 3; ++o)
          rgb[(size_t)p * 3 + o] =
              1.f / (1.f + expf(-(pre[j][o] + __ldg(bs + kBOffRgb + o))));
    }
}

// The layout probe: d (128 x 256, f32) = x (128 x 256, bf16 row-major) @ B
// over the first four chunks of a weight image (one 256 -> 256 trunk
// layer), through the same ring, descriptors and accumulator mapping.
__global__ void __launch_bounds__(kTileThreads, 1)
tc_probe_kernel(const __nv_bfloat16* __restrict__ x,
                const char* __restrict__ wimg, float* __restrict__ d) {
  extern __shared__ __align__(128) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmBar);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp_uniform_div(128) == 2) {  // producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads)
      produce(wimg, nullptr, 4, smem, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int wg = warp_uniform_div(128), t128 = threadIdx.x & 127;
  char* h = smem + kSmH + wg * (kWgPoints * kW * 2);
  for (int i = t128; i < kWgPoints * kW / 2; i += 128) {
    const int row = i / (kW / 2), col = 2 * (i % (kW / 2));
    const __nv_bfloat16* s = x + (size_t)(wg * kWgPoints + row) * kW + col;
    st_pair(h, row, col, kW, __bfloat162float(s[0]),
            __bfloat162float(s[1]));
  }
  fence_proxy_async();
  bar_sync(1 + wg, 128);
  Ring ring{smem_u32(smem + kSmRing), full, empty, 0};
  float acc[128];
  mma_chunks<4, kChunkK, false>(acc, ring, smem_u32(h), kW * 16);
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = d + (size_t)(wg * kWgPoints + acc_row(j)) * kW + acc_col(i);
      o[0] = acc[4 * i + 2 * j];
      o[1] = acc[4 * i + 2 * j + 1];
    }
}

template <typename K>
int set_smem(K kernel, bool& done) {
  // once per kernel in this process (the port runs on one card), so a
  // CUDA graph capture after the first call never meets it
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTileSmemBytes);
  if (err == cudaSuccess) done = true;
  return (int)err;
}

}  // namespace

// x0 (P, 63), dmb (P, 27) f32; wimg: the forward weight image (bf16,
// kFwdImageBytes); b: packed f32 biases; heads: f32 sigma and rgb head
// weights (bf16 values). rgb (P, 3), sigma (P) f32.
NERFSR_API int nerfsr_fused_mlp_fwd_tc(const void* x0, const void* dmb,
                                       const void* wimg, const void* b,
                                       const void* heads, void* rgb,
                                       void* sigma, int n_points,
                                       void* stream) {
  if (n_points <= 0) return 0;
  static bool smem_set = false;
  int err = set_smem(fused_mlp_fwd_tc_kernel, smem_set);
  if (err) return err;
  const int grid = (n_points + kBlockPoints - 1) / kBlockPoints;
  fused_mlp_fwd_tc_kernel<<<grid, kTileThreads, kTileSmemBytes,
                            (cudaStream_t)stream>>>(
      (const float*)x0, (const float*)dmb, (const char*)wimg,
      (const float*)b, (const float*)heads, (float*)rgb, (float*)sigma,
      n_points);
  return (int)cudaGetLastError();
}

// x (128, 256) bf16, wimg: four 32 KB chunks of a trunk layer's forward
// image; d (128, 256) f32 = x @ W.
NERFSR_API int nerfsr_tc_probe(const void* x, const void* wimg, void* d,
                               void* stream) {
  static bool smem_set = false;
  int err = set_smem(tc_probe_kernel, smem_set);
  if (err) return err;
  tc_probe_kernel<<<1, kTileThreads, kTileSmemBytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const char*)wimg, (float*)d);
  return (int)cudaGetLastError();
}

// The image and head sizes the wrapper packs, in bytes and floats.
NERFSR_API int nerfsr_fused_mlp_tc_layout(int* fwd_image_bytes,
                                          int* bwd_image_bytes,
                                          int* head_floats) {
  *fwd_image_bytes = (int)kFwdImageBytes;
  *bwd_image_bytes = (int)kBwdImageBytes;
  *head_floats = kHeadFloats;
  return 0;
}
