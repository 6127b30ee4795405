// Kernel C, f32: the fused NeRF MLP forward on Hopper's tensor cores, f32
// products as 3xTF32.
//
// Replaces the TPU kernel _fwd_kernel of
// nerfsr_tpu/ops/experimental/pallas_mlp.py (_fwd, in fused_nerf_mlp) for
// compute dtype f32, on the math of _fwd_pass: pre-embedded inputs x0 (P,
// 63) and dmb (P, 27) -> 8-layer ReLU trunk with [x0, h] before layer 4 ->
// f32 sigma head, 256-wide feature layer, 283 -> 128 ReLU direction
// branch, 128 -> 3 sigmoid rgb head. The bf16 route is fused_mlp_tc.cu.
//
// Numerics: every product is 3xTF32 (mlp_tf32.cuh), within ~2^-22 of
// the f32 product term by term, each chunk of 16 terms summed by the
// tensor cores and the chunks by f32 adds; biases, the heads and the
// activations in f32.
//
// Bound on the card: operations. 593,408 multiply-adds per point; at
// P = 65,536 a call is 77.8 GFLOP, three tf32 products each: 0.472 ms at
// the H100's 494.7 TFLOP/s dense tf32 rate (1.161 ms at 67 TFLOP/s, the
// f32 rate off the tensor cores), against ~25 MB of inputs and outputs.
//
// Design (mlp_tf32.cuh): 128 points a block, two consumer warpgroups of
// 64 points issuing wgmma m64n256k8 (m64n128k8 for the direction layer)
// with A, the split activations, from registers and B from a 3-stage ring
// of 32 KB chunks (16 rows, big and small images) that a producer
// warpgroup fills with cp.async.bulk on mbarriers. Each layer's output
// stays with the thread that computed it (its slot of the warpgroup's
// shared-memory tile) as the next layer's fragments. The sigma head is
// summed from the last trunk layer's registers and the rgb head from the
// direction layer's, across the four lanes that share a row.

#include "mlp_tf32.cuh"

namespace {

using namespace nerfsr_tf32;
using nerfsr_mlp::kBOffDir;
using nerfsr_mlp::kBOffFin;
using nerfsr_mlp::kBOffRgb;
using nerfsr_mlp::kBOffSig;

__global__ void __launch_bounds__(kTileThreads, 1)
fused_mlp_fwd_tf32_kernel(const float* __restrict__ x0,
                          const float* __restrict__ dmb,
                          const char* __restrict__ wimg,
                          const float* __restrict__ bs,
                          const float* __restrict__ heads,
                          float* __restrict__ rgb, float* __restrict__ sigma,
                          int n_points) {
  extern __shared__ __align__(128) char smem[];
  init_ring(smem);
  Ring ring = make_ring(smem);
  if (warp_uniform_div(128) == 2) {  // producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads)
      produce(wimg, nullptr, 0, kFwdChunks, smem, ring.full, ring.empty);
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp_uniform_div(128), t128 = threadIdx.x & 127;
  const int p0 = blockIdx.x * kBlockPoints + wg * kWgPoints;
  const int n = n_points;
  char* h = smem + kSmH + wg * kTileBytes + t128 * 16;
  const TileSrc hs{h, 0};

  float acc[128];
  for (int l = 0; l < kD; ++l) {
    trunk_product(acc, ring, l, x0, p0, n, h);
    bias_act<128, true>(acc, bs + l * kW);
    store_tile(acc, h);
  }
  // sigma head, from the last trunk activation in acc
  {
    float s[2];
    sigma_head(acc, heads + kHeadSig, s);
    const float b = __ldg(bs + kBOffSig);
    if ((threadIdx.x & 3) == 0)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (p0 + acc_row(j) < n) sigma[p0 + acc_row(j)] = s[j] + b;
  }
  // feat = h @ w_fin + b_fin (no activation)
  mma_chunks<kW / kChunkK, false, true>(acc, ring, hs);
  bias_act<128, false>(acc, bs + kBOffFin);
  store_tile(acc, h);
  // g = relu([feat, dmb] @ w_dir + b_dir), 128 wide, in registers
  float df[kDmbSlices][4];
  load_frags(df, dmb, kCDir, p0, n);
  float acc64[64];  // acc is dead here: the two share registers
  mma_chunks<kW / kChunkK, false, true>(acc64, ring, hs);
  mma_chunks<kDmbSlices / 2, true, true>(acc64, ring,
                                         RegSrc<kDmbSlices>{df});
  bias_act<64, true>(acc64, bs + kBOffDir);
  float pre[2][3];
  rgb_head(acc64, heads + kHeadRgb, pre);
  if ((threadIdx.x & 3) == 0)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = p0 + acc_row(j);
      if (p < n)
#pragma unroll
        for (int o = 0; o < 3; ++o)
          rgb[(size_t)p * 3 + o] =
              1.f / (1.f + expf(-(pre[j][o] + __ldg(bs + kBOffRgb + o))));
    }
}

int set_smem(bool& done) {
  // once in this process (the port runs on one card), so a CUDA graph
  // capture after the first call never meets it
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTileSmemBytes);
  if (err == cudaSuccess) done = true;
  return (int)err;
}

}  // namespace

// x0 (P, 63), dmb (P, 27) f32; wimg: the forward weight image (f32 big
// and small chunks, kFwdImageBytes); b: packed f32 biases; heads: f32
// sigma and rgb head weights. rgb (P, 3), sigma (P) f32.
NERFSR_API int nerfsr_fused_mlp_fwd_tf32(const void* x0, const void* dmb,
                                         const void* wimg, const void* b,
                                         const void* heads, void* rgb,
                                         void* sigma, int n_points,
                                         void* stream) {
  if (n_points <= 0) return 0;
  static bool smem_set = false;
  int err = set_smem(smem_set);
  if (err) return err;
  const int grid = (n_points + kBlockPoints - 1) / kBlockPoints;
  fused_mlp_fwd_tf32_kernel<<<grid, kTileThreads, kTileSmemBytes,
                              (cudaStream_t)stream>>>(
      (const float*)x0, (const float*)dmb, (const char*)wimg,
      (const float*)b, (const float*)heads, (float*)rgb, (float*)sigma,
      n_points);
  return (int)cudaGetLastError();
}

// The image and head sizes the wrapper packs, in bytes and floats.
NERFSR_API int nerfsr_fused_mlp_tf32_layout(int* fwd_image_bytes,
                                            int* bwd_image_bytes,
                                            int* head_floats) {
  *fwd_image_bytes = (int)kFwdImageBytes;
  *bwd_image_bytes = (int)kBwdImageBytes;
  *head_floats = kHeadFloats;
  return 0;
}
