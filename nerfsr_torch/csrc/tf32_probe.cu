// The tf32 layout probe: one warpgroup computes D (64 x 256, f32) = A (64
// x 32) B (32 x 256) through the tf32 wgmma pieces of wgmma.cuh, so their
// layouts are pinned on the card before the f32 kernels (fused_mlp_tf32.cu,
// fused_mlp_bwd_tf32.cu) rely on them:
//   mode 0: A and B from shared memory (K-major core matrices);
//   mode 1: A from registers at tf32_frag_row / tf32_frag_col, B's rows in
//           kTf32KOrder within each 8 (as the f32 kernels pack them);
//   mode 2: A from registers in the hardware's own placement (row l / 4 +
//           8 (r % 2), k-slot l % 4 + 4 (r / 2)), B's rows in order;
//   mode 3: mode 1 as 3xTF32: A split in registers, B's big and small
//           images in shared memory;
//   mode 4: mode 0 on A and B as given, f32 bits below tf32's included:
//           the tensor cores truncate them (seen on the H100), which is
//           why the kernels split with cvt.rna themselves.
// The images are B (256, 32) and A (64, 32) in [R/8][K/4][8][4] order,
// built by nerfsr_torch/kernels/mlp.py (tf32_probe).

#include "wgmma.cuh"

namespace {

using namespace nerfsr_tc;

constexpr int kPK = 32;                        // reduction
constexpr uint32_t kPMn = kPK / 4 * 128;       // bytes between 8-row groups

template <int kMode>
__global__ void __launch_bounds__(128, 1)
tf32_probe_kernel(const float* __restrict__ a,
                  const uint32_t* __restrict__ aimg,
                  const uint32_t* __restrict__ bimg,
                  const uint32_t* __restrict__ bsmall, float* __restrict__ d) {
  extern __shared__ __align__(128) char smem[];
  uint32_t* sa = reinterpret_cast<uint32_t*>(smem);  // 64 x 32
  uint32_t* sb = sa + 64 * kPK;                      // 256 x 32
  uint32_t* ss = sb + 256 * kPK;                     // 256 x 32
  for (int i = threadIdx.x; i < 64 * kPK; i += 128) sa[i] = aimg[i];
  for (int i = threadIdx.x; i < 256 * kPK; i += 128) {
    sb[i] = bimg[i];
    ss[i] = bsmall[i];
  }
  fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float acc[128];
  uint32_t big[kPK / 8][4], small[kPK / 8][4];
#pragma unroll
  for (int s = 0; s < kPK / 8; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int row = tf32_frag_row(r), col = tf32_frag_col(r);
      if (kMode == 2) col = (lane & 3) + 4 * (r >> 1);
      const float v = a[row * kPK + 8 * s + col];
      if (kMode == 3)
        split_tf32(v, big[s][r], small[s][r]);
      else
        big[s][r] = __float_as_uint(v);
    }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kPK / 8; ++s) {
    const uint64_t db = make_desc(smem_u32(sb) + s * 256, 128, kPMn);
    if (kMode == 0 || kMode == 4) {
      const uint64_t da = make_desc(smem_u32(sa) + s * 256, 128, kPMn);
      wgmma_m64n256k8_tf32(acc, da, db, s > 0);
    } else if (kMode == 3) {
      const uint64_t dbs = make_desc(smem_u32(ss) + s * 256, 128, kPMn);
      wgmma_m64n256k8_tf32_rs(acc, small[s], db, s > 0);
      wgmma_m64n256k8_tf32_rs(acc, big[s], dbs, 1);
      wgmma_m64n256k8_tf32_rs(acc, big[s], db, 1);
    } else {
      wgmma_m64n256k8_tf32_rs(acc, big[s], db, s > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = d + acc_row(j) * 256 + acc_col(i);
      o[0] = acc[4 * i + 2 * j];
      o[1] = acc[4 * i + 2 * j + 1];
    }
}

template <int kMode>
int launch(const void* a, const void* aimg, const void* bimg,
           const void* bsmall, void* d, cudaStream_t st) {
  constexpr int bytes = (64 + 2 * 256) * kPK * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tf32_probe_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  tf32_probe_kernel<kMode><<<1, 128, bytes, st>>>(
      (const float*)a, (const uint32_t*)aimg, (const uint32_t*)bimg,
      (const uint32_t*)bsmall, (float*)d);
  return (int)cudaGetLastError();
}

}  // namespace

// a (64, 32) f32 row-major; aimg (64 x 32), bimg and bsmall (256 x 32):
// images of A, B and B's small part; d (64, 256) f32.
NERFSR_API int nerfsr_tf32_probe(const void* a, const void* aimg,
                                 const void* bimg, const void* bsmall,
                                 void* d, int mode, void* stream) {
  auto st = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch<0>(a, aimg, bimg, bsmall, d, st);
    case 1: return launch<1>(a, aimg, bimg, bsmall, d, st);
    case 2: return launch<2>(a, aimg, bimg, bsmall, d, st);
    case 3: return launch<3>(a, aimg, bimg, bsmall, d, st);
    case 4: return launch<4>(a, aimg, bimg, bsmall, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
