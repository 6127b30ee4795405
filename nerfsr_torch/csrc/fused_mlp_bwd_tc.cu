// Kernel E, mixed precision (bf16): the fused NeRF MLP backward on
// Hopper's tensor cores.
//
// Replaces the TPU kernel _bwd_kernel_v3 of
// nerfsr_tpu/ops/experimental/pallas_mlp.py (_bwd, bwd_mode="pallas") for
// compute dtype bf16; the f32 route is fused_mlp_bwd_tf32.cu.
// The numerics rule is kernels/mlp.py's: kernel C's bf16 recompute,
// every backpropagated gradient rounded to bf16 after its ReLU mask, the
// sigma cotangent in f32, every weight and bias gradient summed in f32.
//
// Bound on the card: operations. 1,744,512 multiply-adds per point
// (593,408 recompute, 557,696 input gradients, 593,408 weight gradients):
// 114.3 GFLOP at P = 32,768, 0.116 ms at 989 TFLOP/s bf16. The bf16
// scratch (2,528 + 2,440 values per point, written once, read about twice)
// is ~0.5 GB, ~0.15 ms at 3.35 TB/s.
//
// Design. Three launches, no atomics (two calls give the same bits):
//   E1 (tile):  kernel C's 128-point tile (mlp_tc.cuh) recomputes the
//               forward and backpropagates down the trunk. The input-
//               gradient products gh @ W^T run on the same wgmma, with B
//               read from a second pre-packed image of W itself (K-major
//               for this product), streamed through the same ring after
//               the forward chunks. Every layer's input activation and
//               output gradient goes from the warpgroup's shared tile to
//               a point-major bf16 scratch (exact: every value there is a
//               bf16 value). The trunk's ReLU masks stay on chip, one bit
//               per accumulator value in shared memory.
//   E2 (wgrad): dW = A^T G over 16 fixed point splits. A block owns a
//               128 (dW rows) x N (the layer's whole out-width: 256, 128,
//               or 64 holding rgb's 3) tile of one product and one split;
//               both operands are point-major in the scratch, so wgmma
//               reads them MN-major from shared memory, 64 points a chunk,
//               loaded by TMA as 128-byte-swizzled boxes of 64 columns
//               into a 3-stage ring on mbarriers. The first row tile
//               of each product also sums its gradient columns (the bias
//               gradient) from the staged chunk, and the final layer's
//               tiles sum a7 * gsigma (sigma's weight gradient, f32
//               gsigma read from the input, never rounded).
//   E3:         sums the 16 partial buffers in split order.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "mlp_tc.cuh"

namespace {

using namespace nerfsr_tc;
using nerfsr_mlp::kBOffDir;
using nerfsr_mlp::kBOffFin;
using nerfsr_mlp::kBOffRgb;
using nerfsr_mlp::kBOffSig;
using nerfsr_mlp::kNWeights;
using nerfsr_mlp::kTotal;
using nerfsr_mlp::kWOff;
using nerfsr_mlp::kWOffDir;
using nerfsr_mlp::kWOffFin;
using nerfsr_mlp::kWOffRgb;
using nerfsr_mlp::kWOffSig;
using nerfsr_mlp::reduce_splits;

// Scratch rows, one per point, bf16, every block 8-aligned. Activations:
//   a0 | a1 | a2 | x0 (64) | a3 .. a7 | feat | dmb (32) | g
// so the skip layer's input [x0, a3] and the direction layer's [feat,
// dmb] are contiguous. Gradients: gh0 .. gh7 | gfeat | gg | grgb_pre (8).
constexpr int kAOffX0 = 3 * kW;
__host__ __device__ constexpr int act_off(int l) {
  return l < 3 ? l * kW : kAOffX0 + kX0K + (l - 3) * kW;
}
constexpr int kAOffFeat = act_off(kD);
constexpr int kAOffDmb = kAOffFeat + kW;
constexpr int kAOffG = kAOffDmb + kDmbK;
constexpr int kAW = kAOffG + kWHalf;
constexpr int kGOffFeat = kD * kW;
constexpr int kGOffGG = kGOffFeat + kW;
constexpr int kGOffPre = kGOffGG + kWHalf;
constexpr int kGW = kGOffPre + 8;
static_assert(kAW == 2528 && kGW == 2440, "scratch rows of kernels/mlp.py");

constexpr int kSplits = 16;

// E3: the sum over the splits, in split order
__global__ void mlp_bwd_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out) {
  reduce_splits(partial, out, kSplits);
}

// ------------------------------------------------------------------ E1
// ReLU masks of the 8 trunk activations, one bit per accumulator value:
// thread t of the block keeps layer l's 128 bits at kSmMask + (l * 256 +
// t) * 16, bit k of the mask for acc[k]. The backward products have the
// forward's accumulator shape, so each thread reads back its own bits.
constexpr uint32_t kSmMask = (kTileSmemBytes + 15) / 16 * 16;
constexpr uint32_t kE1SmemBytes = kSmMask + kD * kConsumerThreads * 16;
static_assert(kE1SmemBytes <= 232448, "shared memory of one block");

__device__ __forceinline__ void store_mask(const float (&acc)[128],
                                           char* smem, int l) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 128; ++k) w[k / 32] |= (acc[k] > 0.f ? 1u : 0u) << (k % 32);
  *reinterpret_cast<uint4*>(smem + kSmMask + (l * kConsumerThreads +
                                              threadIdx.x) * 16) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// gradient epilogue: v = acc (+ gsig * w_sig), zeroed where layer
// `mask_layer`'s activation is not positive (none if < 0), rounded to
// bf16, into the warpgroup's tile (256 columns)
template <bool kSig>
__device__ __forceinline__ void grad_epilogue(float (&acc)[128],
                                              const char* smem,
                                              int mask_layer,
                                              const float (&gs)[2],
                                              const float* __restrict__ w_sig,
                                              char* tile) {
  uint4 m4 = make_uint4(~0u, ~0u, ~0u, ~0u);
  if (mask_layer >= 0)
    m4 = *reinterpret_cast<const uint4*>(
        smem + kSmMask + (mask_layer * kConsumerThreads + threadIdx.x) * 16);
  const uint32_t m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = acc_col(i);
    float w0 = 0.f, w1 = 0.f;
    if (kSig) {
      w0 = __ldg(w_sig + col);
      w1 = __ldg(w_sig + col + 1);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 4 * i + 2 * j;
      float v0 = acc[k], v1 = acc[k + 1];
      if (kSig) {
        v0 = fmaf(gs[j], w0, v0);
        v1 = fmaf(gs[j], w1, v1);
      }
      v0 = (m[k / 32] >> (k % 32)) & 1u ? v0 : 0.f;
      v1 = (m[k / 32] >> ((k + 1) % 32)) & 1u ? v1 : 0.f;
      st_pair(tile, acc_row(j), col, kW, v0, v1);
    }
  }
}

__global__ void __launch_bounds__(kTileThreads, 1)
mlp_bwd_tile_tc_kernel(const float* __restrict__ x0,
                       const float* __restrict__ dmb,
                       const float* __restrict__ grgb,
                       const float* __restrict__ gsig,
                       const char* __restrict__ wimg,
                       const char* __restrict__ wimg_bwd,
                       const float* __restrict__ bs,
                       const float* __restrict__ heads,
                       __nv_bfloat16* __restrict__ acts,
                       __nv_bfloat16* __restrict__ grads, int n_points) {
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
      produce(wimg, wimg_bwd, kFwdChunks + kBwdChunks, smem, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp_uniform_div(128), t128 = threadIdx.x & 127;
  const int p0 = blockIdx.x * kBlockPoints + wg * kWgPoints;
  const int n = n_points;
  char* h = smem + kSmH + wg * (kWgPoints * kW * 2);
  char* xs = smem + kSmX0 + wg * (kWgPoints * kX0K * 2);
  char* ds = smem + kSmDmb + wg * (kWgPoints * kDmbK * 2);
  const uint32_t ha = smem_u32(h), xa = smem_u32(xs), da = smem_u32(ds);
  const int bar = 1 + wg;
  Ring ring{smem_u32(smem + kSmRing), full, empty, 0};

  load_input(xs, x0, kCPos, kX0K, p0, n, t128);
  load_input(ds, dmb, kCDir, kDmbK, p0, n, t128);
  fence_proxy_async();
  bar_sync(bar, 128);
  copy_out(xs, kX0K, acts, kAW, kAOffX0, p0, n, t128);
  copy_out(ds, kDmbK, acts, kAW, kAOffDmb, p0, n, t128);

  // ---- forward recompute: kernel C's products, each layer's output to
  // the activation scratch
  float acc[128];
  for (int l = 0; l < kD; ++l) {
    trunk_product(acc, ring, l, xa, ha);
    bar_sync(bar, 128);
    epilogue<128, true>(acc, bs + l * kW, h);
    store_mask(acc, smem, l);
    fence_proxy_async();
    bar_sync(bar, 128);
    copy_out(h, kW, acts, kAW, act_off(l), p0, n, t128);
  }
  mma_chunks<4, kChunkK, false>(acc, ring, ha, kW * 16);
  bar_sync(bar, 128);
  epilogue<128, false>(acc, bs + kBOffFin, h);
  fence_proxy_async();
  bar_sync(bar, 128);
  copy_out(h, kW, acts, kAW, kAOffFeat, p0, n, t128);

  float acc64[64];
  mma_chunks<4, kChunkK, false>(acc64, ring, ha, kW * 16);
  mma_chunks<1, kDmbK, true>(acc64, ring, da, kDmbK * 16);
  bar_sync(bar, 128);  // feat has been read: h is free
  // g = relu(. + b_dir), rounded; to the tile (128 columns) and scratch
  epilogue<64, true>(acc64, bs + kBOffDir, h);
  bar_sync(bar, 128);
  copy_out(h, kWHalf, acts, kAW, kAOffG, p0, n, t128);

  // ---- heads: rgb_pre's gradient, then gg = relu'(g) (grgb_pre @ w_rgb^T)
  float pre[2][3], gp[2][3];
  rgb_head(acc64, heads + kHeadRgb, pre);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = p0 + acc_row(j);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float r = 1.f / (1.f + expf(-(pre[j][o] + __ldg(bs + kBOffRgb + o))));
      gp[j][o] = p < n ? round_bf16(grgb[(size_t)p * 3 + o] * r * (1.f - r))
                       : 0.f;
    }
    if ((threadIdx.x & 3) == 0 && p < n) {
      alignas(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = __float2bfloat16_rn(o < 3 ? gp[j][o] : 0.f);
      *reinterpret_cast<uint4*>(grads + (size_t)p * kGW + kGOffPre) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
  bar_sync(bar, 128);  // g's copy has read the tile
  const float* w_rgb = heads + kHeadRgb;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = acc_col(i);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* w = w_rgb + 3 * (col + c);
        const float s = gp[j][0] * __ldg(w) + gp[j][1] * __ldg(w + 1) +
                        gp[j][2] * __ldg(w + 2);
        v[c] = acc64[4 * i + 2 * j + c] > 0.f ? s : 0.f;
      }
      st_pair(h, acc_row(j), col, kWHalf, v[0], v[1]);
    }
  }
  fence_proxy_async();
  bar_sync(bar, 128);
  copy_out(h, kWHalf, grads, kGW, kGOffGG, p0, n, t128);

  // ---- backward down the trunk
  const float no_gs[2] = {0.f, 0.f};
  // gfeat = gg @ w_dir[:256]^T (no mask)
  mma_chunks<2, kChunkK, false>(acc, ring, ha, kWHalf * 16);
  bar_sync(bar, 128);
  grad_epilogue<false>(acc, smem, -1, no_gs, nullptr, h);
  fence_proxy_async();
  bar_sync(bar, 128);
  copy_out(h, kW, grads, kGW, kGOffFeat, p0, n, t128);
  // gh7 = relu'(a7) (gfeat @ w_fin^T + gsigma w_sig^T)
  float gs[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = p0 + acc_row(j);
    gs[j] = p < n ? gsig[p] : 0.f;
  }
  mma_chunks<4, kChunkK, false>(acc, ring, ha, kW * 16);
  bar_sync(bar, 128);
  grad_epilogue<true>(acc, smem, kD - 1, gs, heads + kHeadSig, h);
  fence_proxy_async();
  bar_sync(bar, 128);
  copy_out(h, kW, grads, kGW, (kD - 1) * kW, p0, n, t128);
  // gh_{l-1} = relu'(a_{l-1}) (gh_l @ w_l[h rows]^T)
  for (int l = kD - 1; l > 0; --l) {
    mma_chunks<4, kChunkK, false>(acc, ring, ha, kW * 16);
    bar_sync(bar, 128);
    grad_epilogue<false>(acc, smem, l - 1, no_gs, nullptr, h);
    fence_proxy_async();
    bar_sync(bar, 128);
    copy_out(h, kW, grads, kGW, (l - 1) * kW, p0, n, t128);
  }
}

// ------------------------------------------------------------------ E2
struct Prod {
  int a_off;   // first activation column of the product's input
  int m_load;  // input columns staged (m_end rounded up to 64)
  int m_end;   // input columns that are dW rows (or the hole)
  int hole;    // input column that is padding inside the range, or -1
  int g_off;   // first gradient column
  int n;       // gradient columns staged (dW columns, padded to 64)
  int n_out;   // dW columns
  int w_off;   // offset of dW in the packed gradients
  int b_off;   // offset of db in the packed bias gradients
};
__constant__ Prod kProds[11] = {
    {kAOffX0, 64, kCPos, -1, 0, kW, kW, kWOff(0), 0},
    {act_off(0), kW, kW, -1, 1 * kW, kW, kW, kWOff(1), 1 * kW},
    {act_off(1), kW, kW, -1, 2 * kW, kW, kW, kWOff(2), 2 * kW},
    {act_off(2), kW, kW, -1, 3 * kW, kW, kW, kWOff(3), 3 * kW},
    {kAOffX0, kX0K + kW, kX0K + kW, kCPos, 4 * kW, kW, kW, kWOff(4), 4 * kW},
    {act_off(4), kW, kW, -1, 5 * kW, kW, kW, kWOff(5), 5 * kW},
    {act_off(5), kW, kW, -1, 6 * kW, kW, kW, kWOff(6), 6 * kW},
    {act_off(6), kW, kW, -1, 7 * kW, kW, kW, kWOff(7), 7 * kW},
    {act_off(7), kW, kW, -1, kGOffFeat, kW, kW, kWOffFin, kBOffFin},
    {kAOffFeat, 320, kW + kCDir, -1, kGOffGG, kWHalf, kWHalf, kWOffDir,
     kBOffDir},
    {kAOffG, kWHalf, kWHalf, -1, kGOffPre, 64, 3, kWOffRgb, kBOffRgb},
};
constexpr int kE2Tiles = 22;    // 128-row tiles over the 11 products
constexpr int kE2Threads = 256;
constexpr int kE2Stages = 3;
constexpr int kE2Points = 64;   // points a chunk
// A stage: A (up to 128 dW rows), then B (up to 256 columns), as boxes
// of 64 columns x 64 points (8 KB), then 64 f32 of gsigma
constexpr uint32_t kE2Box = 64 * kE2Points * 2;
constexpr uint32_t kE2A = 0;
constexpr uint32_t kE2B = kE2A + 2 * kE2Box;
constexpr uint32_t kE2S = kE2B + 4 * kE2Box;
constexpr uint32_t kE2Stage = (kE2S + kE2Points * 4 + 1023) / 1024 * 1024;
constexpr uint32_t kE2SmemBytes = kE2Stages * kE2Stage + kE2Stages * 8;

// TMA: a box of 64 columns x 64 point rows lands 128-byte-swizzled, one
// 128-byte row per point: the MN-major B128 layout wgmma reads. Rows and
// columns past the end of the scratch read as zero.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_1d(void* dst, const CUtensorMap* map,
                                       int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(smem_u32(bar))
      : "memory");
}

// the value of column c (of a staged operand) at point p: box c / 64,
// row p, 16-byte chunk swizzled by p % 8
__device__ __forceinline__ float bf16_at(const char* opnd, int c, int p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
      opnd + (c >> 6) * kE2Box + p * 128 + ((((c >> 3) & 7) ^ (p & 7)) << 4) +
      (c & 7) * 2));
}

// sum of f(p) over a chunk's 64 points: four partial sums over p % 4,
// combined in a fixed order (independent adds, the same bits every run)
template <typename F>
__device__ __forceinline__ float sum64(F f) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < kE2Points; ++p) s[p & 3] += f(p);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

template <int NR>
__device__ __forceinline__ void wgrad_mma(float (&acc)[NR], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int t = 0; t < kE2Points / 16; ++t) {
    // a k16 step is two 8-point groups of 1024 bytes
    const uint64_t da = make_desc_sw128(a + t * 2048, kE2Box, 1024);
    const uint64_t db = make_desc_sw128(b + t * 2048, kE2Box, 1024);
    if constexpr (NR == 128)
      wgmma_m64n256k16<1, 1>(acc, da, db, 1);
    else if constexpr (NR == 64)
      wgmma_m64n128k16<1, 1>(acc, da, db, 1);
    else
      wgmma_m64n64k16<1, 1>(acc, da, db, 1);
  }
}

struct Maps {
  const CUtensorMap* acts;   // (P, kAW) bf16
  const CUtensorMap* grads;  // (P, kGW) bf16
  const CUtensorMap* gsig;   // (P) f32
};

template <int NR>
__device__ __forceinline__ void wgrad_tile(const Prod& pr, int mt,
                                           const Maps& maps,
                                           float* __restrict__ part, int pb,
                                           int pe, char* smem,
                                           uint64_t* full) {
  const int tid = threadIdx.x, wg = warp_uniform_div(128);
  const bool issuer = warp_uniform_div(32) == 0;
  const int m0 = mt * 128;
  const int a_boxes = min(2, (pr.m_load - m0) / 64);
  const int b_boxes = pr.n / 64;
  const bool active = m0 + wg * kWgPoints < pr.m_load;
  const bool sums = mt == 0;                 // bias gradient columns
  const bool sig = pr.a_off == act_off(kD - 1) && pr.g_off == kGOffFeat;
  const int n_chunks = (pe - pb + kE2Points - 1) / kE2Points;
  const uint32_t bytes =
      (a_boxes + b_boxes) * kE2Box + (sig ? kE2Points * 4 : 0);

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  float bsum = 0.f, ssum = 0.f, gsum = 0.f;

  // one thread of warp 0 loads chunk c into stage c % kE2Stages
  auto load = [&](int c) {
    const int s = c % kE2Stages;
    char* st = smem + s * kE2Stage;
    const int pc = pb + c * kE2Points;
    mbar_expect_tx(&full[s], bytes);
    for (int j = 0; j < a_boxes; ++j)
      tma_2d(st + kE2A + j * kE2Box, maps.acts, pr.a_off + m0 + 64 * j, pc,
             &full[s]);
    for (int j = 0; j < b_boxes; ++j)
      tma_2d(st + kE2B + j * kE2Box, maps.grads, pr.g_off + 64 * j, pc,
             &full[s]);
    if (sig) tma_1d(st + kE2S, maps.gsig, pc, &full[s]);
  };
  if (issuer && (tid & 31) == 0)
    for (int c = 0; c < kE2Stages - 1 && c < n_chunks; ++c) load(c);
  for (int c = 0; c < n_chunks; ++c) {
    // stage (c - 1) % kE2Stages was released by the barrier that ended
    // the previous chunk
    if (issuer && (tid & 31) == 0 && c + kE2Stages - 1 < n_chunks)
      load(c + kE2Stages - 1);
    const int s = c % kE2Stages;
    mbar_wait(&full[s], (c / kE2Stages) & 1);
    char* st = smem + s * kE2Stage;
    if (active) {
      wgmma_fence();
      wgrad_mma(acc, smem_u32(st + kE2A) + wg * kE2Box, smem_u32(st + kE2B));
      wgmma_commit();
    }
    // f32 column sums from the staged chunk (rows past the scratch's end
    // are zero), each as four interleaved partial sums added in a fixed
    // order
    if (sums && tid < pr.n) {
      const char* b = st + kE2B;
      bsum += sum64([&](int p) { return bf16_at(b, tid, p); });
    }
    if (sig) {
      const float* gs = reinterpret_cast<const float*>(st + kE2S);
      if (tid < 128) {
        const char* a = st + kE2A;
        ssum += sum64([&](int p) { return bf16_at(a, tid, p) * gs[p]; });
      } else if (tid == 128 && sums) {
        gsum += sum64([&](int p) { return gs[p]; });
      }
    }
    if (active) {
      wgmma_wait<0>();
      reg_fence(acc);
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < NR / 4; ++i) {
      const int col = acc_col(i);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = m0 + wg * kWgPoints + acc_row(j);
        if (m >= pr.m_end || m == pr.hole) continue;
        const int row = (pr.hole >= 0 && m > pr.hole) ? m - 1 : m;
        float* o = part + pr.w_off + (size_t)row * pr.n_out + col;
        if (col < pr.n_out) o[0] = acc[4 * i + 2 * j];
        if (col + 1 < pr.n_out) o[1] = acc[4 * i + 2 * j + 1];
      }
    }
  }
  if (sums && tid < pr.n_out) part[kNWeights + pr.b_off + tid] = bsum;
  if (sig && tid < 128) part[kWOffSig + m0 + tid] = ssum;
  if (sig && sums && tid == 128) part[kNWeights + kBOffSig] = gsum;
}

__global__ void __launch_bounds__(kE2Threads, 1)
mlp_bwd_wgrad_tc_kernel(const __grid_constant__ CUtensorMap acts_map,
                        const __grid_constant__ CUtensorMap grads_map,
                        const __grid_constant__ CUtensorMap gsig_map,
                        float* __restrict__ partial, int n_points) {
  // a name of its own: E1's `smem` is declared 128-aligned in this file,
  // and two alignments on one symbol leave the base's to chance. The
  // 128-byte-swizzled TMA boxes need each stage 1024-aligned (kE2Stage
  // rounds the stages to 1024 from the base), so a misplaced base traps
  // rather than scrambling the tiles.
  extern __shared__ __align__(1024) char e2_smem[];
  char* smem = e2_smem;
  if (smem_u32(smem) & 1023u) __trap();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kE2Stages * kE2Stage);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kE2Stages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int split = blockIdx.y;
  // whole chunks per split; only the last split can end inside a chunk
  const int per = (n_points + kSplits * kE2Points - 1) / (kSplits * kE2Points) *
                  kE2Points;
  const int pb = min(n_points, split * per);
  const int pe = min(n_points, pb + per);
  int t = blockIdx.x, prod = 0;
  for (; prod < 11; ++prod) {
    const int tiles = (kProds[prod].m_load + 127) / 128;
    if (t < tiles) break;
    t -= tiles;
  }
  const Prod pr = kProds[prod];
  const Maps maps{&acts_map, &grads_map, &gsig_map};
  float* part = partial + (size_t)split * kTotal;
  if (pr.n == kW)
    wgrad_tile<128>(pr, t, maps, part, pb, pe, smem, full);
  else if (pr.n == kWHalf)
    wgrad_tile<64>(pr, t, maps, part, pb, pe, smem, full);
  else
    wgrad_tile<32>(pr, t, maps, part, pb, pe, smem, full);
}

// Tensor maps of the point-major scratch (boxes of 64 columns x 64 rows)
// and of gsigma (64 values), through the driver's encoder.
int make_maps(const void* acts, const void* grads, const void* gsig,
              int n_points, CUtensorMap* maps) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return (int)cudaErrorNotSupported;
    }
  }
  const cuuint32_t elem[2] = {1, 1};
  const cuuint32_t box2[2] = {64, (cuuint32_t)kE2Points};
  const void* bases[2] = {acts, grads};
  const int widths[2] = {kAW, kGW};
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)widths[i], (cuuint64_t)n_points};
    const cuuint64_t strides[1] = {(cuuint64_t)widths[i] * 2};
    if (encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(bases[i]), dims, strides, box2, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const cuuint64_t dim1[1] = {(cuuint64_t)n_points};
  const cuuint64_t stride1[1] = {4};
  const cuuint32_t box1[1] = {(cuuint32_t)kE2Points};
  if (encode(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
             const_cast<void*>(gsig), dim1, stride1, box1, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int set_smem(bool& done) {
  // once in this process (the port runs on one card), so a CUDA graph
  // capture after the first call never meets it
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_tile_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kE1SmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlp_bwd_wgrad_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kE2SmemBytes);
  if (err == cudaSuccess) done = true;
  return (int)err;
}

}  // namespace

// x0 (P, 63), dmb (P, 27), grgb (P, 3), gsig (P) f32; wimg / wimg_bwd:
// the forward and backward weight images (bf16); b: packed f32 biases;
// heads: f32 sigma and rgb head weights (bf16 values). Scratch: acts
// (P, 2528) and grads (P, 2440) bf16, partial (16, 595844) f32. out
// (595844) f32: the packed weight gradients, then the bias gradients.
NERFSR_API int nerfsr_fused_mlp_bwd_tc(const void* x0, const void* dmb,
                                       const void* grgb, const void* gsig,
                                       const void* wimg, const void* wimg_bwd,
                                       const void* b, const void* heads,
                                       void* acts, void* grads, void* partial,
                                       void* out, int n_points,
                                       void* stream) {
  auto st = (cudaStream_t)stream;
  if (n_points <= 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * kTotal, st);
  static bool smem_set = false;
  int err = set_smem(smem_set);
  if (err) return err;
  mlp_bwd_tile_tc_kernel<<<(n_points + kBlockPoints - 1) / kBlockPoints,
                           kTileThreads, kE1SmemBytes, st>>>(
      (const float*)x0, (const float*)dmb, (const float*)grgb,
      (const float*)gsig, (const char*)wimg, (const char*)wimg_bwd,
      (const float*)b, (const float*)heads, (__nv_bfloat16*)acts,
      (__nv_bfloat16*)grads, n_points);
  err = (int)cudaGetLastError();
  if (err) return err;
  CUtensorMap maps[3];
  err = make_maps(acts, grads, gsig, n_points, maps);
  if (err) return err;
  mlp_bwd_wgrad_tc_kernel<<<dim3(kE2Tiles, kSplits), kE2Threads,
                            kE2SmemBytes, st>>>(maps[0], maps[1], maps[2],
                                                (float*)partial, n_points);
  err = (int)cudaGetLastError();
  if (err) return err;
  mlp_bwd_reduce_kernel
      <<<(kTotal + 255) / 256, 256, 0, st>>>((const float*)partial,
                                             (float*)out);
  return (int)cudaGetLastError();
}

// The scratch shapes the wrapper allocates.
NERFSR_API int nerfsr_fused_mlp_bwd_tc_layout(int* act_width, int* grad_width,
                                              int* splits, int* total) {
  *act_width = kAW;
  *grad_width = kGW;
  *splits = kSplits;
  *total = kTotal;
  return 0;
}
