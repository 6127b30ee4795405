// Kernel E, f32: the fused NeRF MLP backward (weight and bias gradients)
// on Hopper's tensor cores, f32 products as 3xTF32.
//
// Replaces the TPU kernel _bwd_kernel_v3 of
// nerfsr_tpu/ops/experimental/pallas_mlp.py (_bwd, bwd_mode="pallas") for
// compute dtype f32: recompute the D8/W256 forward per point tile,
// backpropagate the rgb and sigma cotangents, and sum all 12 weight
// gradients (in, out) and 12 bias gradients over the points, in f32. The
// gradients of the inputs are zero by the JAX contract and are not
// computed. The bf16 route is fused_mlp_bwd_tc.cu.
//
// Bound on the card: operations. 1,744,512 multiply-adds per point
// (593,408 recompute, 557,696 input gradients, 593,408 weight gradients):
// 114.3 GFLOP at P = 32,768, three tf32 products each, 0.693 ms at 494.7
// TFLOP/s (1.706 ms at the 67 TFLOP/s f32 rate). The f32 scratch (2,528 +
// 2,440 values per point, written once and read about twice) is ~1 GB,
// ~0.3 ms at 3.35 TB/s.
//
// Design. Three launches, no atomics (two calls give the same bits):
//   E1 (tile):  a block of 128 points, kernel C's f32 tile (mlp_tf32.cuh).
//               First the two consumer warpgroups recompute the forward on
//               SIMT FMAs, in f32 as the plain version sums it (so the
//               ReLU masks fall where its masks fall: 3xTF32's sums move
//               some across zero, and the first layers' weight gradients
//               magnify each such move past the f32 bar), writing every
//               layer's input and output, then rgb_pre's gradient and gg.
//               Then the backward down the trunk runs on the tensor cores:
//               the input-gradient products gh @ W^T as 3xTF32 wgmma, A
//               (the gradient, split in registers) from the thread that
//               computed it, B from a pre-packed image of W (K-major for
//               this product, rows in kTf32KOrder) that the producer
//               warpgroup streams through the ring; each ReLU mask is read
//               back from the activations. Every layer's input activation
//               and output gradient goes to an f32 scratch laid out as
//               E2's operands: feature-major tiles of 32 points,
//               [P/32][features/8][8][8][4], each (8 features x 32 points)
//               the K-major core matrices of a product that reduces over
//               the points. Every row of the last block is written: past
//               the point count the cotangents are zero, so its gradients
//               are.
//   E2 (wgrad): dW = A^T G over 16 fixed point splits. A block owns a
//               128 (dW rows) x N (the layer's whole out-width: 256, 128,
//               or 8 holding rgb's 3) tile of one product and one split,
//               two warpgroups of 64 rows. Each 32-point chunk of both
//               operands is a contiguous run of the scratch: the block
//               loads it into registers (the next chunk while the tensor
//               cores work on this one), splits every value into big and
//               small and stores the four images into one of two shared
//               buffers, and wgmma reads them all from shared memory
//               (K-major, 3xTF32). The first row tile of each product sums
//               its gradient columns (the bias gradient) and the final
//               layer's tiles sum a7 * gsigma (sigma's weight gradient)
//               from the loaded f32 values, in a fixed order.
//   E3:         sums the 16 partial buffers in split order.

#include "mlp_tf32.cuh"

namespace {

using namespace nerfsr_tf32;
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

// Scratch features, f32, every block 8-aligned. Activations:
//   a0 | a1 | a2 | x0 (64) | a3 .. a7 | feat | dmb (32) | g
// so the skip layer's input [x0, a3] and the direction layer's [feat,
// dmb] are contiguous. Gradients: gh0 .. gh7 | gfeat | gg | grgb_pre (8).
constexpr int kAOffX0 = 3 * kW;
__host__ __device__ constexpr int act_off(int l) {
  return l < 3 ? l * kW : kAOffX0 + kX0Slices * 8 + (l - 3) * kW;
}
constexpr int kAOffFeat = act_off(kD);
constexpr int kAOffDmb = kAOffFeat + kW;
constexpr int kAOffG = kAOffDmb + kDmbSlices * 8;
constexpr int kAW = kAOffG + kWHalf;
constexpr int kGOffFeat = kD * kW;
constexpr int kGOffGG = kGOffFeat + kW;
constexpr int kGOffPre = kGOffGG + kWHalf;
constexpr int kGW = kGOffPre + 8;
static_assert(kAW == 2528 && kGW == 2440, "scratch rows of kernels/mlp.py");

constexpr int kSplits = 16;
constexpr int kTilePoints = 32;  // points a scratch tile (E2's chunk)

// E3: the sum over the splits, in split order
__global__ void mlp_bwd_reduce_tf32_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out) {
  reduce_splits(partial, out, kSplits);
}

// float index of (point p, feature f) in a scratch of `width` features:
// [P/32][width/8][8 point quads][8 features][4 points]
__device__ __forceinline__ size_t scratch_at(int width, int p, int f) {
  return ((size_t)(p >> 5) * (width >> 3) + (f >> 3)) * 256 +
         ((p & 31) >> 2) * 32 + (f & 7) * 4 + (p & 3);
}

// ------------------------------------------------------------------ E1
// acc's values (columns off + acc_col(i) + c of rows p0 + acc_row(j)) to
// the scratch
template <int NR>
__device__ __forceinline__ void write_acc(float* __restrict__ scr, int width,
                                          int off, const float (&acc)[NR],
                                          int p0) {
#pragma unroll
  for (int i = 0; i < NR / 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = scr + scratch_at(width, p0 + acc_row(j), off + acc_col(i));
      o[0] = acc[4 * i + 2 * j];
      o[4] = acc[4 * i + 2 * j + 1];  // the next feature
    }
}

// the scratch's values at acc's places (the inverse of write_acc)
template <int NR>
__device__ __forceinline__ void read_acc(const float* __restrict__ scr,
                                         int width, int off, float (&acc)[NR],
                                         int p0) {
#pragma unroll
  for (int i = 0; i < NR / 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* o =
          scr + scratch_at(width, p0 + acc_row(j), off + acc_col(i));
      acc[4 * i + 2 * j] = o[0];
      acc[4 * i + 2 * j + 1] = o[4];
    }
}

// ReLU mask of trunk activation l at acc's places, one bit per value
// (bit k: acc[k]'s activation > 0), read back from the scratch
__device__ __forceinline__ uint4 relu_mask(const float* __restrict__ acts,
                                           int l, int p0) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* o =
          acts + scratch_at(kAW, p0 + acc_row(j), act_off(l) + acc_col(i));
      const int k = 4 * i + 2 * j;
      w[k / 32] |= (o[0] > 0.f ? 1u : 0u) << (k % 32);
      w[k / 32] |= (o[4] > 0.f ? 1u : 0u) << ((k + 1) % 32);
    }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// gradient epilogue: v = acc (+ gs[j] * w_sig[col]), zeroed where the
// mask's bit is clear (no mask: all set), in place
template <bool kSig>
__device__ __forceinline__ void grad_epilogue(float (&acc)[128], uint4 m4,
                                              const float (&gs)[2],
                                              const float* __restrict__ w_sig) {
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
      acc[k] = (m[k / 32] >> (k % 32)) & 1u ? v0 : 0.f;
      acc[k + 1] = (m[k / 32] >> ((k + 1) % 32)) & 1u ? v1 : 0.f;
    }
  }
}

// ---- E1's first phase: the forward recompute on SIMT FMAs. Each
// consumer warpgroup recomputes its 64 points, 32 at a time, with the
// tile's activations in shared memory: thread t owns columns t and t +
// 128, each weight row is read coalesced from the f32 kernels (in, out)
// and the point activations are float4 broadcasts. f32 FMAs summed in
// order put the ReLU masks where the plain version's f32 sums put them
// (3xTF32's sums, rounded otherwise, move more of them across zero, and
// the first layers' weight gradients magnify each move: kernels/mlp.py).
constexpr int kTP = 32;                              // points a pass
constexpr int kXS = 64;                              // x0 row stride
constexpr int kDS = 28;                              // dmb row stride
constexpr uint32_t kSimtBytes = 4 * kTP * (kXS + kDS + 2 * kW + 4);
static_assert(2 * kSimtBytes <= kSmBar, "E1's first phase in the ring");

// acc[c][p] += sum_{k < K} in[p * stride + k] * w[k * ldw + t + 128 c];
// rows of `in` zero-padded to a multiple of 4
template <int NC>
__device__ __forceinline__ void dense_acc(float (&acc)[NC][kTP],
                                          const float* __restrict__ in,
                                          int stride, int K,
                                          const float* __restrict__ w,
                                          int ldw, int t) {
  float wn[4][NC];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wn[kk][c] = kk < K ? __ldg(w + (size_t)kk * ldw + t + c * 128) : 0.f;
  for (int k = 0; k < K; k += 4) {
    float wc[4][NC];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) wc[kk][c] = wn[kk][c];
    if (k + 4 < K) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wn[kk][c] = k + 4 + kk < K
                          ? __ldg(w + (size_t)(k + 4 + kk) * ldw + t + c * 128)
                          : 0.f;
    }
#pragma unroll
    for (int p = 0; p < kTP; ++p) {
      const float4 h = *reinterpret_cast<const float4*>(in + p * stride + k);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float a = acc[c][p];
        a = fmaf(h.x, wc[0][c], a);
        a = fmaf(h.y, wc[1][c], a);
        a = fmaf(h.z, wc[2][c], a);
        a = fmaf(h.w, wc[3][c], a);
        acc[c][p] = a;
      }
    }
  }
}

// out[p][col] = relu?(acc + bias[col]) in shared memory; acc <- 0
template <int NC, bool kRelu>
__device__ __forceinline__ void store_simt(float (&acc)[NC][kTP],
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int t) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = t + c * 128;
    const float b = __ldg(bias + col);
#pragma unroll
    for (int p = 0; p < kTP; ++p) {
      float v = acc[c][p] + b;
      if (kRelu) v = fmaxf(v, 0.f);
      out[p * kW + col] = v;
      acc[c][p] = 0.f;
    }
  }
}

// A warpgroup copies `nf` features (a multiple of 8) of a 32-point tile
// in shared memory (row stride `stride`; features from `valid` on read
// as zero) to the scratch's tile at feature `off`, all 32 rows (past the
// point count the cotangents are zero): float4 q is 4 points of one
// feature, so the writes are whole runs.
__device__ __forceinline__ void tile_to_scratch(const float* tile,
                                                int stride, int valid,
                                                int nf, float* scr,
                                                int width, int off, int q0,
                                                int t) {
  float4* dst = reinterpret_cast<float4*>(
      scr + ((size_t)(q0 >> 5) * (width >> 3) + (off >> 3)) * 256);
  for (int q = t; q < nf * 8; q += 128) {
    const int f = 8 * (q >> 6) + (q & 7), p = 4 * ((q >> 3) & 7);
    const float* src = tile + p * stride + f;
    dst[q] = f < valid ? make_float4(src[0], src[stride], src[2 * stride],
                                     src[3 * stride])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The forward of a warpgroup's 64 points (from p0) in two passes of 32:
// every layer's input and output to the scratch, then rgb_pre's gradient
// and gg = relu'(g) (grgb_pre @ w_rgb^T) to the gradient scratch.
__device__ __forceinline__ void forward_simt(
    const float* __restrict__ x0, const float* __restrict__ dmb,
    const float* __restrict__ grgb, const float* __restrict__ wts,
    const float* __restrict__ bs, float* __restrict__ acts,
    float* __restrict__ grads, char* region, int p0, int n, int bar,
    int t) {
  float* xs = reinterpret_cast<float*>(region);  // kTP x kXS
  float* ds = xs + kTP * kXS;                    // kTP x kDS
  float* ha = ds + kTP * kDS;                    // kTP x kW
  float* hb = ha + kTP * kW;                     // kTP x kW
  float* gr = hb + kTP * kW;                     // kTP x 4
  const int warp = t >> 5, lane = t & 31;
  const float* w_rgb = wts + kWOffRgb;
  for (int q0 = p0; q0 < p0 + kWgPoints; q0 += kTP) {
    for (int i = t; i < kTP * kXS; i += 128) {
      const int p = i / kXS, k = i % kXS;
      xs[i] = k < kCPos && q0 + p < n
                  ? __ldg(x0 + (size_t)(q0 + p) * kCPos + k) : 0.f;
    }
    for (int i = t; i < kTP * kDS; i += 128) {
      const int p = i / kDS, k = i % kDS;
      ds[i] = k < kCDir && q0 + p < n
                  ? __ldg(dmb + (size_t)(q0 + p) * kCDir + k) : 0.f;
    }
    bar_sync(bar, 128);
    tile_to_scratch(xs, kXS, kXS, kXS, acts, kAW, kAOffX0, q0, t);
    tile_to_scratch(ds, kDS, kDS, 32, acts, kAW, kAOffDmb, q0, t);
    float acc[2][kTP];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int p = 0; p < kTP; ++p) acc[c][p] = 0.f;
    float* in = ha;
    float* out = hb;
    dense_acc<2>(acc, xs, kXS, kCPos, wts, kW, t);
    store_simt<2, true>(acc, bs, in, t);
    bar_sync(bar, 128);
    tile_to_scratch(in, kW, kW, kW, acts, kAW, act_off(0), q0, t);
    for (int l = 1; l < kD; ++l) {
      const float* w = wts + kWOff(l);
      if (l == kSkip) {
        dense_acc<2>(acc, xs, kXS, kCPos, w, kW, t);
        dense_acc<2>(acc, in, kW, kW, w + (size_t)kCPos * kW, kW, t);
      } else {
        dense_acc<2>(acc, in, kW, kW, w, kW, t);
      }
      store_simt<2, true>(acc, bs + l * kW, out, t);
      bar_sync(bar, 128);
      tile_to_scratch(out, kW, kW, kW, acts, kAW, act_off(l), q0, t);
      float* tmp = in;
      in = out;
      out = tmp;
    }
    // `in` holds a7; feat -> `out`
    dense_acc<2>(acc, in, kW, kW, wts + kWOffFin, kW, t);
    store_simt<2, false>(acc, bs + kBOffFin, out, t);
    bar_sync(bar, 128);
    tile_to_scratch(out, kW, kW, kW, acts, kAW, kAOffFeat, q0, t);
    // g = relu([feat, dmb] @ w_dir + b_dir), 128 wide -> `in`
    {
      float acc1[1][kTP];
#pragma unroll
      for (int p = 0; p < kTP; ++p) acc1[0][p] = 0.f;
      dense_acc<1>(acc1, out, kW, kW, wts + kWOffDir, kWHalf, t);
      dense_acc<1>(acc1, ds, kDS, kCDir, wts + kWOffDir + (size_t)kW * kWHalf,
                   kWHalf, t);
      store_simt<1, true>(acc1, bs + kBOffDir, in, t);
    }
    bar_sync(bar, 128);
    tile_to_scratch(in, kW, kWHalf, kWHalf, acts, kAW, kAOffG, q0, t);
    // rgb head and its pre-activation gradient: one warp per point; lanes
    // 0-7 write grgb_pre's 8 columns (3 real, 5 zero)
    for (int p = warp; p < kTP; p += 4) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int k = lane; k < kWHalf; k += 32) {
        const float g = in[p * kW + k];
        s0 = fmaf(g, __ldg(w_rgb + 3 * k), s0);
        s1 = fmaf(g, __ldg(w_rgb + 3 * k + 1), s1);
        s2 = fmaf(g, __ldg(w_rgb + 3 * k + 2), s2);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane < 8) {
        float v = 0.f;
        if (lane < 3 && q0 + p < n) {
          const float pre = (lane == 0 ? s0 : lane == 1 ? s1 : s2) +
                            __ldg(bs + kBOffRgb + lane);
          const float r = 1.f / (1.f + expf(-pre));
          v = __ldg(grgb + (size_t)(q0 + p) * 3 + lane) * r * (1.f - r);
        }
        grads[scratch_at(kGW, q0 + p, kGOffPre + lane)] = v;
        if (lane < 4) gr[p * 4 + lane] = v;
      }
    }
    bar_sync(bar, 128);
    // gg = relu'(g) (grgb_pre @ w_rgb^T): thread t owns column t -> `out`
    {
      const float w0 = __ldg(w_rgb + 3 * t), w1 = __ldg(w_rgb + 3 * t + 1);
      const float w2 = __ldg(w_rgb + 3 * t + 2);
      for (int p = 0; p < kTP; ++p) {
        const float v = gr[p * 4] * w0 + gr[p * 4 + 1] * w1 +
                        gr[p * 4 + 2] * w2;
        out[p * kW + t] = in[p * kW + t] > 0.f ? v : 0.f;
      }
    }
    bar_sync(bar, 128);
    tile_to_scratch(out, kW, kWHalf, kWHalf, grads, kGW, kGOffGG, q0, t);
    bar_sync(bar, 128);  // the next pass overwrites the tiles
  }
}

__global__ void __launch_bounds__(kTileThreads, 1)
mlp_bwd_tile_tf32_kernel(const float* __restrict__ x0,
                         const float* __restrict__ dmb,
                         const float* __restrict__ grgb,
                         const float* __restrict__ gsig,
                         const float* __restrict__ wts,
                         const char* __restrict__ wimg_bwd,
                         const float* __restrict__ bs,
                         const float* __restrict__ heads,
                         float* __restrict__ acts, float* __restrict__ grads,
                         int n_points) {
  extern __shared__ __align__(128) char smem[];
  init_ring(smem);
  Ring ring = make_ring(smem);
  const int wg = warp_uniform_div(128), t128 = threadIdx.x & 127;
  const int p0 = blockIdx.x * kBlockPoints + wg * kWgPoints;
  const int n = n_points;
  // ---- the forward, on the consumer warpgroups, in the shared memory of
  // the ring and the tiles (no copy is in flight yet)
  if (wg < 2)
    forward_simt(x0, dmb, grgb, wts, bs, acts, grads,
                 smem + wg * kSimtBytes, p0, n, 1 + wg, t128);
  __syncthreads();  // the scratch rows the block wrote are visible to it

  if (wg == 2) {  // producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads)
      produce(nullptr, wimg_bwd, kFwdChunks, kFwdChunks + kBwdChunks, smem,
              ring.full, ring.empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  char* h = smem + kSmH + wg * kTileBytes + t128 * 16;
  const TileSrc hs{h, 0};

  // ---- backward down the trunk, on the tensor cores, from gg
  {
    float gg[64];
    read_acc(grads, kGW, kGOffGG, gg, p0);
    store_tile(gg, h);
  }
  float acc[128];
  const float no_gs[2] = {0.f, 0.f};
  const uint4 all = make_uint4(~0u, ~0u, ~0u, ~0u);
  // gfeat = gg @ w_dir[:256]^T (no mask)
  mma_chunks<kWHalf / kChunkK, false, false>(acc, ring, hs);
  grad_epilogue<false>(acc, all, no_gs, nullptr);
  store_tile(acc, h);
  write_acc(grads, kGW, kGOffFeat, acc, p0);
  // gh7 = relu'(a7) (gfeat @ w_fin^T + gsigma w_sig^T)
  float gs[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = p0 + acc_row(j);
    gs[j] = p < n ? gsig[p] : 0.f;
  }
  uint4 m4 = relu_mask(acts, kD - 1, p0);
  mma_chunks<kW / kChunkK, false, false>(acc, ring, hs);
  grad_epilogue<true>(acc, m4, gs, heads + kHeadSig);
  store_tile(acc, h);
  write_acc(grads, kGW, (kD - 1) * kW, acc, p0);
  // gh_{l-1} = relu'(a_{l-1}) (gh_l @ w_l[h rows]^T)
  for (int l = kD - 1; l > 0; --l) {
    m4 = relu_mask(acts, l - 1, p0);
    mma_chunks<kW / kChunkK, false, false>(acc, ring, hs);
    grad_epilogue<false>(acc, m4, no_gs, nullptr);
    store_tile(acc, h);
    write_acc(grads, kGW, (l - 1) * kW, acc, p0);
  }
}

// ------------------------------------------------------------------ E2
struct Prod {
  int a_off;   // first activation feature of the product's input
  int m_load;  // input features staged (m_end rounded up to 64)
  int m_end;   // input features that are dW rows (or the hole)
  int hole;    // input feature that is padding inside the range, or -1
  int g_off;   // first gradient feature
  int n;       // gradient features staged (dW columns, padded to 8)
  int n_out;   // dW columns
  int w_off;   // offset of dW in the packed gradients
  int b_off;   // offset of db in the packed bias gradients
};
__constant__ Prod kProds[11] = {
    {kAOffX0, 64, kCPos, -1, 0, kW, kW, kWOff(0), 0},
    {act_off(0), kW, kW, -1, 1 * kW, kW, kW, kWOff(1), 1 * kW},
    {act_off(1), kW, kW, -1, 2 * kW, kW, kW, kWOff(2), 2 * kW},
    {act_off(2), kW, kW, -1, 3 * kW, kW, kW, kWOff(3), 3 * kW},
    {kAOffX0, 64 + kW, 64 + kW, kCPos, 4 * kW, kW, kW, kWOff(4), 4 * kW},
    {act_off(4), kW, kW, -1, 5 * kW, kW, kW, kWOff(5), 5 * kW},
    {act_off(5), kW, kW, -1, 6 * kW, kW, kW, kWOff(6), 6 * kW},
    {act_off(6), kW, kW, -1, 7 * kW, kW, kW, kWOff(7), 7 * kW},
    {act_off(7), kW, kW, -1, kGOffFeat, kW, kW, kWOffFin, kBOffFin},
    {kAOffFeat, 320, kW + kCDir, -1, kGOffGG, kWHalf, kWHalf, kWOffDir,
     kBOffDir},
    {kAOffG, kWHalf, kWHalf, -1, kGOffPre, 8, 3, kWOffRgb, kBOffRgb},
};
constexpr int kE2Tiles = 22;    // 128-row tiles over the 11 products
constexpr int kE2Threads = 256;
// A buffer: A big and small (up to 128 features x 32 points), then G big
// and small (up to 256 features x 32 points), in the scratch's order
constexpr uint32_t kE2A = 128 * kTilePoints * 4;   // 16 KB
constexpr uint32_t kE2G = 256 * kTilePoints * 4;   // 32 KB
constexpr uint32_t kE2Buf = 2 * kE2A + 2 * kE2G;
constexpr uint32_t kE2SmemBytes = 2 * kE2Buf;
static_assert(kE2SmemBytes <= 232448, "shared memory of one block");

template <int NR>
__device__ __forceinline__ void wgmma_ss(float (&acc)[NR], uint64_t da,
                                         uint64_t db) {
  if constexpr (NR == 128)
    wgmma_m64n256k8_tf32(acc, da, db, 1);
  else if constexpr (NR == 64)
    wgmma_m64n128k8_tf32(acc, da, db, 1);
  else
    wgmma_m64n8k8_tf32(acc, da, db, 1);
}

__device__ __forceinline__ void split4(const float4& v, uint4& big,
                                       uint4& small) {
  split_tf32(v.x, big.x, small.x);
  split_tf32(v.y, big.y, small.y);
  split_tf32(v.z, big.z, small.z);
  split_tf32(v.w, big.w, small.w);
}

__device__ __forceinline__ float sum4(const float4& v) {
  return (v.x + v.y) + (v.z + v.w);
}

// A thread's share of one 32-point chunk: float4 q = tid + 256 u of the A
// run (u < ua) and of the G run (u < GU, or q < 64 for N = 8). Float4 q
// holds 4 points (quad (q / 8) % 8) of feature 8 (q / 64) + q % 8.
template <int NR>
struct Chunk {
  static constexpr int GU = NR == 4 ? 1 : NR / 16;
  float4 a[4];
  float4 g[GU];
  float4 gs;  // gsigma at the thread's 4 points (final layer only)
};

template <int NR>
__device__ __forceinline__ void wgrad_tile(const Prod& pr, int mt,
                                           const float* __restrict__ acts,
                                           const float* __restrict__ grads,
                                           const float* __restrict__ gsig,
                                           float* __restrict__ part, int tb,
                                           int te, int n, char* smem) {
  using C = Chunk<NR>;
  const int tid = threadIdx.x, wg = warp_uniform_div(128);
  const int m0 = mt * 128;
  const int ua = min(128, (pr.m_load - m0 + 63) / 64 * 64) / 32;  // 2 or 4
  const bool active = m0 + wg * 64 < pr.m_load;
  const bool sums = mt == 0;                 // bias gradient columns
  const bool sig = pr.a_off == act_off(kD - 1) && pr.g_off == kGOffFeat;
  const bool g_thread = NR != 4 || tid < 64;
  const int pq = (tid >> 3) & 7;
  const size_t a_tile = (size_t)(kAW / 8) * 256;
  const size_t g_tile = (size_t)(kGW / 8) * 256;

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  float bsum[C::GU], ssum[4], gsum = 0.f;
#pragma unroll
  for (int u = 0; u < C::GU; ++u) bsum[u] = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) ssum[u] = 0.f;

  auto load = [&](int tile, C& c) {
    const float4* a = reinterpret_cast<const float4*>(
        acts + tile * a_tile + (size_t)(pr.a_off + m0) / 8 * 256);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < ua) c.a[u] = a[tid + 256 * u];
    const float4* g = reinterpret_cast<const float4*>(
        grads + tile * g_tile + (size_t)pr.g_off / 8 * 256);
#pragma unroll
    for (int u = 0; u < C::GU; ++u)
      if (g_thread) c.g[u] = g[tid + 256 * u];
    if (sig) {
      const int p = tile * kTilePoints + 4 * pq;
      c.gs = make_float4(p < n ? gsig[p] : 0.f, p + 1 < n ? gsig[p + 1] : 0.f,
                         p + 2 < n ? gsig[p + 2] : 0.f,
                         p + 3 < n ? gsig[p + 3] : 0.f);
    }
  };
  // the f32 sums, then the split images into buffer `buf`
  auto stage = [&](const C& c, char* buf) {
    if (sums && g_thread)
#pragma unroll
      for (int u = 0; u < C::GU; ++u) bsum[u] += sum4(c.g[u]);
    if (sig) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < ua)
          ssum[u] += (c.a[u].x * c.gs.x + c.a[u].y * c.gs.y) +
                     (c.a[u].z * c.gs.z + c.a[u].w * c.gs.w);
      if (sums && (tid & 7) == 0 && tid < 64) gsum += sum4(c.gs);
    }
    uint4 big, small;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < ua) {
        split4(c.a[u], big, small);
        reinterpret_cast<uint4*>(buf)[tid + 256 * u] = big;
        reinterpret_cast<uint4*>(buf + kE2A)[tid + 256 * u] = small;
      }
#pragma unroll
    for (int u = 0; u < C::GU; ++u)
      if (g_thread) {
        split4(c.g[u], big, small);
        reinterpret_cast<uint4*>(buf + 2 * kE2A)[tid + 256 * u] = big;
        reinterpret_cast<uint4*>(buf + 2 * kE2A + kE2G)[tid + 256 * u] =
            small;
      }
  };

  C c;
  if (tb < te) {
    load(tb, c);
    stage(c, smem);
  }
  fence_proxy_async();
  __syncthreads();
  for (int t = tb; t < te; ++t) {
    char* buf = smem + ((t - tb) & 1) * kE2Buf;
    if (active) {
      const uint32_t a = smem_u32(buf) + wg * 8 * 1024;
      const uint32_t g = smem_u32(buf + 2 * kE2A);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTilePoints / 8; ++k) {
        // 8 features x 32 points: core matrices 128 bytes apart along
        // the points, 1 KB along the features
        const uint64_t dab = make_desc(a + k * 256, 128, 1024);
        const uint64_t das = make_desc(a + kE2A + k * 256, 128, 1024);
        const uint64_t dgb = make_desc(g + k * 256, 128, 1024);
        const uint64_t dgs = make_desc(g + kE2G + k * 256, 128, 1024);
        wgmma_ss(acc, das, dgb);
        wgmma_ss(acc, dab, dgs);
        wgmma_ss(acc, dab, dgb);
      }
      wgmma_commit();
    }
    // the next chunk: loaded while the tensor cores work, staged into the
    // other buffer (its wgmmas ended before the last barrier)
    if (t + 1 < te) {
      load(t + 1, c);
      stage(c, smem + ((t + 1 - tb) & 1) * kE2Buf);
    }
    fence_proxy_async();
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
        const int m = m0 + wg * 64 + acc_row(j);
        if (m >= pr.m_end || m == pr.hole) continue;
        const int row = (pr.hole >= 0 && m > pr.hole) ? m - 1 : m;
        float* o = part + pr.w_off + (size_t)row * pr.n_out + col;
        if (col < pr.n_out) o[0] = acc[4 * i + 2 * j];
        if (col + 1 < pr.n_out) o[1] = acc[4 * i + 2 * j + 1];
      }
    }
  }
  // the sums over the 8 point quads, in quad order (buffer 0 is free:
  // the loop ended on a barrier)
  float* red = reinterpret_cast<float*>(smem);   // [feature][quad]
  const int f_in = 8 * (tid >> 6) + (tid & 7);   // + 32 u
  if (sums && g_thread)
#pragma unroll
    for (int u = 0; u < C::GU; ++u) red[(f_in + 32 * u) * 8 + pq] = bsum[u];
  float* red_s = red + 256 * 8;                  // [feature][quad]
  if (sig)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < ua) red_s[(f_in + 32 * u) * 8 + pq] = ssum[u];
  float* red_g = red_s + 128 * 8;                // [quad]
  if (sig && sums && (tid & 7) == 0 && tid < 64) red_g[pq] = gsum;
  __syncthreads();
  if (sums && tid < pr.n_out) {
    float s = 0.f;
    for (int q = 0; q < 8; ++q) s += red[tid * 8 + q];
    part[kNWeights + pr.b_off + tid] = s;
  }
  if (sig && tid < 128) {
    float s = 0.f;
    for (int q = 0; q < 8; ++q) s += red_s[tid * 8 + q];
    part[kWOffSig + m0 + tid] = s;
  }
  if (sig && sums && tid == 0) {
    float s = 0.f;
    for (int q = 0; q < 8; ++q) s += red_g[q];
    part[kNWeights + kBOffSig] = s;
  }
}

__global__ void __launch_bounds__(kE2Threads, 1)
mlp_bwd_wgrad_tf32_kernel(const float* __restrict__ acts,
                          const float* __restrict__ grads,
                          const float* __restrict__ gsig,
                          float* __restrict__ partial, int n_points) {
  extern __shared__ __align__(128) char smem[];
  const int split = blockIdx.y;
  // whole 32-point tiles per split
  const int tiles = (n_points + kTilePoints - 1) / kTilePoints;
  const int per = (tiles + kSplits - 1) / kSplits;
  const int tb = min(tiles, split * per);
  const int te = min(tiles, tb + per);
  int t = blockIdx.x, prod = 0;
  for (; prod < 11; ++prod) {
    const int m_tiles = (kProds[prod].m_load + 127) / 128;
    if (t < m_tiles) break;
    t -= m_tiles;
  }
  const Prod pr = kProds[prod];
  float* part = partial + (size_t)split * kTotal;
  if (pr.n == kW)
    wgrad_tile<128>(pr, t, acts, grads, gsig, part, tb, te, n_points, smem);
  else if (pr.n == kWHalf)
    wgrad_tile<64>(pr, t, acts, grads, gsig, part, tb, te, n_points, smem);
  else
    wgrad_tile<4>(pr, t, acts, grads, gsig, part, tb, te, n_points, smem);
}

int set_smem(bool& done) {
  // once in this process (the port runs on one card), so a CUDA graph
  // capture after the first call never meets it
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_tile_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTileSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlp_bwd_wgrad_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kE2SmemBytes);
  if (err == cudaSuccess) done = true;
  return (int)err;
}

}  // namespace

// x0 (P, 63), dmb (P, 27), grgb (P, 3), gsig (P) f32; w: every kernel
// (in, out) row-major back to back, f32; wimg_bwd: the backward weight
// image (f32 big and small chunks); b: packed f32 biases; heads: f32 sigma
// and rgb head weights. Scratch, for R = P rounded up to 128 rows: acts
// (R, 2528) and grads (R, 2440) f32 in 32-point tiles, partial (16,
// 595844) f32. out (595844) f32: the packed weight gradients, then the
// bias gradients.
NERFSR_API int nerfsr_fused_mlp_bwd_tf32(const void* x0, const void* dmb,
                                         const void* grgb, const void* gsig,
                                         const void* w, const void* wimg_bwd,
                                         const void* b, const void* heads,
                                         void* acts, void* grads,
                                         void* partial, void* out,
                                         int n_points, void* stream) {
  auto st = (cudaStream_t)stream;
  if (n_points <= 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * kTotal, st);
  static bool smem_set = false;
  int err = set_smem(smem_set);
  if (err) return err;
  mlp_bwd_tile_tf32_kernel<<<(n_points + kBlockPoints - 1) / kBlockPoints,
                             kTileThreads, kTileSmemBytes, st>>>(
      (const float*)x0, (const float*)dmb, (const float*)grgb,
      (const float*)gsig, (const float*)w, (const char*)wimg_bwd,
      (const float*)b, (const float*)heads, (float*)acts, (float*)grads,
      n_points);
  err = (int)cudaGetLastError();
  if (err) return err;
  mlp_bwd_wgrad_tf32_kernel<<<dim3(kE2Tiles, kSplits), kE2Threads,
                              kE2SmemBytes, st>>>(
      (const float*)acts, (const float*)grads, (const float*)gsig,
      (float*)partial, n_points);
  err = (int)cudaGetLastError();
  if (err) return err;
  mlp_bwd_reduce_tf32_kernel
      <<<(kTotal + 255) / 256, 256, 0, st>>>((const float*)partial,
                                             (float*)out);
  return (int)cudaGetLastError();
}

// The scratch shapes the wrapper allocates.
NERFSR_API int nerfsr_fused_mlp_bwd_tf32_layout(int* act_width,
                                                int* grad_width, int* splits,
                                                int* total) {
  *act_width = kAW;
  *grad_width = kGW;
  *splits = kSplits;
  *total = kTotal;
  return 0;
}
