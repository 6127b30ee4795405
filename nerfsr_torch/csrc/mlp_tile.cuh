// The 32-point tile machinery shared by kernel C (fused_mlp.cu) and
// kernel E (fused_mlp_bwd.cu): the architecture's constants, the tile
// shape and the dense product that both the forward and the backward
// products run on.
#pragma once

#include "common.cuh"

namespace nerfsr_mlp {

constexpr int kD = 8;
constexpr int kW = 256;
constexpr int kSkip = 4;
constexpr int kCPos = 63;
constexpr int kCDir = 27;
constexpr int kWHalf = kW / 2;

constexpr int kTP = 32;          // points per block
constexpr int kThreads = 128;    // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kXS = 64;          // x0 row stride in shared memory (63 + 0 pad)
constexpr int kDS = 28;          // dmb row stride (27 + 0 pad)
constexpr size_t kSmemBytes =
    sizeof(float) * (size_t)kTP * (kXS + kDS + 2 * kW);

static_assert(kW == 2 * kThreads, "each thread owns two trunk columns");
static_assert(kWHalf == kThreads, "each thread owns one direction column");
static_assert(kXS % 4 == 0 && kDS % 4 == 0 && kW % 4 == 0,
              "float4 rows need strides that are multiples of 4");

using nerfsr::round_bf16;
using nerfsr::to_float;

// offsets of each layer in the packed (in, out) weights and the packed
// biases, PARAM_NAMES order (xyz_encoding_1..8, final, sigma, dir, rgb)
__host__ __device__ constexpr int kInDim(int l) {
  return l == 0 ? kCPos : l == kSkip ? kCPos + kW : kW;
}
// trunk layer l (0..7), or 8 = final
__host__ __device__ constexpr int kWOff(int l) {
  return l == 0 ? 0 : kWOff(l - 1) + kInDim(l - 1) * kW;
}
constexpr int kWOffFin = kWOff(kD);
constexpr int kWOffSig = kWOffFin + kW * kW;
constexpr int kWOffDir = kWOffSig + kW;
constexpr int kWOffRgb = kWOffDir + (kW + kCDir) * kWHalf;
constexpr int kNWeights = kWOffRgb + kWHalf * 3;
constexpr int kBOffFin = kD * kW;
constexpr int kBOffSig = kBOffFin + kW;
constexpr int kBOffDir = kBOffSig + 1;
constexpr int kBOffRgb = kBOffDir + kWHalf;
constexpr int kNBiases = kBOffRgb + 3;
static_assert(kNWeights == 593408 && kNBiases == 2436,
              "packed layout of nerfsr_torch/kernels/mlp.py");

// acc[c][p] += sum_{k < K} in[p * stride + k] * w[k * ldw + tid + c * 128].
// Rows of `in` are zero-padded up to a multiple of 4 in shared memory.
template <int NC, typename WT>
__device__ __forceinline__ void dense_acc(float (&acc)[NC][kTP],
                                          const float* __restrict__ in,
                                          int stride, int K,
                                          const WT* __restrict__ w, int ldw) {
  const int tid = threadIdx.x;
  float wn[4][NC];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wn[kk][c] = kk < K ? to_float(w[(size_t)kk * ldw + tid + c * kThreads])
                         : 0.f;
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
          wn[kk][c] =
              k + 4 + kk < K
                  ? to_float(w[(size_t)(k + 4 + kk) * ldw + tid + c * kThreads])
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

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC][kTP]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int p = 0; p < kTP; ++p) acc[c][p] = 0.f;
}

}  // namespace nerfsr_mlp
