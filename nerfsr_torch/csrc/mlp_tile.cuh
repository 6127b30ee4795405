// What kernels C and E share on both routes (mlp_tc.cuh in bf16,
// mlp_tf32.cuh in f32): the architecture's constants, the offsets of
// every layer in the packed weights and biases, and E's last pass.
#pragma once

#include "common.cuh"

namespace nerfsr_mlp {

constexpr int kD = 8;
constexpr int kW = 256;
constexpr int kSkip = 4;
constexpr int kCPos = 63;
constexpr int kCDir = 27;
constexpr int kWHalf = kW / 2;

using nerfsr::round_bf16;

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

// Kernel E's last pass, one thread per output: out[i] = the sum of the
// `splits` partial gradient buffers (kTotal floats each), in split order
constexpr int kTotal = kNWeights + kNBiases;
__device__ __forceinline__ void reduce_splits(const float* __restrict__ partial,
                                              float* __restrict__ out,
                                              int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTotal) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * kTotal + i];
  out[i] = s;
}

}  // namespace nerfsr_mlp
