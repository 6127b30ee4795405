// The 128-point tensor-core tile shared by kernel C's bf16 path
// (fused_mlp_tc.cu) and kernel E's bf16 tile pass (fused_mlp_bwd_tc.cu):
// the weight-image schedule, the shared-memory plan, the producer that
// streams weight chunks through a ring, and the consumer's products and
// epilogues.
//
// A block owns 128 points: two consumer warpgroups of 64 points each and
// one producer warpgroup (one thread of it issues the copies). Every
// product is D (64 x N) = A (64 x K) B (K x N) on
// wgmma m64nNk16 (N = 256 for the trunk, 128 for the direction layer),
// with A, the warpgroup's bf16 activation tile, and B, a weight chunk, both
// in shared memory (non-swizzled, K-major: see wgmma.cuh).
//
// Weights. The wrapper packs each layer's weights once into the exact
// shared-memory image of its chunks (kernels/mlp.py, pack_tc): a
// chunk is 64 (or, for the direction layer's dmb rows, 32) reduction rows
// of B, zero-padded, in core-matrix order. The producer copies each chunk
// with one cp.async.bulk into the next ring stage, completing on that
// stage's `full` mbarrier; the eight consumer warps release a stage on its
// `empty` mbarrier once their wgmmas have read it. Both warpgroups consume
// every chunk, so each block reads the 1.19 MB image once from L2 for 128
// points.
//
// Activations stay in shared memory as bf16 (exact in mixed precision):
// each warpgroup's 64 x 256 tile is overwritten by the layer's output in
// the epilogue (f32 bias, ReLU, round to bf16), after wgmma.wait_group 0 and
// a warpgroup barrier, then fence.proxy.async and a second barrier before
// the next layer's wgmma reads it. A warpgroup reads only its own rows, so
// the two warpgroups never wait for each other.
#pragma once

#include "mlp_tile.cuh"
#include "wgmma.cuh"

namespace nerfsr_tc {

using nerfsr::round_bf16;
using nerfsr_mlp::kCDir;
using nerfsr_mlp::kCPos;
using nerfsr_mlp::kD;
using nerfsr_mlp::kSkip;
using nerfsr_mlp::kW;
using nerfsr_mlp::kWHalf;

constexpr int kBlockPoints = 128;
constexpr int kWgPoints = 64;
constexpr int kConsumerThreads = 256;
constexpr int kTileThreads = kConsumerThreads + 128;  // + the producer
// Registers per thread after setmaxnreg: 168 at launch (384 threads), the
// producer warpgroup gives 128 of each thread's back and the consumers
// take 64 more, for wgmma's 128 accumulators and the epilogues
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStages = 3;
constexpr int kChunkK = 64;                          // reduction rows a chunk
constexpr uint32_t kChunkBytes = kChunkK * kW * 2;   // 32 KB (N = 256)
constexpr int kX0K = 64;                             // x0 63 -> 64
constexpr int kDmbK = 32;                            // dmb 27 -> 32

// Forward image, in consumption order: layer 0 (1 chunk), layers 1-3
// (4 each), layer 4 (x0 rows: 1, h rows: 4), layers 5-7 (4 each), final
// (4), direction layer (feat rows: 4 of N = 128, dmb rows: 1 of K = 32).
constexpr int kFwdChunks = 39;
constexpr int kDirChunk0 = 34;
__host__ __device__ constexpr uint32_t fwd_chunk_bytes(int c) {
  return c < kDirChunk0 ? kChunkBytes
         : c < kFwdChunks - 1 ? kChunkBytes / 2
                               : kChunkBytes / 4;
}
__host__ __device__ constexpr uint32_t fwd_chunk_off(int c) {
  return c <= kDirChunk0 ? c * kChunkBytes
                         : kDirChunk0 * kChunkBytes + (c - kDirChunk0) *
                                                          (kChunkBytes / 2);
}
constexpr uint32_t kFwdImageBytes =
    fwd_chunk_off(kFwdChunks - 1) + fwd_chunk_bytes(kFwdChunks - 1);
// Backward image (B = W, reduction over the layer's outputs), in
// consumption order: direction layer's feat rows (2 chunks), final (4),
// layers 7..1's h rows (4 each); every chunk N = 256.
constexpr int kBwdChunks = 34;
constexpr uint32_t kBwdImageBytes = kBwdChunks * kChunkBytes;
static_assert(kFwdImageBytes == 1187840, "forward image of kernels/mlp.py");

// f32 head weights (bf16-rounded in mixed precision): sigma (256), then
// rgb (128 x 3, row-major)
constexpr int kHeadSig = 0;
constexpr int kHeadRgb = kW;
constexpr int kHeadFloats = kW + kWHalf * 3;

// Shared memory, bytes
constexpr uint32_t kSmRing = 0;
constexpr uint32_t kSmH = kSmRing + kStages * kChunkBytes;         // 2 x 32 KB
constexpr uint32_t kSmX0 = kSmH + 2 * kWgPoints * kW * 2;         // 2 x 8 KB
constexpr uint32_t kSmDmb = kSmX0 + 2 * kWgPoints * kX0K * 2;     // 2 x 4 KB
constexpr uint32_t kSmBar = kSmDmb + 2 * kWgPoints * kDmbK * 2;
constexpr uint32_t kTileSmemBytes = kSmBar + 2 * kStages * 8;
static_assert(kTileSmemBytes <= 232448, "shared memory of one block");

// ---------------------------------------------------------------- producer
// One thread streams `n_chunks` chunks (the forward image, then the
// backward image) through the ring.
__device__ __forceinline__ void produce(const char* fwd, const char* bwd,
                                        int n_chunks, char* smem,
                                        uint64_t* full, uint64_t* empty) {
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    if (c >= kStages) mbar_wait(&empty[s], ((c / kStages) - 1) & 1);
    const char* src;
    uint32_t bytes;
    if (c < kFwdChunks) {
      src = fwd + fwd_chunk_off(c);
      bytes = fwd_chunk_bytes(c);
    } else {
      src = bwd + (size_t)(c - kFwdChunks) * kChunkBytes;
      bytes = kChunkBytes;
    }
    mbar_expect_tx(&full[s], bytes);
    bulk_g2s(smem + kSmRing + s * kChunkBytes, src, bytes, &full[s]);
  }
}

// ---------------------------------------------------------------- consumer
struct Ring {
  uint32_t base;    // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  int c;            // chunks consumed so far
};

// acc (+)= A (64 x NCH * KC) B over the next NCH ring chunks, each KC
// reduction rows by 2 * NR columns. A is K-major at shared address `a`
// with `a_mn` bytes between 8-row groups. Without kAcc the first product
// overwrites acc. Straight-line code: wgmma is serialized by the compiler
// around divergent branches.
template <int NCH, int KC, bool kAcc, int NR>
__device__ __forceinline__ void mma_chunks(float (&acc)[NR], Ring& ring,
                                           uint32_t a, uint32_t a_mn) {
  const bool leader = (threadIdx.x & 31) == 0;
  constexpr uint32_t b_mn = KC / 8 * 128;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int s = (ring.c + j) % kStages;
    mbar_wait(&ring.full[s], ((ring.c + j) / kStages) & 1);
    const uint32_t b = ring.base + s * kChunkBytes;
#pragma unroll
    for (int t = 0; t < KC / 16; ++t) {
      const uint64_t da = make_desc(a + (j * (KC / 16) + t) * 256, 128, a_mn);
      const uint64_t db = make_desc(b + t * 256, 128, b_mn);
      const int scale = (kAcc || j > 0 || t > 0) ? 1 : 0;
      if constexpr (NR == 128)
        wgmma_m64n256k16<0, 0>(acc, da, db, scale);
      else
        wgmma_m64n128k16<0, 0>(acc, da, db, scale);
    }
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
      mbar_arrive(&ring.empty[(ring.c + j - 1) % kStages], leader);
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);
  mbar_arrive(&ring.empty[(ring.c + NCH - 1) % kStages], leader);
  ring.c += NCH;
}

// Trunk layer l's product: x0 (layers 0 and 4) and h (layers 1-7).
__device__ __forceinline__ void trunk_product(float (&acc)[128], Ring& ring,
                                              int l, uint32_t xa,
                                              uint32_t ha) {
  if (l == 0) {
    mma_chunks<1, kChunkK, false>(acc, ring, xa, kX0K * 16);
  } else if (l == kSkip) {
    mma_chunks<1, kChunkK, false>(acc, ring, xa, kX0K * 16);
    mma_chunks<4, kChunkK, true>(acc, ring, ha, kW * 16);
  } else {
    mma_chunks<4, kChunkK, false>(acc, ring, ha, kW * 16);
  }
}

// byte offset of element (row, col) in a K-major tile of `k` columns
__device__ __forceinline__ uint32_t tile_off(int row, int col, int k) {
  return (row >> 3) * (k * 16) + (col >> 3) * 128 + (row & 7) * 16 +
         (col & 7) * 2;
}

__device__ __forceinline__ void st_pair(char* tile, int row, int col, int k,
                                        float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + tile_off(row, col, k)) =
      __floats2bfloat162_rn(v0, v1);
}

// Load `k` columns of `cols` valid f32 inputs per point (rows >= n and
// columns >= cols are zero) into a K-major bf16 tile.
__device__ __forceinline__ void load_input(char* tile, const float* src,
                                           int cols, int k, int p0, int n,
                                           int t128) {
  for (int i = t128; i < kWgPoints * k / 2; i += 128) {
    const int row = i / (k / 2), col = 2 * (i % (k / 2));
    const bool ok = p0 + row < n;
    const float* s = src + (size_t)(p0 + row) * cols;
    const float v0 = ok && col < cols ? s[col] : 0.f;
    const float v1 = ok && col + 1 < cols ? s[col + 1] : 0.f;
    st_pair(tile, row, col, k, v0, v1);
  }
}

// Epilogue of a trunk-width (or direction-width) product: v = acc + bias,
// ReLU if kRelu, rounded to bf16, into the tile (k = 2 * NR columns).
template <int NR, bool kRelu>
__device__ __forceinline__ void epilogue(float (&acc)[NR],
                                         const float* __restrict__ bias,
                                         char* tile) {
#pragma unroll
  for (int i = 0; i < NR / 4; ++i) {
    const int col = acc_col(i);
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v0 = acc[4 * i + 2 * j] + b0, v1 = acc[4 * i + 2 * j + 1] + b1;
      if (kRelu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      v0 = round_bf16(v0);
      v1 = round_bf16(v1);
      acc[4 * i + 2 * j] = v0;
      acc[4 * i + 2 * j + 1] = v1;
      st_pair(tile, acc_row(j), col, 2 * NR, v0, v1);
    }
  }
}

// sum over the 4 lanes that share an accumulator row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The sigma head on the rounded last trunk activation held in acc:
// s[j] = sum_col h[row_j][col] * w_sig[col], summed over the row's lanes.
__device__ __forceinline__ void sigma_head(const float (&acc)[128],
                                           const float* __restrict__ w_sig,
                                           float (&s)[2]) {
  s[0] = s[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = acc_col(i);
    const float w0 = __ldg(w_sig + col), w1 = __ldg(w_sig + col + 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      s[j] = fmaf(acc[4 * i + 2 * j + 1], w1,
                  fmaf(acc[4 * i + 2 * j], w0, s[j]));
  }
  s[0] = quad_sum(s[0]);
  s[1] = quad_sum(s[1]);
}

// The rgb head's pre-activation on the rounded direction output g held
// in acc (128 wide): pre[j][o] = sum_col g[row_j][col] * w_rgb[col][o].
__device__ __forceinline__ void rgb_head(const float (&acc)[64],
                                         const float* __restrict__ w_rgb,
                                         float (&pre)[2][3]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int o = 0; o < 3; ++o) pre[j][o] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = acc_col(i);
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const float w = __ldg(w_rgb + 3 * (col + c) + o);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          pre[j][o] = fmaf(acc[4 * i + 2 * j + c], w, pre[j][o]);
      }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int o = 0; o < 3; ++o) pre[j][o] = quad_sum(pre[j][o]);
}

// Copy a warpgroup's K-major tile (64 rows, k columns) to rows p0.. of a
// point-major bf16 scratch (row stride `ld`, column offset `off`), rows
// < n only. A quarter-warp reads one 128-byte core matrix; a warp writes
// 64 contiguous bytes of each of 8 rows.
__device__ __forceinline__ void copy_out(const char* tile, int k,
                                         __nv_bfloat16* dst, int ld, int off,
                                         int p0, int n, int t128) {
  const int groups = k / 8;
  for (int i = t128; i < kWgPoints * groups; i += 128) {
    const int r = i & 7, g = (i >> 3) % groups, rb = (i >> 3) / groups;
    const int row = rb * 8 + r;
    if (p0 + row < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(p0 + row) * ld + off + 8 * g) =
          *reinterpret_cast<const uint4*>(tile + rb * (k * 16) + g * 128 +
                                          r * 16);
  }
}

}  // namespace nerfsr_tc
