// The 128-point f32 tile shared by kernel C's f32 route (fused_mlp_tf32.cu)
// and kernel E's f32 tile pass (fused_mlp_bwd_tf32.cu): f32-accurate
// products on the tensor cores as 3xTF32 (wgmma.cuh), the weight-image
// schedule, the shared-memory plan, the producer that streams weight
// chunks through a ring, and the consumer's products and epilogues.
//
// A block owns 128 points: two consumer warpgroups of 64 points each and
// one producer warpgroup (one thread of it issues the copies). Every
// product is D (64 x N) = A (64 x K) B (K x N) on wgmma m64nNk8 tf32 (N =
// 256 for the trunk, 128 for the direction layer), three times a k8 slice:
// small(A) big(B), big(A) small(B), big(A) big(B), the small terms first.
//
// A from registers. A warpgroup's activations never leave its threads:
// each layer's output, in the accumulator, is the next layer's A fragment
// as it stands (wgmma.cuh: tf32_frag_acc, with B's reduction rows packed
// in kTf32KOrder). The fragments wait in shared memory between layers,
// since an input (128 f32 a thread) and an output accumulator (128) do
// not fit in one thread's registers together: each thread keeps its own
// 128 values there, one 16-byte vector per k8 slice, [slice][thread], and
// reads back only what it wrote. No barrier and no proxy fence guard that
// tile: wgmma never reads it. Each value is split into big and small in
// registers just before its wgmmas. x0 and dmb go to fragments straight
// from global memory (zero past the point count and past 63 / 27
// columns).
//
// Weights. The wrapper packs each layer's f32 weights once into the
// shared-memory image of their chunks (kernels/mlp.py, pack_tf32): a
// chunk is 16 reduction rows of B (K-major core matrices, rows in
// kTf32KOrder within each 8), its big image, then its small image. The
// producer copies each chunk with one cp.async.bulk into the next of 3
// ring stages, completing on that stage's `full` mbarrier; the eight
// consumer warps release a stage on its `empty` mbarrier once their
// wgmmas have read it. Both warpgroups consume every chunk, so each block
// reads the 4.75 MB image once from L2 for 128 points.
//
// Sums: in kernel C each chunk's products run into a fresh 128-column
// accumulator that f32 adds (round to nearest) to the layer's
// (mma_chunks): the tensor cores truncate as they sum, and a whole layer
// in one accumulator drifted far enough to move the f32 training loss
// past its bar.
//
// Shared memory: the ring, 3 x 32 KB (a chunk of 16 rows x 256, big and
// small), and the two warpgroups' fragment tiles, 2 x 64 KB: 229,424
// bytes of the 232,448 a block may use. Registers: 232 a consumer thread
// (the layer's 128 accumulators, a chunk's 64 in C, split fragments).
#pragma once

#include "mlp_tile.cuh"
#include "wgmma.cuh"

namespace nerfsr_tf32 {

using namespace nerfsr_tc;
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
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStages = 3;
constexpr int kChunkK = 16;                            // reduction rows
constexpr uint32_t kChunkBytes = 2 * kChunkK * kW * 4;  // big + small, 32 KB
constexpr uint32_t kChunkMn = kChunkK / 4 * 128;        // between 8-row groups
constexpr int kX0Slices = 8;                            // x0 63 -> 64
constexpr int kDmbSlices = 4;                           // dmb 27 -> 32

// Forward image, in consumption order: layer 0 (x0 rows: 4 chunks),
// layers 1-3 (16 each), layer 4 (x0 rows: 4, h rows: 16), layers 5-7
// (16 each), final (16), direction layer (feat rows: 16 of N = 128, dmb
// rows: 2 of N = 128).
constexpr int kFwdChunks = 154;
constexpr int kDirChunk0 = 136;
__host__ __device__ constexpr uint32_t fwd_chunk_bytes(int c) {
  return c < kDirChunk0 ? kChunkBytes : kChunkBytes / 2;
}
__host__ __device__ constexpr uint32_t fwd_chunk_off(int c) {
  return c <= kDirChunk0 ? c * kChunkBytes
                         : kDirChunk0 * kChunkBytes + (c - kDirChunk0) *
                                                          (kChunkBytes / 2);
}
constexpr uint32_t kFwdImageBytes =
    fwd_chunk_off(kFwdChunks - 1) + fwd_chunk_bytes(kFwdChunks - 1);
// Backward image (B = W, reduction over the layer's outputs), in
// consumption order: the direction layer's feat rows (8 chunks), final
// (16), layers 7..1's h rows (16 each); every chunk N = 256.
constexpr int kBwdChunks = 136;
constexpr uint32_t kBwdImageBytes = kBwdChunks * kChunkBytes;
static_assert(kFwdImageBytes == 4751360, "forward image of kernels/mlp.py");

// f32 head weights: sigma (256), then rgb (128 x 3, row-major)
constexpr int kHeadSig = 0;
constexpr int kHeadRgb = kW;
constexpr int kHeadFloats = kW + kWHalf * 3;

// Shared memory, bytes
constexpr uint32_t kSmRing = 0;
constexpr uint32_t kTileBytes = kWgPoints * kW * 4;   // a warpgroup's 64 KB
constexpr uint32_t kSmH = kSmRing + kStages * kChunkBytes;
constexpr uint32_t kSmBar = kSmH + 2 * kTileBytes;
constexpr uint32_t kTileSmemBytes = kSmBar + 2 * kStages * 8;
static_assert(kTileSmemBytes <= 232448, "shared memory of one block");

// ---------------------------------------------------------------- producer
// One thread streams chunks `first` .. `end` - 1 of the forward image
// followed by the backward image (kFwdChunks + kBwdChunks in all) through
// the ring.
__device__ __forceinline__ void produce(const char* fwd, const char* bwd,
                                        int first, int end, char* smem,
                                        uint64_t* full, uint64_t* empty) {
  for (int c = first; c < end; ++c) {
    const int i = c - first, s = i % kStages;
    if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
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

// the block's barriers, set up by thread 0 before the warpgroups split
__device__ __forceinline__ void init_ring(char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmBar);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[kStages + s], kConsumerThreads / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------- consumer
struct Ring {
  uint32_t base;    // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  int c;            // chunks consumed so far
};

__device__ __forceinline__ Ring make_ring(char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmBar);
  return Ring{smem_u32(smem + kSmRing), full, full + kStages, 0};
}

// A fragments from this thread's slot of its warpgroup's tile: slice k
// of the stored activation, the 4 values of tf32_frag_acc's order
struct TileSrc {
  const char* h;    // the tile + 16 * (thread in the warpgroup)
  int k0;           // first slice
  __device__ __forceinline__ void operator()(int k, float (&v)[4]) const {
    const float4 q =
        *reinterpret_cast<const float4*>(h + (size_t)(k0 + k) * 2048);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

// A fragments held in registers (x0, dmb): slice k of f
template <int S>
struct RegSrc {
  const float (&f)[S][4];
  __device__ __forceinline__ void operator()(int k, float (&v)[4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = f[k][r];
  }
};

// The fragments of S slices of a row-major (P, cols) f32 input: column
// 8 k + tf32_frag_col(r) of row p0 + tf32_frag_row(r), zero past n rows
// and past `cols` columns.
template <int S>
__device__ __forceinline__ void load_frags(float (&f)[S][4],
                                           const float* __restrict__ src,
                                           int cols, int p0, int n) {
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + tf32_frag_row(r), col = 8 * k + tf32_frag_col(r);
      f[k][r] = p < n && col < cols ? __ldg(src + (size_t)p * cols + col)
                                    : 0.f;
    }
}

template <int NR>
__device__ __forceinline__ void wgmma_rs(float (&acc)[NR],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale) {
  if constexpr (NR == 128)
    wgmma_m64n256k8_tf32_rs(acc, a, db, scale);
  else
    wgmma_m64n128k8_tf32_rs(acc, a, db, scale);
}

// acc (+)= A (64 x NCH * 16) B over the next NCH ring chunks of 16
// reduction rows by 2 * NR columns, as 3xTF32; `src` gives A's k8 slices
// (0 .. 2 NCH - 1). Without kAcc, acc starts from zero. Each chunk's
// fragments are loaded and split before its stage is waited for.
//
// The tensor cores sum a wgmma's products into its accumulator
// truncating, so a layer's 96 products summed in one accumulator drift
// toward zero by several ulp. With kPromote (kernel C, whose outputs the
// loss reads), each chunk's 6 products (two k8 slices, three terms) run
// into a fresh accumulator of 128 columns instead, which is then added to
// acc in f32, rounding to nearest: for N = 256, two halves a chunk, each
// waited for. Without it (E's input gradients, which stay far inside
// their bar) the chunks pipeline into acc, one wgmma group in flight
// while the next is issued. Straight-line code: wgmma is serialized by
// the compiler around divergent branches.
template <int NCH, bool kAcc, bool kPromote, int NR, typename Src>
__device__ __forceinline__ void mma_chunks(float (&acc)[NR], Ring& ring,
                                           const Src& src) {
  const bool leader = (threadIdx.x & 31) == 0;
  constexpr uint32_t small_off = NR * 2 * kChunkK * 4;  // the big image's
  constexpr uint32_t half_off = 16 * kChunkMn;  // 128 columns' core matrices
  if (kPromote && !kAcc) {
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    uint32_t big[2][4], small[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float v[4];
      src(2 * j + t, v);
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(v[r], big[t][r], small[t][r]);
    }
    const int s = (ring.c + j) % kStages;
    mbar_wait(&ring.full[s], ((ring.c + j) / kStages) & 1);
    const uint32_t b = ring.base + s * kChunkBytes;
    if constexpr (kPromote) {
#pragma unroll
      for (int hf = 0; hf < NR / 64; ++hf) {
        float part[64];
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t o = hf * half_off + t * 256;
          const uint64_t db = make_desc(b + o, 128, kChunkMn);
          const uint64_t ds = make_desc(b + small_off + o, 128, kChunkMn);
          wgmma_m64n128k8_tf32_rs(part, small[t], db, t > 0 ? 1 : 0);
          wgmma_m64n128k8_tf32_rs(part, big[t], ds, 1);
          wgmma_m64n128k8_tf32_rs(part, big[t], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[64 * hf + i] += part[i];
      }
      mbar_arrive(&ring.empty[s], leader);
    } else {
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint64_t db = make_desc(b + t * 256, 128, kChunkMn);
        const uint64_t ds = make_desc(b + small_off + t * 256, 128, kChunkMn);
        wgmma_rs(acc, small[t], db, (kAcc || j > 0 || t > 0) ? 1 : 0);
        wgmma_rs(acc, big[t], ds, 1);
        wgmma_rs(acc, big[t], db, 1);
      }
      wgmma_commit();
      if (j > 0) {
        wgmma_wait<1>();
        mbar_arrive(&ring.empty[(ring.c + j - 1) % kStages], leader);
      }
    }
  }
  if constexpr (!kPromote) {
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(&ring.empty[(ring.c + NCH - 1) % kStages], leader);
  }
  ring.c += NCH;
}

// Trunk layer l's product: x0 (layers 0 and 4, fragments loaded here
// from global memory) and h (layers 1-7, the tile).
__device__ __forceinline__ void trunk_product(float (&acc)[128], Ring& ring,
                                              int l,
                                              const float* __restrict__ x0,
                                              int p0, int n, const char* h) {
  if (l == 0 || l == kSkip) {
    float xf[kX0Slices][4];
    load_frags(xf, x0, kCPos, p0, n);
    mma_chunks<kX0Slices / 2, false, true>(acc, ring,
                                           RegSrc<kX0Slices>{xf});
  }
  if (l == kSkip)
    mma_chunks<kW / kChunkK, true, true>(acc, ring, TileSrc{h, 0});
  else if (l > 0)
    mma_chunks<kW / kChunkK, false, true>(acc, ring, TileSrc{h, 0});
}

// v = acc + bias (ReLU if kRelu), in place, over NR accumulators (2 NR
// columns)
template <int NR, bool kRelu>
__device__ __forceinline__ void bias_act(float (&acc)[NR],
                                         const float* __restrict__ bias) {
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
      acc[4 * i + 2 * j] = v0;
      acc[4 * i + 2 * j + 1] = v1;
    }
  }
}

// the thread's slot of the tile <- acc as the next product's fragments
template <int NR>
__device__ __forceinline__ void store_tile(const float (&acc)[NR], char* h) {
#pragma unroll
  for (int i = 0; i < NR / 4; ++i)
    *reinterpret_cast<float4*>(h + (size_t)i * 2048) = make_float4(
        acc[4 * i + tf32_frag_acc(0)], acc[4 * i + tf32_frag_acc(1)],
        acc[4 * i + tf32_frag_acc(2)], acc[4 * i + tf32_frag_acc(3)]);
}

// sum over the 4 lanes that share an accumulator row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The sigma head on the last trunk activation held in acc:
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

// The rgb head's pre-activation on the direction output g held in acc
// (128 wide): pre[j][o] = sum_col g[row_j][col] * w_rgb[col][o].
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

}  // namespace nerfsr_tf32
