// Kernel F: the sinusoidal positional encoding in one launch.
//
// It replaces no TPU kernel. The JAX package leaves the encoding
// (nerfsr_tpu/core/encoding.py) to XLA, which fuses it into its consumer;
// PyTorch runs it as a chain (core/encoding.py: a broadcast multiply,
// sin, cos, a stack and a cat with the identity) that writes the angles,
// the sines, the cosines and the stacked pair to device memory and reads
// each back, in narrow cats of 3-wide pieces. F computes the chain's
// output, bit for bit, and writes it once:
//   out[r] = [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]
// of input row x = in[r / S] (S, the repeat, feeds a ray's direction to
// its S samples with no per-sample copy), each term spanning the row's C
// channels, the identity left out on request (with no frequencies it is
// the whole row, as the chain returns x itself). Each angle is one rounded
// f32 product (__fmul_rn, as torch's multiply makes it; nothing can fuse
// it into another operation), and each term is precise sinf / cosf, as
// torch's CUDA sin and cos call them. sincosf shares one range reduction
// between the pair and gives sinf's and cosf's bits (the card's tests
// hold F to the chain bit for bit).
//
// Bound on the card: bytes. 4 C_out bytes written a row (the input's 4C,
// read S times from L1 and L2, is a ninth of it or less): the render's image
// writes about 3.2 GB of encodings, 1.0 ms at 3.35 TB/s; the parity step
// 0.15 GB. The arithmetic, one precise sincosf (~40 instructions) a
// pair, is a little under that at the card's SIMT rate.
//
// A block takes a tile of kRows output rows, which lie contiguous in the
// output. Its threads compute the tile into shared memory, one thread a
// (channel, row) pair: the identity and every frequency's sine and cosine
// of one input value, the frequencies unrolled for the port's three
// encodings (4, 6 and 10 frequencies of 3-vectors). Consecutive threads
// take consecutive rows of one channel, so at an odd C_out (63, 39 and
// 27) their shared stores fall in 32 banks. The tile then goes to device
// memory in 16-byte stores, neighbouring threads on neighbouring
// addresses. Small tiles keep many blocks on an SM, so that one block's
// sines overlap another's stores: on an H100 SXM at 700 W, at the
// serving chunk's shapes, tiles of 32 rows took 1.38 ms an image, of 64
// 1.50, of 128 1.64 and of 256 2.08 (bound 1.04 ms; 128 threads a
// block); writing each pair straight to device memory from a thread of
// its own, with no tile, took 2.75.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // output rows a block; tiles start 16-byte aligned
constexpr int kMaxSmem = 48 * 1024;  // the default: no opt-in launch

// kC channels and kNF frequencies fixed at compile time (0: read from
// c and nf), so that a thread's kNF sine-cosine pairs unroll and overlap
template <int kC, int kNF>
__global__ void __launch_bounds__(kThreads)
    posenc_kernel(const float* __restrict__ x, int row_stride,
                  const float* __restrict__ freqs, float* __restrict__ out,
                  int rows, int c_arg, int nf_arg, int ident, int repeat) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int c = kC ? kC : c_arg;
  const int nf = kNF ? kNF : nf_arg;
  const int base = ident ? c : 0;
  const int c_out = base + 2 * nf * c;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, rows - r0);
  for (int i = threadIdx.x; i < nrows * c; i += kThreads) {
    const int ch = i / nrows, lr = i - ch * nrows;
    const unsigned in_row = (unsigned)(r0 + lr) / (unsigned)repeat;
    const float v = x[(size_t)in_row * row_stride + ch];
    float* o = tile + lr * c_out + ch;
    if (ident) o[0] = v;
    o += base;
#pragma unroll
    for (int k = 0; k < nf; ++k) {
      float s, co;
      sincosf(__fmul_rn(v, __ldg(freqs + k)), &s, &co);
      o[2 * k * c] = s;
      o[(2 * k + 1) * c] = co;
    }
  }
  __syncthreads();
  float* dst = out + (size_t)r0 * c_out;
  const int n = nrows * c_out;
  const int n4 = n >> 2;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n4; i += kThreads) dst4[i] = smem[i];
  for (int i = (n4 << 2) + threadIdx.x; i < n; i += kThreads)
    dst[i] = tile[i];
}

template <int kC, int kNF>
int launch(const float* x, int row_stride, const float* freqs, float* out,
           int rows, int c, int nf, int ident, int repeat, int smem,
           cudaStream_t stream) {
  const int blocks = (rows + kRows - 1) / kRows;
  posenc_kernel<kC, kNF><<<blocks, kThreads, smem, stream>>>(
      x, row_stride, freqs, out, rows, c, nf, ident, repeat);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows / repeat, c) with rows `row_stride` floats apart and unit
// channel stride, freqs (nf,) -> out (rows, c_out), f32, row-major, c_out
// = (ident ? c : 0) + 2 nf c (nf 0: the identity alone), at most 384
// (a tile in 48 KB; 3-vectors up to 63 frequencies); out 16-byte aligned
NERFSR_API int nerfsr_posenc(const void* x, int row_stride,
                             const void* freqs, void* out, int rows, int c,
                             int nf, int ident, int repeat, void* stream) {
  if (c < 1 || nf < 0 || repeat < 1 || row_stride < 0)
    return (int)cudaErrorInvalidValue;
  const int c_out = (ident ? c : 0) + 2 * nf * c;
  if (c_out < 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  const int smem = kRows * c_out * (int)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto xf = (const float*)x;
  auto ff = (const float*)freqs;
  auto of = (float*)out;
  auto st = (cudaStream_t)stream;
  // the port's encodings: deg_dir 4, deg_prop 6, deg_pos 10 of 3-vectors
  if (c == 3 && nf == 4)
    return launch<3, 4>(xf, row_stride, ff, of, rows, c, nf, ident, repeat,
                        smem, st);
  if (c == 3 && nf == 6)
    return launch<3, 6>(xf, row_stride, ff, of, rows, c, nf, ident, repeat,
                        smem, st);
  if (c == 3 && nf == 10)
    return launch<3, 10>(xf, row_stride, ff, of, rows, c, nf, ident, repeat,
                         smem, st);
  return launch<0, 0>(xf, row_stride, ff, of, rows, c, nf, ident, repeat,
                      smem, st);
}
