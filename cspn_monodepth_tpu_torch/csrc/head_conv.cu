// The 3 x 3 CSPN's head on Hopper (sm_90a): the 3 x 3 convolution of the
// decoder's (B, Cin, H, W) map into the head's (B, Cout, H', W) float32
// planes (blur and the eight affinities, Cout = 9), stride 1, W padded by
// one pixel, H by `pad_h` (1 on whole images, 0 on the rows layout's
// halo'd window, where H' = H - 2). C entries:
//   head_conv3x3_fwd  y = b + w * x, x read as it is (bf16 under the
//                     model's autocast, else f32) and each value converted
//                     to f32 on load;
//   head_conv3x3_bwd  from dy (B, Cout, H', W) f32: dx in x's dtype (bf16
//                     rounded to nearest even from the f32 sum), dw (Cout,
//                     Cin, 3, 3) and db (Cout) f32.
// No TPU kernel has this function: the JAX package leaves the head's conv
// to XLA. It replaces cuDNN's float32 kernels for it (TF32 off, as the
// configuration states the head in float32): an implicit GEMM whose 64-
// or 32-wide tiles hold 9 output channels, and a 9 x 576 weight gradient
// reduced over every pixel by a 32 x 32 split-K GEMM, at 5-12 % of the
// card's FP32 rate.
// Every kernel's name starts with head_conv3x3_, by which a trace files it
// with the convolutions.
//
// Bound on an H100 SXM: 2 Cin Cout 9 FLOP a pixel in each of the three
// passes (10,368 at Cin 64, Cout 9), 35.5 GFLOP at KITTI's 8 x 352 x 1216:
// 0.53 ms at the 67 TFLOP/s of FP32 FMA outside the tensor cores. The
// bytes (the forward reads 438 MB of bf16 and writes 123 MB at that shape,
// 0.17 ms at 3.35 TB/s) are a third of that, so each pass is bound by its
// FMAs, and the design keeps every other instruction few:
// * all arithmetic is f32 FFMA with an f32 accumulator: no tensor core, no
//   TF32, no reduced-precision operand;
// * direct convolutions, no im2col: a block stages a tile of input rows
//   with its one-pixel halo in shared memory (converted to f32 on the way),
//   and the weights beside it, so that each value a thread loads feeds
//   many FMAs from registers;
// * forward: a thread owns NO (the outputs, 9 padded or 16) outputs of 8
//   pixels of a row, two runs of 4, 72 accumulators; for each input
//   channel and kernel row it loads the 2 x 6 inputs the runs read (one
//   16-byte load and two words each) and 3 NO weights (16-byte
//   broadcasts), then does 3 x NO x 8 = 216 FMAs. Stages of 4 channels are
//   double-buffered: a thread's 16-byte loads of the next stage are in
//   flight while the block computes on this one (`RowStage`);
// * dx: the correlation with the flipped kernel, the same tiling on dy's
//   NO planes (staged once a block), a thread owning 8 input channels of 8
//   pixels at a time and looping over the channels in eights;
// * dw, db: a 9 x 9 Cin product reduced over every pixel. A thread owns
//   one input channel and all 9 NO of its weights (81 accumulators) and
//   walks half of a 64-pixel strip, its three input rows in a ring of
//   three staged rows and dy's row broadcast from shared memory: 81 FMAs a
//   pixel for 3 + 3 loads, the next row's loads in flight meanwhile. A
//   block walks strips of 8 rows (items) in a fixed order, grid-strided,
//   and writes its sums once; `_sum` adds the blocks' partial sums in
//   block order. No float atomics: two runs agree bit for bit, and so do
//   the forward's and dx's single-thread sums.
// * Registers over occupancy: the forward and dw kernels are built for two
//   blocks an SM (up to 255 registers). Capped for three or four blocks
//   they spill (144-700 bytes) and ran slower on an H100 (NVIDIA H100 80GB
//   HBM3, 700 W; PERF.md section 6): the forward at KITTI's B = 8 1.58 ms
//   at three blocks against 1.14 at two, dw 1.28 against 1.18.
// * Tiles are 64 columns wide (16 rows forward and dx); edges are masked,
//   zero outside the image. Cin and W are any size, Cout is at most 16
//   (built for 9 and 16; no registered configuration has 10 to 16).
//   Rows are read in 16-byte pieces where x (dy) is 16-byte aligned and W a
//   multiple of the piece, else element by element.
//
// Built by ops/cspn_cuda.py with nvcc -gencode arch=compute_90a,code=sm_90a
// into a shared library with the plain C interface below, bound by ctypes;
// the wrappers are ops/head_conv.py's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileW = 64;        // output columns a block (every kernel)
constexpr int kTileH = 16;        // output rows a block (forward, dx)
constexpr int kRows = kTileH + 2;
constexpr int kRowPad = 72;       // a staged row: columns x0 - 4 .. x0 + 67
constexpr int kSpan = kTileW + 2; // the columns a tile reads: x0 - 1 ..
constexpr int kChunk = 4;         // input channels a stage of the forward
constexpr int kGroup = 8;         // input channels a pass of dx
constexpr int kSeg = 8;           // output rows an item of dw
constexpr int kRingRow = kSpan + 1;   // odd: one bank a channel
constexpr int kWgradChannels = 64;    // input channels a dw block

struct Shape {
  int b, cin, cout, h_in, w, h_out, pad_h;
  int vec;    // x's rows can be read in 16-byte pieces (aligned, W fits)
  int dvec;   // and dy's
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// n floats rounded up to 16 bytes.
__host__ __device__ constexpr int quad(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The 2 x 6 staged values that two runs of 4 pixels of a row read: run g
// at columns base + 32 g .. + 3 reads columns base + 32 g - 1 .. + 4, at
// staged index 3 + base + 32 g .. (index 4 is column x0).
__device__ __forceinline__ void load_runs(const float* row, int base,
                                          float v[2][6]) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int at = base + 32 * g;
    const float4 a = *reinterpret_cast<const float4*>(row + 4 + at);
    v[g][0] = row[3 + at];
    v[g][1] = a.x;
    v[g][2] = a.y;
    v[g][3] = a.z;
    v[g][4] = a.w;
    v[g][5] = row[8 + at];
  }
}

__device__ __forceinline__ void unpack(const uint4& q, float* v, float) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(const uint4& q, float* v,
                                       __nv_bfloat16) {
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One thread's share of staging x's rows row0 .. row0 + R - 1 of channels
// c0 .. c0 + C - 1 (of the `cin` at xb), columns x0 - 1 .. x0 + 64, as f32
// at dst[ci PC + r PR + j], j = column - x0 + 1; zero outside the image and
// past cin. `load` issues every load of the share into registers (the 64
// columns in 16-byte pieces, 8 bf16 or 4 f32 each, the two halo columns a
// word each), `store` writes them, so that a block's loads for its next
// stage fly while it computes on the last. `kAligned`: dst + 1 and the
// pitches are 16-byte aligned, so a piece is stored as float4s.
template <typename T, int C, int R>
struct RowStage {
  static constexpr int V = 16 / sizeof(T), Q = kTileW / V;
  static constexpr int kPieces = C * R * Q, kHalos = C * R * 2;
  static constexpr int kIters = (kPieces + kThreads - 1) / kThreads;
  static constexpr int kHaloIters = (kHalos + kThreads - 1) / kThreads;
  uint4 got[kIters];
  bool whole[kIters];
  float halo[kHaloIters];

  __device__ __forceinline__ void load(const T* __restrict__ xb,
                                       const Shape& s, int cin, int c0,
                                       int row0, int x0) {
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int e = threadIdx.x + k * kThreads;
      got[k] = make_uint4(0u, 0u, 0u, 0u);
      whole[k] = true;
      if (e < kPieces) {
        const int ci = e / (R * Q), r = e / Q % R, q = e % Q;
        const int yy = row0 + r, xx = x0 + q * V;
        if (c0 + ci < cin && yy >= 0 && yy < s.h_in && xx < s.w) {
          if (s.vec && xx + V <= s.w)
            got[k] = *reinterpret_cast<const uint4*>(
                xb + ((int64_t)(c0 + ci) * s.h_in + yy) * s.w + xx);
          else
            whole[k] = false;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kHaloIters; ++k) {
      const int e = threadIdx.x + k * kThreads;
      halo[k] = 0.f;
      if (e < kHalos) {
        const int ci = e / (R * 2), r = e / 2 % R;
        const int yy = row0 + r, xx = e % 2 ? x0 + kTileW : x0 - 1;
        if (c0 + ci < cin && yy >= 0 && yy < s.h_in && xx >= 0 && xx < s.w)
          halo[k] =
              to_f32(xb[((int64_t)(c0 + ci) * s.h_in + yy) * s.w + xx]);
      }
    }
  }

  template <int PC, int PR, bool kAligned>
  __device__ __forceinline__ void store(const T* __restrict__ xb,
                                        const Shape& s, int c0, int row0,
                                        int x0, float* dst) const {
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < kPieces) {
        const int ci = e / (R * Q), r = e / Q % R, q = e % Q;
        float v[V];
        if (whole[k]) {
          unpack(got[k], v, T());
        } else {  // past W's end in the piece, or x unaligned
          const int xx = x0 + q * V;
          const T* src =
              xb + ((int64_t)(c0 + ci) * s.h_in + row0 + r) * s.w + xx;
#pragma unroll
          for (int i = 0; i < V; ++i)
            v[i] = xx + i < s.w ? to_f32(src[i]) : 0.f;
        }
        float* d = dst + ci * PC + r * PR + 1 + q * V;
#pragma unroll
        for (int i = 0; i < V; i += 4) {
          if (kAligned) {
            *reinterpret_cast<float4*>(d + i) =
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
          } else {
            d[i] = v[i];
            d[i + 1] = v[i + 1];
            d[i + 2] = v[i + 2];
            d[i + 3] = v[i + 3];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kHaloIters; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < kHalos)
        dst[e / (R * 2) * PC + e / 2 % R * PR + (e % 2 ? kSpan - 1 : 0)] =
            halo[k];
    }
  }
};

// The forward: block (x tile, y tile, image), thread t owning outputs of
// row y0 + t / 8 at columns x0 + 4 (t % 8) + 32 g + p (g < 2, p < 4).
template <typename T, int NO>
__global__ void __launch_bounds__(kThreads, 2)
head_conv3x3_fwd(const T* __restrict__ x, const float* __restrict__ weight,
                 const float* __restrict__ bias, float* __restrict__ y,
                 Shape s) {
  constexpr int kW = quad(3 * NO);
  constexpr int kWLoads = (kChunk * 9 * NO + kThreads - 1) / kThreads;
  // Two stages: the block computes on one while the next is loaded.
  __shared__ __align__(16) float xs[2][kChunk][kRows][kRowPad];
  __shared__ __align__(16) float ws[2][kChunk][3][kW];
  const int t = threadIdx.x, tx = t % 8, ty = t / 8;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z, row0 = y0 - s.pad_h;
  const T* xb = x + (int64_t)b * s.cin * s.h_in * s.w;

  float acc[NO][8];
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const float b0 = o < s.cout ? bias[o] : 0.f;
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[o][p] = b0;
  }

  // Stage c0's channels: x's tile rows, and ws[ci][ky][kx NO + o] =
  // weight[o][c0 + ci][ky][kx].
  RowStage<T, kChunk, kRows> rows;
  float wgot[kWLoads];
  auto load = [&](int c0) {
    rows.load(xb, s, s.cin, c0, row0, x0);
#pragma unroll
    for (int k = 0; k < kWLoads; ++k) {
      const int e = t + k * kThreads, ci = e / (9 * NO), o = e % NO;
      wgot[k] = e < kChunk * 9 * NO && c0 + ci < s.cin && o < s.cout
                    ? weight[(o * s.cin + c0 + ci) * 9 + e % (9 * NO) / NO]
                    : 0.f;
    }
  };
  auto store = [&](int c0, int buf) {
    rows.template store<kRows * kRowPad, kRowPad, true>(xb, s, c0, row0, x0,
                                                         &xs[buf][0][0][3]);
#pragma unroll
    for (int k = 0; k < kWLoads; ++k) {
      const int e = t + k * kThreads, kk = e % (9 * NO) / NO;
      if (e < kChunk * 9 * NO)
        ws[buf][e / (9 * NO)][kk / 3][kk % 3 * NO + e % NO] = wgot[k];
    }
  };
  load(0);
  store(0, 0);
  __syncthreads();
  const int stages = cdiv(s.cin, kChunk);
  for (int n = 0; n < stages; ++n) {
    const int buf = n & 1;
    if (n + 1 < stages) load((n + 1) * kChunk);
#pragma unroll 1
    for (int ci = 0; ci < kChunk; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float v[2][6];
        load_runs(&xs[buf][ci][ty + ky][0], 4 * tx, v);
        // The row's 3 NO weights in 16-byte broadcasts.
        float wr[kW];
#pragma unroll
        for (int q = 0; q < kW / 4; ++q) {
          const float4 w4 =
              reinterpret_cast<const float4*>(&ws[buf][ci][ky][0])[q];
          wr[4 * q] = w4.x;
          wr[4 * q + 1] = w4.y;
          wr[4 * q + 2] = w4.z;
          wr[4 * q + 3] = w4.w;
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int o = 0; o < NO; ++o) {
            const float wv = wr[kx * NO + o];
#pragma unroll
            for (int g = 0; g < 2; ++g) {
#pragma unroll
              for (int p = 0; p < 4; ++p)
                acc[o][4 * g + p] = fmaf(v[g][p + kx], wv, acc[o][4 * g + p]);
            }
          }
        }
      }
    }
    // The other stage's last readers passed the previous barrier.
    if (n + 1 < stages) store((n + 1) * kChunk, buf ^ 1);
    __syncthreads();
  }

  const int yy = y0 + ty;
  if (yy >= s.h_out) return;
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    if (o >= s.cout) break;
    float* yr = y + (((int64_t)b * s.cout + o) * s.h_out + yy) * s.w;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int xx = x0 + 4 * tx + 32 * g;
      if (xx + 3 < s.w && s.w % 4 == 0) {
        *reinterpret_cast<float4*>(yr + xx) =
            make_float4(acc[o][4 * g], acc[o][4 * g + 1], acc[o][4 * g + 2],
                        acc[o][4 * g + 3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (xx + p < s.w) yr[xx + p] = acc[o][4 * g + p];
      }
    }
  }
}

__device__ __forceinline__ void store4(float* at, const float* v, int n,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(at) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int p = 0; p < n; ++p) at[p] = v[p];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* at, const float* v,
                                       int n, bool vec) {
  if (vec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 bits;
    bits.x = *reinterpret_cast<const unsigned int*>(&lo);
    bits.y = *reinterpret_cast<const unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(at) = bits;
  } else {
    for (int p = 0; p < n; ++p) at[p] = __float2bfloat16_rn(v[p]);
  }
}

// dx: block (x tile, y tile of x's rows, image), thread t owning x's row
// y0 + t / 8 at the columns of the forward's thread t; dx(y, x) =
// sum_{o, ky, kx} w[o][c][ky][kx] dy(y + pad_h - ky, x + 1 - kx), dy's rows
// y0 + pad_h - 2 + r (r < 18) staged once for all NO planes.
template <typename T, int NO>
__global__ void __launch_bounds__(kThreads, NO <= 9 ? 4 : 2)
head_conv3x3_dgrad(const float* __restrict__ dy,
                   const float* __restrict__ weight, T* __restrict__ dx,
                   Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;                                   // [NO][kRows][kRowPad]
  float* wd = smem + NO * kRows * kRowPad;            // [NO][9][kGroup]
  const int t = threadIdx.x, tx = t % 8, ty = t / 8;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const float* dyb = dy + (int64_t)b * s.cout * s.h_out * s.w;

  for (int e = t; e < NO * kRows * kSpan; e += kThreads) {
    const int o = e / (kRows * kSpan), rj = e % (kRows * kSpan);
    const int r = rj / kSpan, j = rj % kSpan;
    const int yy = y0 + s.pad_h - 2 + r, xx = x0 - 1 + j;
    float v = 0.f;
    if (o < s.cout && yy >= 0 && yy < s.h_out && xx >= 0 && xx < s.w)
      v = dyb[((int64_t)o * s.h_out + yy) * s.w + xx];
    ys[(o * kRows + r) * kRowPad + 3 + j] = v;
  }

  const int yy = y0 + ty;
  T* dxb = dx + (int64_t)b * s.cin * s.h_in * s.w;
  const bool vec = s.w % 4 == 0;
  for (int c0 = 0; c0 < s.cin; c0 += kGroup) {
    __syncthreads();
    // wd[o][ky 3 + kx][i] = weight[o][c0 + i][ky][kx]
    for (int e = t; e < NO * 9 * kGroup; e += kThreads) {
      const int o = e / (9 * kGroup), k = e / kGroup % 9, i = e % kGroup;
      const int c = c0 + i;
      wd[e] = o < s.cout && c < s.cin ? weight[(o * s.cin + c) * 9 + k]
                                      : 0.f;
    }
    __syncthreads();
    float acc[kGroup][8];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
#pragma unroll
      for (int p = 0; p < 8; ++p) acc[i][p] = 0.f;
#pragma unroll 1
    for (int o = 0; o < NO; ++o) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float v[2][6];
        load_runs(ys + (o * kRows + ty + 2 - ky) * kRowPad, 4 * tx, v);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wq =
              reinterpret_cast<const float4*>(wd + (o * 9 + ky * 3 + kx) * kGroup);
          const float4 lo = wq[0], hi = wq[1];
          const float wv[kGroup] = {lo.x, lo.y, lo.z, lo.w,
                                    hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int i = 0; i < kGroup; ++i)
#pragma unroll
            for (int g = 0; g < 2; ++g)
#pragma unroll
              for (int p = 0; p < 4; ++p)
                acc[i][4 * g + p] =
                    fmaf(v[g][p + 2 - kx], wv[i], acc[i][4 * g + p]);
        }
      }
    }
    if (yy < s.h_in) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (c0 + i >= s.cin) break;
        T* row = dxb + ((int64_t)(c0 + i) * s.h_in + yy) * s.w;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int xx = x0 + 4 * tx + 32 * g;
          if (xx < s.w)
            store4(row + xx, &acc[i][4 * g], min(4, s.w - xx),
                   vec && xx + 3 < s.w);
        }
      }
    }
  }
}

// dw and db: block (item walker g, channel block), thread t owning input
// channel cb 64 + t % 64 and the columns 32 (t / 64) .. + 31 of each
// 64-column strip. An item is (image, strip, 8 output rows); walker g takes
// items g, g + G, ... Each output row y needs x's rows y - pad_h + ky
// (ky < 3): a ring of three staged rows, slot (row + 3) % 3, each 64
// channels x kSpan columns (staged index j is column x0 - 1 + j). dy's row
// y is staged [pixel][NO padded to 4]. Partial sums out: dw's at
// partial[(cb G + g) (NO 64 9) + (o 64 + c) 9 + ky 3 + kx], db's (channel
// block 0 only) at db_partial[g NO + o].
template <typename T, int NO>
__global__ void __launch_bounds__(kThreads, 2)
head_conv3x3_wgrad(const float* __restrict__ dy, const T* __restrict__ x,
                   float* __restrict__ partial,
                   float* __restrict__ db_partial, Shape s, int strips,
                   int segs) {
  constexpr int kD = quad(NO);
  constexpr int kDQ = kTileW / 4;                  // dy's pieces a plane row
  constexpr int kDPieces = NO * kDQ;
  constexpr int kDIters = (kDPieces + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                 // [3][64][kRingRow]
  float* ds = smem + 3 * kWgradChannels * kRingRow;   // [kTileW][kD]
  const int t = threadIdx.x, cl = t % kWgradChannels, half = t / 64;
  const int cb = blockIdx.y, cin = s.cin - cb * kWgradChannels;
  const int items = s.b * strips * segs;

  float acc[NO][3][3];
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[o][k / 3][k % 3] = 0.f;
  float dbp[kDIters];
#pragma unroll
  for (int k = 0; k < kDIters; ++k) dbp[k] = 0.f;

  // A stage: x's row `row` for its ring slot and dy's row `yrow`, in
  // 16-byte pieces of 4 pixels; loaded into registers while the block
  // computes on the last stage, then stored.
  RowStage<T, kWgradChannels, 1> xrow;
  float4 dgot[kDIters];
  const T* xb = x;
  const float* dyb = dy;
  int x0 = 0;
  auto load_dy = [&](int yrow) {
#pragma unroll
    for (int k = 0; k < kDIters; ++k) {
      const int e = t + k * kThreads, o = e / kDQ, xx = x0 + e % kDQ * 4;
      dgot[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < kDPieces && o < s.cout && xx < s.w) {
        const float* src = dyb + ((int64_t)o * s.h_out + yrow) * s.w + xx;
        if (s.dvec && xx + 4 <= s.w) {
          dgot[k] = *reinterpret_cast<const float4*>(src);
        } else {
          dgot[k].x = src[0];
          dgot[k].y = xx + 1 < s.w ? src[1] : 0.f;
          dgot[k].z = xx + 2 < s.w ? src[2] : 0.f;
          dgot[k].w = xx + 3 < s.w ? src[3] : 0.f;
        }
      }
    }
  };
  auto store_dy = [&]() {
#pragma unroll
    for (int k = 0; k < kDIters; ++k) {
      const int e = t + k * kThreads;
      if (e < kDPieces) {
        float* d = ds + e % kDQ * 4 * kD + e / kDQ;
        d[0] = dgot[k].x;
        d[kD] = dgot[k].y;
        d[2 * kD] = dgot[k].z;
        d[3 * kD] = dgot[k].w;
        dbp[k] += dgot[k].x + dgot[k].y + dgot[k].z + dgot[k].w;
      }
    }
  };
  auto store_x = [&](int row) {
    xrow.template store<kRingRow, 0, false>(
        xb, s, 0, row, x0, ring + (row + 3) % 3 * kWgradChannels * kRingRow);
  };

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / (strips * segs);
    const int strip = item / segs % strips, seg = item % segs;
    const int r0 = seg * kSeg, r1 = min(r0 + kSeg, s.h_out);
    x0 = strip * kTileW;
    xb = x + ((int64_t)b * s.cin + cb * kWgradChannels) * s.h_in * s.w;
    dyb = dy + (int64_t)b * s.cout * s.h_out * s.w;
    // The item's first three rows and dy's first, every load issued before
    // the first store; the last item's readers are past the barrier that
    // ended it.
    {
      RowStage<T, kWgradChannels, 1> first[2];
      first[0].load(xb, s, cin, 0, r0 - s.pad_h, x0);
      first[1].load(xb, s, cin, 0, r0 - s.pad_h + 1, x0);
      xrow.load(xb, s, cin, 0, r0 - s.pad_h + 2, x0);
      load_dy(r0);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        first[k].template store<kRingRow, 0, false>(
            xb, s, 0, r0 - s.pad_h + k, x0,
            ring + (r0 - s.pad_h + k + 3) % 3 * kWgradChannels * kRingRow);
      store_x(r0 - s.pad_h + 2);
      store_dy();
    }
    __syncthreads();
    for (int yrow = r0; yrow < r1; ++yrow) {
      const bool more = yrow + 1 < r1;
      if (more) {
        xrow.load(xb, s, cin, 0, yrow - s.pad_h + 3, x0);
        load_dy(yrow + 1);
      }
      const float* rows[3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        rows[ky] = ring + (yrow - s.pad_h + ky + 3) % 3 * kWgradChannels *
                              kRingRow + cl * kRingRow + 32 * half;
      float win[3][3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        win[ky][0] = rows[ky][0];
        win[ky][1] = rows[ky][1];
      }
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const float4* dq = reinterpret_cast<const float4*>(
            ds + (32 * half + j) * kD);
        float d[kD];
#pragma unroll
        for (int q = 0; q < kD / 4; ++q) {
          const float4 v4 = dq[q];
          d[4 * q] = v4.x;
          d[4 * q + 1] = v4.y;
          d[4 * q + 2] = v4.z;
          d[4 * q + 3] = v4.w;
        }
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          win[ky][2] = rows[ky][j + 2];
#pragma unroll
          for (int o = 0; o < NO; ++o)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              acc[o][ky][kx] = fmaf(d[o], win[ky][kx], acc[o][ky][kx]);
          win[ky][0] = win[ky][1];
          win[ky][1] = win[ky][2];
        }
      }
      __syncthreads();
      if (more) {
        // Row yrow - pad_h's slot and dy's row are free: every reader of
        // them is past the barrier above.
        store_x(yrow - s.pad_h + 3);
        store_dy();
        __syncthreads();
      }
    }
  }

  // The two halves of each channel, then db over the staged positions, in
  // a fixed order.
  __syncthreads();
  float* red = smem;                                  // [64][NO 9]
  if (half == 1) {
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        red[cl * NO * 9 + o * 9 + k] = acc[o][k / 3][k % 3];
  }
  __syncthreads();
  if (half == 0) {
    float* out = partial + ((int64_t)cb * gridDim.x + blockIdx.x) * NO *
                               kWgradChannels * 9;
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        out[(o * kWgradChannels + cl) * 9 + k] =
            acc[o][k / 3][k % 3] + red[cl * NO * 9 + o * 9 + k];
  }
  if (cb != 0) return;
  __syncthreads();
  float* dbs = smem;                                  // [NO kDQ]
#pragma unroll
  for (int k = 0; k < kDIters; ++k) {
    const int e = t + k * kThreads;
    if (e < kDPieces) dbs[e] = dbp[k];
  }
  __syncthreads();
  if (t < NO) {
    float sum = 0.f;
    for (int q = 0; q < kDQ; ++q) sum += dbs[t * kDQ + q];
    db_partial[blockIdx.x * NO + t] = sum;
  }
}

// dw (Cout, Cin, 3, 3) and db (Cout): each the sum of its partial sums
// over the G walkers, in walker order.
template <int NO>
__global__ void __launch_bounds__(256)
head_conv3x3_wgrad_sum(const float* __restrict__ partial,
                       const float* __restrict__ db_partial,
                       float* __restrict__ dw, float* __restrict__ db,
                       Shape s, int walkers) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < s.cout * s.cin * 9) {
    const int o = idx / (s.cin * 9), c = idx / 9 % s.cin, k = idx % 9;
    const int cb = c / kWgradChannels, cl = c % kWgradChannels;
    const float* p = partial + (int64_t)cb * walkers * NO * kWgradChannels * 9 +
                     (o * kWgradChannels + cl) * 9 + k;
    float sum = 0.f;
    for (int g = 0; g < walkers; ++g)
      sum += p[(int64_t)g * NO * kWgradChannels * 9];
    dw[idx] = sum;
  }
  if (idx < s.cout) {
    float sum = 0.f;
    for (int g = 0; g < walkers; ++g) sum += db_partial[g * NO + idx];
    db[idx] = sum;
  }
}

size_t dgrad_smem(int no) {
  return sizeof(float) * (no * kRows * kRowPad + no * 9 * kGroup);
}

size_t wgrad_smem(int no) {
  const size_t ring = 3 * kWgradChannels * kRingRow;
  const size_t ds = (size_t)kTileW * ((no + 3) / 4 * 4);
  const size_t red = (size_t)kWgradChannels * no * 9;
  return sizeof(float) * (ring + ds > red ? ring + ds : red);
}

// Floats of one walker's partial sums: dw's of every channel block, then
// db's.
size_t walker_floats(const Shape& s, int no) {
  return (size_t)cdiv(s.cin, kWgradChannels) * no * kWgradChannels * 9 + no;
}

// The walkers G of the dw pass: as many blocks as the card holds at once, a
// share of each channel block, at most one an item and as many as
// `scratch_floats` holds (0: not even one).
template <typename T, int NO>
int walkers_of(const Shape& s, int strips, int segs, size_t scratch_floats) {
  static int held[16] = {};   // blocks the card holds at once, a device
  int device = 0;
  cudaGetDevice(&device);
  int blocks = device < 16 ? held[device] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const size_t smem = wgrad_smem(NO);
    cudaFuncSetAttribute(head_conv3x3_wgrad<T, NO>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, head_conv3x3_wgrad<T, NO>, kThreads, smem);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (device < 16) held[device] = blocks;
  }
  const int fill = blocks / cdiv(s.cin, kWgradChannels);
  const int items = s.b * strips * segs;
  const size_t room = scratch_floats / walker_floats(s, NO);
  int g = fill < 1 ? 1 : (fill < items ? fill : items);
  return room < (size_t)g ? (int)room : g;
}

// Whether rows of w elements at p can be read in 16-byte pieces of
// `elems` elements.
bool aligned(const void* p, int w, int elems) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && w % elems == 0;
}

template <typename T, int NO>
int launch_fwd(const void* x, const float* weight, const float* bias,
               float* y, Shape s, cudaStream_t stream) {
  s.vec = aligned(x, s.w, 16 / sizeof(T));
  const dim3 grid(cdiv(s.w, kTileW), cdiv(s.h_out, kTileH), s.b);
  head_conv3x3_fwd<T, NO><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), weight, bias, y, s);
  return (int)cudaGetLastError();
}

template <typename T, int NO>
int launch_bwd(const float* dy, const void* x, const float* weight, void* dx,
               float* dw, float* db, float* scratch, size_t scratch_floats,
               Shape s, cudaStream_t stream) {
  s.vec = aligned(x, s.w, 16 / sizeof(T));
  s.dvec = aligned(dy, s.w, 4);
  const int strips = cdiv(s.w, kTileW), segs = cdiv(s.h_out, kSeg);
  const int walkers = walkers_of<T, NO>(s, strips, segs, scratch_floats);
  if (walkers < 1) return (int)cudaErrorInvalidValue;
  const size_t dsmem = dgrad_smem(NO);
  cudaFuncSetAttribute(head_conv3x3_dgrad<T, NO>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)dsmem);
  const dim3 dgrid(cdiv(s.w, kTileW), cdiv(s.h_in, kTileH), s.b);
  head_conv3x3_dgrad<T, NO><<<dgrid, kThreads, dsmem, stream>>>(
      dy, weight, static_cast<T*>(dx), s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t wsmem = wgrad_smem(NO);
  cudaFuncSetAttribute(head_conv3x3_wgrad<T, NO>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)wsmem);
  const int chunks = cdiv(s.cin, kWgradChannels);
  float* db_partial =
      scratch + (size_t)chunks * walkers * NO * kWgradChannels * 9;
  const dim3 wgrid(walkers, chunks);
  head_conv3x3_wgrad<T, NO><<<wgrid, kThreads, wsmem, stream>>>(
      dy, static_cast<const T*>(x), scratch, db_partial, s, strips, segs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_conv3x3_wgrad_sum<NO><<<cdiv(s.cout * s.cin * 9, 256), 256, 0, stream>>>(
      scratch, db_partial, dw, db, s, walkers);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, Cout, H + 2 pad_h - 2, W) f32 = the conv of x (B, Cin, H, W),
// contiguous, f32 (dtype 0) or bf16 (1), with weight (Cout, Cin, 3, 3) and
// bias (Cout) f32. Returns cudaGetLastError() of the launch.
int head_conv3x3_fwd(const void* x, const float* weight, const float* bias,
                     float* y, int b, int cin, int cout, int h_in, int w,
                     int pad_h, int dtype, cudaStream_t stream) {
  const Shape s{b, cin, cout, h_in, w, h_in + 2 * pad_h - 2, pad_h, 0, 0};
  if (dtype == 0)
    return cout <= 9 ? launch_fwd<float, 9>(x, weight, bias, y, s, stream)
                     : launch_fwd<float, 16>(x, weight, bias, y, s, stream);
  return cout <= 9
             ? launch_fwd<__nv_bfloat16, 9>(x, weight, bias, y, s, stream)
             : launch_fwd<__nv_bfloat16, 16>(x, weight, bias, y, s, stream);
}

// From dy (B, Cout, H', W) f32 contiguous and the forward's x and weight:
// dx (x's shape and dtype, contiguous), dw (Cout, Cin, 3, 3) and db (Cout)
// f32. scratch holds scratch_floats floats for the dw pass's partial sums;
// fewer walkers run where it holds fewer than the card would take, and
// cudaErrorInvalidValue returns where it holds not one walker's
// (walker_floats). Returns cudaGetLastError() of the first failing launch.
int head_conv3x3_bwd(const float* dy, const void* x, const float* weight,
                     void* dx, float* dw, float* db, float* scratch,
                     size_t scratch_floats, int b, int cin, int cout,
                     int h_in, int w, int pad_h, int dtype,
                     cudaStream_t stream) {
  const Shape s{b, cin, cout, h_in, w, h_in + 2 * pad_h - 2, pad_h, 0, 0};
#define HEAD_CONV_BWD(T, NO)                                                \
  launch_bwd<T, NO>(dy, x, weight, dx, dw, db, scratch, scratch_floats, s, \
                    stream)
  if (dtype == 0)
    return cout <= 9 ? HEAD_CONV_BWD(float, 9) : HEAD_CONV_BWD(float, 16);
  return cout <= 9 ? HEAD_CONV_BWD(__nv_bfloat16, 9)
                   : HEAD_CONV_BWD(__nv_bfloat16, 16);
#undef HEAD_CONV_BWD
}

const char* head_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
