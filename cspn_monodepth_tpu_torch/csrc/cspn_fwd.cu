// CSPN forward propagation on Hopper (sm_90a): affinity normalization,
// d^0 anchoring and T iterations of the 8-neighbour gather stencil with
// per-iteration sparse re-anchoring. Four C entries share one round kernel,
// templated on the contract, the stash and the tile geometry:
//   cspn_fwd        the forward of raw guidance: K1, the eval and serving
//                   forward of the whole-plane route, and K4, the H-tiled
//                   route's, which computes the same function (its wrapper
//                   in ops/cspn_cuda.py launches this entry);
//   cspn_fwd_stash  the training forward, which also writes every
//                   pre-iteration plane d^t to a (B, T, H, W) stash that the
//                   adjoint (csrc/cspn_bwd.cu) reads back in reverse: K2 and
//                   K5, one function again;
//   cspn_prenorm_fwd, cspn_prenorm_fwd_stash  (K7, K8) the same two on the
//                   prenormalized contract of the spatially sharded CSPN
//                   (parallel/halo.py): nine gate planes (B, 9, H, W),
//                   centre first, read as they are (no normalization), and
//                   d^0 taken as given unless the caller asks for the
//                   anchor on load (the first round of the slab route); the
//                   anchor still follows every iteration. They run on one
//                   rank's (H/S + 2k)-row slab for one round of r <= k
//                   iterations. The slab's halo rows are its neighbours'
//                   rows, copied in by the caller (zero rows on the first
//                   and last shard); to the kernel they are image rows like
//                   any other, and the zero border lies outside the slab, as
//                   in the TPU kernel's padded plane. K7 is also the
//                   function of the serving operator `cspn_tiled_fwd`
//                   (ops/library.py), which keeps the gates9 contract of
//                   programs exported before the H-tiled route took raw
//                   guidance.
//
// Replaces: cspn_monodepth_tpu/ops/cspn_pallas.py:_cspn_kernel (launched by
// _cspn_pallas_fwd_impl) and _cspn_kernel_stash (launched by
// _cspn_pallas_stash_fwd), the whole-plane TPU kernels, and
// _cspn_tiled_kernel (launched by _tiled_launch) and
// _cspn_tiled_stash_kernel (launched by _tiled_stash_launch), the H-tiled
// ones, with the normalization and d^0's anchor that
// _cspn_pallas_tiled_fwd_impl and _cspn_tiled_stash_fwd_impl run around
// them (_tiled_pad_inputs, _prenorm_gates9), and _cspn_prenorm_kernel (launched by _cspn_prenorm_fwd_impl) and
// _cspn_prenorm_stash_kernel (launched by _cspn_prenorm_stash_fwd), the
// spatial path's slab kernels. They compute the same functions; they do not
// copy the TPU layout (the TPU tiles H only, pads W to 128 lanes and
// stashes each tile's interior +-1 rows; here the 2-D tiles below serve
// every route, and the stash is the plain (B, T, H, W) array). The TPU
// kernel keeps a whole plane and 9 gate planes resident in VMEM; one
// 228x304 f32 plane is 277 KB and a Hopper block has at most 227 KB of
// shared memory, so here the plane is cut into tiles instead.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function must read
// the 8 guidance planes, blur and sparse once and write the result once,
// 44 B/px. At B=32 x 228x304 that is 97.6 MB, about 29 us; at B=1 about
// 0.9 us, so a single image is launch-bound. The arithmetic, 19 flop/px per
// iteration plus the normalization, is far below the f32 rate: the kernel
// is bound by bytes. K2 writes T more planes: (11 + T) * 4 B/px, 310.5 MB
// at B=32, T=24, about 93 us. K4 and K5 are the same functions at KITTI's
// B=8 x 352x1216: 150.7 MB, about 45 us, and 479.4 MB, about 143 us. The
// gates9 contract reads nine gate planes instead of eight and d^0 for the
// blur: 48 B/px without the stash. K7 on KITTI's 2x4 slab (B=4 images
// of 96x1216, one round of 4 iterations) moves 12 planes, 22.4 MB, about
// 6.7 us; K8 16 planes, about 8.9 us: a few microseconds of launch latency
// are a large part of such a call.
//
// Design:
// * Rounds of recompute-in-halo tiles. A block owns a TILE x TILE interior
//   and loads the SLAB x SLAB slab around it (SLAB = TILE + 2 HALO). It runs
//   up to HALO iterations on the slab; values within r pixels of the slab
//   edge go stale after r iterations, so the interior stays exact and is
//   written out. The host launches ceil(T/HALO) rounds, ping-ponging d
//   between `out` and `scratch`. Bytes per round: every slab pixel reads
//   its gates (9 planes; K1/K2's first round 8 raw planes), d and sparse,
//   and every interior pixel writes d: 12 planes of the image, the reads
//   times the slab's overfetch (SLAB/TILE)^2 (1.56 at 32/4, 1.78 at 48/8,
//   2.56 at 40/12) through L2. One round reads what the whole call must
//   read, so the round count multiplies the bound. On an H100 (NVIDIA
//   H100 80GB HBM3, 700 W; PERF.md section 6) one round's load phase alone
//   (T=0) takes the gates9 round at KITTI B=8 (K4 before it took raw
//   guidance) 0.077 ms and K1 at NYU B=32 0.082, so
//   fewer, larger rounds win.
// * One launch per round holds the whole batch (grid.z = B). Running
//   every round of an L2-sized chunk of images before the next chunk was
//   swept on the H100 and lost at every batch shape (PERF.md section 6): a
//   chunk's launch ends in a ragged last wave, and the rounds are bound by
//   the blocks' serial load-iterate-store phases, not by device memory
//   (the gates9 round at KITTI B=8 in three 48/8 rounds reads 493 MB in
//   0.34 ms, 1.45 of the
//   card's 3.35 TB/s).
// * A raw call normalizes once. Its first round normalizes the raw guidance
//   of its slab and, where more rounds follow, writes its interior's gates9
//   to a (B, 9, H, W) scratch that the wrapper allocates; later rounds read
//   those gates as K7 does. The stored gates are the computed ones, with
//   csrc/cspn_bwd.cu's stage 0 expression, so the output is bit for bit
//   that of the gates9 contract on cspn_gates9's planes with d^0 anchored
//   on load.
// * Strips. A thread owns a run of RUN consecutive slab rows in one slab
//   column; neighbouring lanes own neighbouring columns (no bank conflicts;
//   coalesced rows in device memory). It keeps its pixels' 9 gates, their
//   anchors and its own column's d values in registers across the round,
//   and reads from shared memory only the rows just above and below its
//   run and the columns to its left and right: 2 RUN + 6 loads per RUN
//   pixels an iteration, against 9 per pixel for a thread whose pixels lie
//   rows apart. An anchor is one float: NaN for a free pixel, else the
//   value the pixel is held to (sparse > 0, or 0 outside the image).
// * Tile geometry by shape: TILE, HALO, RUN and MINB (the blocks per SM
//   the registers are capped for) are template parameters. The table is
//   ops/cspn_cuda.py:FWD_GEOMETRIES, which the build passes in as the
//   X-macro CSPN_FWD_GEOMETRIES(G) (a header it writes and -includes);
//   index i of the table is instantiation i here. Its pick_geometry takes
//   the fastest of the H100 sweep for each class (CUDA-event ms, T=24,
//   NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6):
//     0: 32/4,  5-row runs, 320 threads, 2 blocks/SM: rounds of <= 4
//        iterations (K7/K8's slabs: KITTI 2x4 0.027 ms, device 0.011);
//     1: 32/8,  3-row runs, 768 threads: up to ~200k px (one NYU image,
//        device 0.018 ms);
//     2: 48/8,  4-row runs, 1024 threads, 64 registers: up to ~3M px (one
//        KITTI image, device 0.044; NYU B=32 0.281 ms);
//     3: 40/12, 4-row runs, 1024 threads: beyond (KITTI B=8 0.328 ms, two
//        rounds).
//   A stash call takes the same: the stash entries' own sweep found the
//   same points fastest. Every geometry has HALO >= 4, so the spatial
//   path's rounds of r <= 4 (K7, K8) are one launch. No variant spills
//   under its register cap (ptxas, chip_smoke.py's build line).
// * Per-pixel arithmetic: each pixel's gates and its 9-term fmaf chain are
//   the same in every geometry and variant, so every geometry gives the
//   same output bit for bit, K2's is K1's and K5's is K4's.
// * Zero border at the image edge only: slab pixels outside the image
//   get d = 0, all nine gates 0 and an anchor of 0, so they stay exactly
//   0. A tile edge inside the image is covered by the halo, never zeroed.
// * d^0 is anchored before the first iteration: the first round of a raw
//   call anchors d on load, and so does K7/K8's when the caller asks
//   (`anchor0`); otherwise K7/K8 take d^0 as given. Every later round loads
//   planes that the previous round's last iteration anchored. The mask is
//   sparse > 0.
// * Stash (K2, K5, K8): at the start of each iteration every block writes
//   its tile's interior of d^t. The interior is exact at every iteration of
//   a round, and the interiors tile the image, so the stash is exact.
//   H and W need not be multiples of the tile. Each thread stores its
//   interior pixels' d^t from registers through one pointer advanced a
//   plane an iteration; addressing each store from t spills 20-124 bytes
//   at the 1024-thread geometries. The stores are issued and
//   not waited for, so the memory system overlaps them with the stencil:
//   on an H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6) K2 at
//   NYU B=32 takes 0.345 ms and the gates9 stash entry at KITTI B=8 (K5
//   before it took raw guidance) 0.439 (0.409 and 0.548
//   before), the stash's bytes at the card's memory rate taking 0.064 and
//   0.098. Two designs that copied the stash from shared memory with
//   Hopper's bulk asynchronous copies lost there and are gone: one
//   cp.async.bulk per interior row (~33 ns a copy per SM, K2 0.612 ms),
//   and a cp.async.bulk.tensor store of a dense staging tile per plane
//   (K2 0.363, K5 0.471): the iterations are bound by instruction issue,
//   and the staging stores and the proxy fence cost more there than the
//   per-thread stores.
// * Strides: each plane is contiguous (row stride W), the guidance planes
//   of one image are H*W apart, and every input takes its own batch
//   stride, so the model's head output (B, 9, H, W) is passed as
//   guidance = heads[:, 1:] and blur = heads[:, 0] without a copy.
//
// Built by ops/cspn_cuda.py with nvcc -gencode arch=compute_90a,code=sm_90a
// into a shared library with the plain C interface below, bound by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CSPN_FWD_GEOMETRIES
#error "CSPN_FWD_GEOMETRIES(G) undefined: build with ops/cspn_cuda.py"
#endif

namespace {

enum Norm { kSum = 0, kSumAbs = 1, kSumClamp = 2 };

// Where a round's gates come from: K1/K2's raw guidance (kRaw), the same
// while also writing the interior's gates9 for later rounds (kRawToGates),
// or gates9 planes (kGates: K7/K8, and a raw call after its first round).
enum Src { kRaw = 0, kRawToGates = 1, kGates = 2 };

// A block owns a TILE x TILE interior of a SLAB x SLAB slab; each of its
// THREADS owns RUN rows of one slab column. MINB: blocks per SM the
// registers are capped for (__launch_bounds__).
template <int TILE_, int HALO_, int RUN_, int MINB_>
struct Geometry {
  static constexpr int TILE = TILE_, HALO = HALO_, RUN = RUN_, MINB = MINB_;
  static constexpr int SLAB = TILE + 2 * HALO;
  static constexpr int PITCH = SLAB + 2;          // one-pixel zero apron
  static constexpr int THREADS = SLAB * (SLAB / RUN);
  static_assert(SLAB % RUN == 0, "runs must tile a slab column");
  static_assert(HALO >= 4, "K7/K8's rounds of r <= 4 must be one launch");
  static_assert(RUN <= 32, "a run's interior mask is one 32-bit word");
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
  static_assert(2 * PITCH * PITCH * 4 <= 48 * 1024, "static shared memory");
};

// One round on one slab: `guid` is the raw guidance (B, 8, H, W) for kRaw
// and kRawToGates, else gates9 (B, 9, H, W) = [g0, g_1..8]. kRawToGates
// writes the interior's gates9 to gates_out (contiguous (B, 9, H, W));
// STASH writes d^(t0 + t) of the interior to stash[b, t0 + t] of a
// contiguous (B, T, H, W) array. anchor_load puts the sparse points into d
// as it is loaded (d^0's anchor).
template <int SRC, bool STASH, class G>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
cspn_fwd_round(const float* __restrict__ guid, int64_t guid_bstride,
               const float* __restrict__ d_in, int64_t d_in_bstride,
               const float* __restrict__ sparse, int64_t sp_bstride,
               float* __restrict__ d_out, float* __restrict__ gates_out,
               float* __restrict__ stash, int T, int t0,
               int H, int W, int iters, int norm, bool anchor_load) {
  constexpr int TILE = G::TILE, HALO = G::HALO, RUN = G::RUN;
  constexpr int SLAB = G::SLAB, PITCH = G::PITCH;
  __shared__ float buf[2][PITCH * PITCH];

  const int b = blockIdx.z;
  const int x = threadIdx.x % SLAB;                // slab column
  const int ry = (threadIdx.x / SLAB) * RUN;       // slab row of pixel 0
  const int gx = blockIdx.x * TILE - HALO + x;
  const int gy0 = blockIdx.y * TILE - HALO + ry;
  const int64_t plane = (int64_t)H * W;
  const float* g = guid + b * guid_bstride;
  const float* din = d_in + b * d_in_bstride;
  const float* sp = sparse ? sparse + b * sp_bstride : nullptr;
  float* dout = d_out + b * plane;

  // Zero the apron ring of both buffers; every slab pixel is written below.
  for (int i = threadIdx.x; i < 4 * PITCH - 4; i += G::THREADS) {
    int o;
    if (i < PITCH) {
      o = i;
    } else if (i < 2 * PITCH) {
      o = (PITCH - 1) * PITCH + i - PITCH;
    } else {
      const int k = i - 2 * PITCH;
      o = (1 + k / 2) * PITCH + (k % 2 ? PITCH - 1 : 0);
    }
    buf[0][o] = 0.0f;
    buf[1][o] = 0.0f;
  }

  const bool col_in = gx >= 0 && gx < W;
  const bool col_interior = col_in && x >= HALO && x < HALO + TILE;
  const int o0 = (ry + 1) * PITCH + x + 1;   // shared offset of pixel 0
  const int base = gy0 * W + gx;             // plane index of pixel 0
  float gate[RUN][9];   // [0] = centre, [1..8] = NEIGHBOR_OFFSETS order
  float anc[RUN];       // NaN: free; else the value the pixel is held to
  float c[RUN];         // this thread's d values, the slab's column x
  unsigned interior = 0;   // bit j: pixel j is in the image and the interior
  const float floor_ = norm == kSumClamp ? 1.0f : 1e-8f;

#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int gy = gy0 + j;
    const int idx = base + j * W;
    const bool inside = col_in && gy >= 0 && gy < H;
    if (col_interior && gy < H && ry + j >= HALO && ry + j < HALO + TILE)
      interior |= 1u << j;
    float d = 0.0f;
    anc[j] = 0.0f;
    if (inside) {
      if constexpr (SRC == kGates) {
#pragma unroll
        for (int k = 0; k < 9; ++k) gate[j][k] = g[k * plane + idx];
      } else {
        float a[8];
        float abs_sum = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          a[k] = g[k * plane + idx];
          if (norm == kSumAbs) a[k] = fabsf(a[k]);
          abs_sum += fabsf(a[k]);
        }
        const float den = fmaxf(abs_sum, floor_);
        float gsum = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          gate[j][k + 1] = a[k] / den;
          gsum += gate[j][k + 1];
        }
        gate[j][0] = 1.0f - gsum;
      }
      d = din[idx];
      const float s = sp ? sp[idx] : 0.0f;
      anc[j] = s > 0.0f ? s : __int_as_float(0x7fc00000);   // NaN
      if (anchor_load && s > 0.0f) d = s;
    } else {
      // Outside the image: all gates 0 and held to 0, so d stays exactly 0
      // even next to a non-finite neighbour (0 * inf is NaN).
#pragma unroll
      for (int k = 0; k < 9; ++k) gate[j][k] = 0.0f;
    }
    c[j] = d;
    buf[0][o0 + j * PITCH] = d;
  }
  if constexpr (SRC == kRawToGates) {
    float* go = gates_out + b * 9 * plane;
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (interior >> j & 1u) {
#pragma unroll
        for (int k = 0; k < 9; ++k) go[k * plane + base + j * W] = gate[j][k];
      }
  }
  // The stash: pixel 0's element of stash[b, t0 + t], advanced a plane an
  // iteration.
  float* st = STASH ? stash + ((int64_t)b * T + t0) * plane + base : nullptr;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < iters; ++t) {
    const float* dc = buf[cur] + o0;
    float* dn = buf[cur ^ 1] + o0;
    // Rolling window of the left (l), own (m) and right (r) columns: rows
    // j - 1, j, j + 1 of the run; the own column comes from registers.
    float l0 = dc[-PITCH - 1], l1 = dc[-1];
    float r0 = dc[-PITCH + 1], r1 = dc[1];
    float m0 = dc[-PITCH];
    const float below = dc[RUN * PITCH];
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const float l2 = dc[(j + 1) * PITCH - 1];
      const float r2 = dc[(j + 1) * PITCH + 1];
      const float m1 = c[j];
      const float m2 = j + 1 < RUN ? c[j + 1] : below;
      if (STASH && (interior >> j & 1u))
        st[j * W] = m1;   // d^t
      float v = gate[j][0] * m1;
      v = fmaf(gate[j][1], l0, v);
      v = fmaf(gate[j][2], m0, v);
      v = fmaf(gate[j][3], r0, v);
      v = fmaf(gate[j][4], l1, v);
      v = fmaf(gate[j][5], r1, v);
      v = fmaf(gate[j][6], l2, v);
      v = fmaf(gate[j][7], m2, v);
      v = fmaf(gate[j][8], r2, v);
      c[j] = isnan(anc[j]) ? v : anc[j];
      dn[j * PITCH] = c[j];
      l0 = l1, l1 = l2, r0 = r1, r1 = r2, m0 = m1;
    }
    __syncthreads();
    cur ^= 1;
    if constexpr (STASH) st += plane;
  }

#pragma unroll
  for (int j = 0; j < RUN; ++j)
    if (interior >> j & 1u) dout[base + j * W] = c[j];
}

// One forward call: the inputs and the outputs.
struct Call {
  const float* guid;   // raw guidance (B, 8, H, W) or gates9 (B, 9, H, W)
  int64_t guid_bstride;
  const float* d0;
  int64_t d0_bstride;
  const float* sparse;
  int64_t sp_bstride;
  float* out;
  float* scratch;      // d's ping-pong partner; used when rounds > 1
  float* gates9;       // a raw call's gates9 scratch; used when rounds > 1
  float* stash;        // the stash entries', else null
  int B, H, W, T, norm;
  bool prenorm;        // K7/K8
  bool anchor0;        // K7/K8: anchor d^0 on load
  cudaStream_t stream;
};

template <int SRC, class G>
cudaError_t launch_round(const Call& c, const float* g, int64_t g_bstride,
                         const float* src, int64_t src_bstride, float* dst,
                         float* gates_out, int t0, int iters) {
  const dim3 grid((c.W + G::TILE - 1) / G::TILE,
                  (c.H + G::TILE - 1) / G::TILE, c.B);
  // d^0's anchor: the first round of a raw call, or of K7/K8 on request.
  const bool anchor_load = t0 == 0 && (SRC != kGates || c.anchor0);
  if (c.stash)
    cspn_fwd_round<SRC, true, G><<<grid, G::THREADS, 0, c.stream>>>(
        g, g_bstride, src, src_bstride, c.sparse, c.sp_bstride, dst,
        gates_out, c.stash, c.T, t0, c.H, c.W, iters, c.norm, anchor_load);
  else
    cspn_fwd_round<SRC, false, G><<<grid, G::THREADS, 0, c.stream>>>(
        g, g_bstride, src, src_bstride, c.sparse, c.sp_bstride, dst,
        gates_out, nullptr, c.T, t0, c.H, c.W, iters, c.norm, anchor_load);
  return cudaGetLastError();
}

template <class G>
int launch_rounds(const Call& c) {
  const int rounds = c.T == 0 ? 1 : (c.T + G::HALO - 1) / G::HALO;
  const int64_t plane = (int64_t)c.H * c.W;
  const bool to_gates = !c.prenorm && rounds > 1;
  if (to_gates && !c.gates9) return (int)cudaErrorInvalidValue;
  const float* src = c.d0;
  int64_t src_bstride = c.d0_bstride;
  for (int r = 0; r < rounds; ++r) {
    // The last round writes `out`; earlier rounds alternate backwards.
    float* dst = ((rounds - 1 - r) % 2 == 0) ? c.out : c.scratch;
    const int t0 = r * G::HALO;
    const int iters = c.T - t0 < G::HALO ? c.T - t0 : G::HALO;
    cudaError_t err;
    if (c.prenorm) {
      err = launch_round<kGates, G>(c, c.guid, c.guid_bstride, src,
                                    src_bstride, dst, nullptr, t0, iters);
    } else if (r > 0) {
      err = launch_round<kGates, G>(c, c.gates9, 9 * plane, src, src_bstride,
                                    dst, nullptr, t0, iters);
    } else if (to_gates) {
      err = launch_round<kRawToGates, G>(c, c.guid, c.guid_bstride, src,
                                         src_bstride, dst, c.gates9, t0,
                                         iters);
    } else {
      err = launch_round<kRaw, G>(c, c.guid, c.guid_bstride, src,
                                  src_bstride, dst, nullptr, t0, iters);
    }
    if (err != cudaSuccess) return (int)err;
    src = dst;
    src_bstride = plane;
  }
  return (int)cudaSuccess;
}

// Geometry i of CSPN_FWD_GEOMETRIES runs Geometry<i's TILE, HALO, RUN, MINB>.
int launch(const Call& c, int geometry) {
  int i = 0;
#define CSPN_FWD_GEOMETRY(TILE, HALO, RUN, MINB) \
  if (geometry == i++)                           \
    return launch_rounds<Geometry<TILE, HALO, RUN, MINB>>(c);
  CSPN_FWD_GEOMETRIES(CSPN_FWD_GEOMETRY)
#undef CSPN_FWD_GEOMETRY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The raw contract (K1, and K4 through its own wrapper). guid: (B, 8, H, W)
// planes, batch stride guid_bstride (elements); blur, sparse: (B, H, W),
// batch strides blur_bstride, sp_bstride; sparse may be null (no anchors).
// out, scratch: contiguous (B, H, W); gates9: contiguous (B, 9, H, W).
// scratch and gates9 are used only when T exceeds the geometry's HALO
// (either may otherwise be null). Launches ceil(T / HALO) rounds (one for
// T = 0), each over the whole batch, with tile geometry `geometry` (an
// index of CSPN_FWD_GEOMETRIES), on `stream`, and returns
// cudaGetLastError() of the first failing launch.
int cspn_fwd(const float* guid, int64_t guid_bstride,
             const float* blur, int64_t blur_bstride,
             const float* sparse, int64_t sp_bstride,
             float* out, float* scratch, float* gates9,
             int B, int H, int W, int T, int norm, int geometry,
             void* stream) {
  return launch({guid, guid_bstride, blur, blur_bstride, sparse, sp_bstride,
                 out, scratch, gates9, nullptr, B, H, W, T, norm, false,
                 false, (cudaStream_t)stream}, geometry);
}

// As cspn_fwd, and also writes d^t, the plane iteration t starts from, to
// stash[b, t] of a contiguous (B, T, H, W) array (K2, K5).
int cspn_fwd_stash(const float* guid, int64_t guid_bstride,
                   const float* blur, int64_t blur_bstride,
                   const float* sparse, int64_t sp_bstride,
                   float* out, float* scratch, float* gates9, float* stash,
                   int B, int H, int W, int T, int norm, int geometry,
                   void* stream) {
  return launch({guid, guid_bstride, blur, blur_bstride, sparse, sp_bstride,
                 out, scratch, gates9, stash, B, H, W, T, norm, false, false,
                 (cudaStream_t)stream}, geometry);
}

// K7: gates9 (B, 9, H, W) prenormalized planes [g0, g_1..8], batch stride
// g_bstride; d0 (B, H, W), batch stride d0_bstride, taken as given, or
// anchored on load where anchor0 is non-zero; sparse and the rest as in
// cspn_fwd. The gates are 0 outside the image, so the zero border stays
// exactly 0. On one rank's halo'd slab (its H rows, halo rows included)
// T is the round's r <= k iterations: one launch for r <= HALO, which is
// at least 4.
int cspn_prenorm_fwd(const float* gates9, int64_t g_bstride,
                     const float* d0, int64_t d0_bstride,
                     const float* sparse, int64_t sp_bstride,
                     float* out, float* scratch,
                     int B, int H, int W, int T, int anchor0, int geometry,
                     void* stream) {
  return launch({gates9, g_bstride, d0, d0_bstride, sparse, sp_bstride, out,
                 scratch, nullptr, nullptr, B, H, W, T, 0, true,
                 anchor0 != 0, (cudaStream_t)stream}, geometry);
}

// K8: K7 that also writes d^t to stash[b, t] of a contiguous (B, T, H, W)
// array; its output is K7's bit for bit.
int cspn_prenorm_fwd_stash(const float* gates9, int64_t g_bstride,
                           const float* d0, int64_t d0_bstride,
                           const float* sparse, int64_t sp_bstride,
                           float* out, float* scratch, float* stash,
                           int B, int H, int W, int T, int anchor0,
                           int geometry, void* stream) {
  return launch({gates9, g_bstride, d0, d0_bstride, sparse, sp_bstride, out,
                 scratch, nullptr, stash, B, H, W, T, 0, true, anchor0 != 0,
                 (cudaStream_t)stream}, geometry);
}

const char* cspn_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
