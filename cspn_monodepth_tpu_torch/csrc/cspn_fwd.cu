// CSPN forward propagation on Hopper (sm_90a): affinity normalization,
// d^0 anchoring and T iterations of the 8-neighbour gather stencil with
// per-iteration sparse re-anchoring. Six C entries share one kernel,
// templated on the contract:
//   cspn_fwd        (K1) the eval and serving forward of raw guidance;
//   cspn_fwd_stash  (K2) the training forward, which also writes every
//                   pre-iteration plane d^t to a (B, T, H, W) stash that the
//                   adjoint (csrc/cspn_bwd.cu) reads back in reverse;
//   cspn_tiled_fwd, cspn_tiled_fwd_stash  (K4, K5) the same two on the
//                   prenormalized contract of the H-tiled route: nine gate
//                   planes (B, 9, H, W), centre first, read as they are (no
//                   normalization), and d^0 taken as given (the caller
//                   anchors it); the anchor still follows every iteration;
//   cspn_prenorm_fwd, cspn_prenorm_fwd_stash  (K7, K8) the same two on one
//                   rank's halo'd slab of the spatially sharded CSPN
//                   (parallel/halo.py): the prenormalized contract again, on
//                   an (H/S + 2k)-row slab for one round of r <= k
//                   iterations. The slab's halo rows are its neighbours'
//                   rows, copied in by the caller (zero rows on the first
//                   and last shard); to the kernel they are image rows like
//                   any other, and the zero border lies outside the slab, as
//                   in the TPU kernel's padded plane.
//
// Replaces: cspn_monodepth_tpu/ops/cspn_pallas.py:_cspn_kernel (launched by
// _cspn_pallas_fwd_impl) and _cspn_kernel_stash (launched by
// _cspn_pallas_stash_fwd), the whole-plane TPU kernels, and
// _cspn_tiled_kernel (launched by _tiled_launch) and
// _cspn_tiled_stash_kernel (launched by _tiled_stash_launch), the H-tiled
// ones, and _cspn_prenorm_kernel (launched by _cspn_prenorm_fwd_impl) and
// _cspn_prenorm_stash_kernel (launched by _cspn_prenorm_stash_fwd), the
// spatial path's slab kernels. They compute the same functions; they do not copy the TPU layout
// (the TPU tiles H only, pads W to 128 lanes and stashes each tile's
// interior +-1 rows; here the 2-D tiles below serve both routes, and the
// stash is the plain (B, T, H, W) array).
// The TPU kernel keeps a whole plane and 9 gate planes resident in VMEM; one
// 228x304 f32 plane is 277 KB and a Hopper block has at most 227 KB of
// shared memory, so here the plane is cut into tiles instead.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function must read
// the 8 guidance planes, blur and sparse once and write the result once,
// 44 B/px. At B=32 x 228x304 that is 97.6 MB, about 29 us; at B=1 about
// 0.9 us, so a single image is launch-bound. The arithmetic, 19 flop/px per
// iteration plus the normalization, is far below the f32 rate: the kernel
// is bound by bytes. K2 writes T more planes: (11 + T) * 4 B/px, 310.5 MB
// at B=32, T=24, about 93 us. K4 reads nine gate planes instead of eight:
// 48 B/px, 164.4 MB at KITTI's B=8 x 352x1216, about 49 us; K5 adds the
// T stash planes, 493.1 MB, about 147 us. K7 on KITTI's 2x4 slab (B=4 images
// of 96x1216, one round of 4 iterations) moves 12 planes, 22.4 MB, about
// 6.7 us; K8 16 planes, about 8.9 us: a few microseconds of launch latency
// are a large part of such a call.
// The TPU kernel keeps the whole slab in VMEM; a 96x1216 f32 plane is 467 KB,
// twice a Hopper block's shared memory, so the slab is tiled like a plane.
//
// Design (simple first; making it fast is later work):
// * Recompute-in-halo tiles. A block owns a TILE x TILE interior and loads
//   a SLAB x SLAB slab around it (HALO = iterations per round on each
//   side). It runs up to HALO iterations on the slab; values within r
//   pixels of the slab edge go stale after r iterations, so the interior
//   stays exact and is written out. The host loop launches ceil(T/HALO)
//   rounds, ping-ponging d between `out` and `scratch`, so device-memory
//   traffic is ~11 planes per round instead of per iteration.
// * Gates live in registers: each thread owns PPT fixed slab pixels,
//   normalizes their 8 raw affinities once per round into 9 gates (K4/K5
//   read the 9 gates as they are) and keeps them with the pixel's anchor
//   for all iterations. Only d is in
//   shared memory, as a ping-pong pair with a zero apron, so the block
//   needs 14 KB of static shared memory (no opt-in above 48 KB).
// * Zero border at the image edge only: slab pixels outside the image
//   get d = 0, all nine gates 0 and an anchor of 0, so they stay exactly
//   0. A tile edge inside the image is covered by the halo, never zeroed.
// * K1/K2: d^0 is anchored before the first iteration. Every round
//   re-anchors d on load, which is idempotent for a d that the previous
//   round already anchored. K4/K5 never anchor on load: d^0 comes anchored
//   by the caller, and every later round loads planes that the previous
//   round's last iteration anchored. The mask is sparse > 0.
// * Stash (K2, K5): at the start of each iteration every block writes its
//   tile's interior of d^t. The interior is exact at every iteration of a
//   round, and the interiors tile the image, so the stash is exact; K2's
//   output is K1's (K5's is K4's) bit for bit: the same code with one more
//   store. H and W need not be multiples of the tile.
// * Strides: each plane is contiguous (row stride W), the guidance planes
//   of one image are H*W apart, and every input takes its own batch
//   stride, so the model's head output (B, 9, H, W) is passed as
//   guidance = heads[:, 1:] and blur = heads[:, 0] without a copy.
//
// Built by ops/cspn_cuda.py with nvcc -gencode arch=compute_90a,code=sm_90a
// into a shared library with the plain C interface below, bound by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;                    // interior edge
constexpr int HALO = 4;                     // iterations per round
constexpr int SLAB = TILE + 2 * HALO;       // 40
constexpr int PITCH = SLAB + 2;             // one-pixel zero apron
constexpr int THREADS = 320;
constexpr int PPT = SLAB * SLAB / THREADS;  // slab pixels per thread
static_assert(PPT * THREADS == SLAB * SLAB, "threads must tile the slab");

enum Norm { kSum = 0, kSumAbs = 1, kSumClamp = 2 };

// PRENORM false: K1/K2, raw guidance (B, 8, H, W) normalized per `norm`.
// PRENORM true: K4/K5, gates (B, 9, H, W) = [g0, g_1..8]; `norm` unused.
template <bool PRENORM>
__global__ void __launch_bounds__(THREADS)
cspn_fwd_round(const float* __restrict__ guid, int64_t guid_bstride,
               const float* __restrict__ d_in, int64_t d_in_bstride,
               const float* __restrict__ sparse, int64_t sp_bstride,
               float* __restrict__ d_out,
               float* __restrict__ stash, int T, int t0,
               int H, int W, int iters, int norm) {
  __shared__ float buf[2][PITCH * PITCH];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE - HALO;
  const int x0 = blockIdx.x * TILE - HALO;
  const int64_t plane = (int64_t)H * W;
  const float* g = guid + b * guid_bstride;
  const float* din = d_in + b * d_in_bstride;
  const float* sp = sparse ? sparse + b * sp_bstride : nullptr;
  float* dout = d_out + b * plane;
  // stash[b, t] is plane b * T + t of a contiguous (B, T, H, W) array.
  float* st = stash ? stash + ((int64_t)b * T + t0) * plane : nullptr;
  const float floor_ = norm == kSumClamp ? 1.0f : 1e-8f;

  for (int i = threadIdx.x; i < 2 * PITCH * PITCH; i += THREADS)
    (&buf[0][0])[i] = 0.0f;
  __syncthreads();

  float gate[PPT][9];   // [0] = centre, [1..8] = NEIGHBOR_OFFSETS order
  float anchor[PPT];
  bool anchored[PPT];
  int off[PPT];
  int64_t gidx[PPT];    // -1 outside the image
  bool interior[PPT];   // inside the image and in the tile's interior

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    const int y = p / SLAB, x = p % SLAB;
    const int gy = y0 + y, gx = x0 + x;
    off[i] = (y + 1) * PITCH + (x + 1);
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    gidx[i] = inside ? (int64_t)gy * W + gx : -1;
    interior[i] = inside && y >= HALO && y < HALO + TILE && x >= HALO &&
                  x < HALO + TILE;
    float d = 0.0f;
    anchor[i] = 0.0f;
    anchored[i] = false;
    if (inside) {
      const int64_t idx = gidx[i];
      if constexpr (PRENORM) {
#pragma unroll
        for (int k = 0; k < 9; ++k) gate[i][k] = g[k * plane + idx];
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
          gate[i][k + 1] = a[k] / den;
          gsum += gate[i][k + 1];
        }
        gate[i][0] = 1.0f - gsum;
      }
      d = din[idx];
      if (sp) {
        anchor[i] = sp[idx];
        anchored[i] = anchor[i] > 0.0f;
        if (!PRENORM && anchored[i]) d = anchor[i];
      }
    } else {
      // Outside the image: all gates 0 and anchored to 0, so d stays
      // exactly 0 even next to a non-finite neighbour (0 * inf is NaN).
#pragma unroll
      for (int k = 0; k < 9; ++k) gate[i][k] = 0.0f;
      anchored[i] = true;
    }
    buf[0][off[i]] = d;
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < iters; ++t) {
    const float* dc = buf[cur];
    float* dn = buf[cur ^ 1];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int o = off[i];
      if (st && interior[i]) st[t * plane + gidx[i]] = dc[o];   // d^t
      float v = gate[i][0] * dc[o];
      v = fmaf(gate[i][1], dc[o - PITCH - 1], v);
      v = fmaf(gate[i][2], dc[o - PITCH], v);
      v = fmaf(gate[i][3], dc[o - PITCH + 1], v);
      v = fmaf(gate[i][4], dc[o - 1], v);
      v = fmaf(gate[i][5], dc[o + 1], v);
      v = fmaf(gate[i][6], dc[o + PITCH - 1], v);
      v = fmaf(gate[i][7], dc[o + PITCH], v);
      v = fmaf(gate[i][8], dc[o + PITCH + 1], v);
      dn[o] = anchored[i] ? anchor[i] : v;
    }
    __syncthreads();
    cur ^= 1;
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i)
    if (interior[i]) dout[gidx[i]] = buf[cur][off[i]];
}

template <bool PRENORM>
int launch_rounds(const float* guid, int64_t guid_bstride,
                  const float* blur, int64_t blur_bstride,
                  const float* sparse, int64_t sp_bstride,
                  float* out, float* scratch, float* stash,
                  int B, int H, int W, int T, int norm, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  const int rounds = T == 0 ? 1 : (T + HALO - 1) / HALO;
  const int64_t plane = (int64_t)H * W;
  const float* src = blur;
  int64_t src_bstride = blur_bstride;
  for (int r = 0; r < rounds; ++r) {
    // The last round writes `out`; earlier rounds alternate backwards.
    float* dst = ((rounds - 1 - r) % 2 == 0) ? out : scratch;
    const int iters = T - r * HALO < HALO ? T - r * HALO : HALO;
    cspn_fwd_round<PRENORM><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        guid, guid_bstride, src, src_bstride, sparse, sp_bstride, dst,
        stash, T, r * HALO, H, W, iters, norm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
    src_bstride = plane;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// guid: (B, 8, H, W) planes, batch stride guid_bstride (elements);
// blur, sparse: (B, H, W), batch strides blur_bstride, sp_bstride; sparse
// may be null (no anchors). out, scratch: contiguous (B, H, W); scratch is
// used only when T > HALO. Launches ceil(T / HALO) rounds (one for T = 0)
// on `stream` and returns cudaGetLastError() of the first failing launch.
int cspn_fwd(const float* guid, int64_t guid_bstride,
             const float* blur, int64_t blur_bstride,
             const float* sparse, int64_t sp_bstride,
             float* out, float* scratch,
             int B, int H, int W, int T, int norm, void* stream) {
  return launch_rounds<false>(guid, guid_bstride, blur, blur_bstride,
                              sparse, sp_bstride, out, scratch, nullptr, B,
                              H, W, T, norm, stream);
}

// As cspn_fwd, and also writes d^t, the plane iteration t starts from, to
// stash[b, t] of a contiguous (B, T, H, W) array (K2).
int cspn_fwd_stash(const float* guid, int64_t guid_bstride,
                   const float* blur, int64_t blur_bstride,
                   const float* sparse, int64_t sp_bstride,
                   float* out, float* scratch, float* stash,
                   int B, int H, int W, int T, int norm, void* stream) {
  return launch_rounds<false>(guid, guid_bstride, blur, blur_bstride,
                              sparse, sp_bstride, out, scratch, stash, B, H,
                              W, T, norm, stream);
}

// K4: gates9 (B, 9, H, W) prenormalized planes [g0, g_1..8], batch stride
// g_bstride; d0 (B, H, W), already anchored by the caller, batch stride
// d0_bstride; sparse and the rest as in cspn_fwd. The gates are 0 outside
// the image, so the zero border stays exactly 0.
int cspn_tiled_fwd(const float* gates9, int64_t g_bstride,
                   const float* d0, int64_t d0_bstride,
                   const float* sparse, int64_t sp_bstride,
                   float* out, float* scratch,
                   int B, int H, int W, int T, void* stream) {
  return launch_rounds<true>(gates9, g_bstride, d0, d0_bstride, sparse,
                             sp_bstride, out, scratch, nullptr, B, H, W, T,
                             0, stream);
}

// K5: as cspn_tiled_fwd, and also writes d^t to stash[b, t] of a
// contiguous (B, T, H, W) array; its output is K4's bit for bit.
int cspn_tiled_fwd_stash(const float* gates9, int64_t g_bstride,
                         const float* d0, int64_t d0_bstride,
                         const float* sparse, int64_t sp_bstride,
                         float* out, float* scratch, float* stash,
                         int B, int H, int W, int T, void* stream) {
  return launch_rounds<true>(gates9, g_bstride, d0, d0_bstride, sparse,
                             sp_bstride, out, scratch, stash, B, H, W, T, 0,
                             stream);
}

// K7: cspn_tiled_fwd's contract on one rank's halo'd slab (gates9, d0 and
// sparse of the slab's H rows, halo rows included), T = the round's r <= k
// iterations: one launch for r <= HALO.
int cspn_prenorm_fwd(const float* gates9, int64_t g_bstride,
                     const float* d0, int64_t d0_bstride,
                     const float* sparse, int64_t sp_bstride,
                     float* out, float* scratch,
                     int B, int H, int W, int T, void* stream) {
  return launch_rounds<true>(gates9, g_bstride, d0, d0_bstride, sparse,
                             sp_bstride, out, scratch, nullptr, B, H, W, T,
                             0, stream);
}

// K8: K7 that also writes d^t to stash[b, t] of a contiguous (B, T, H, W)
// array; its output is K7's bit for bit.
int cspn_prenorm_fwd_stash(const float* gates9, int64_t g_bstride,
                           const float* d0, int64_t d0_bstride,
                           const float* sparse, int64_t sp_bstride,
                           float* out, float* scratch, float* stash,
                           int B, int H, int W, int T, void* stream) {
  return launch_rounds<true>(gates9, g_bstride, d0, d0_bstride, sparse,
                             sp_bstride, out, scratch, stash, B, H, W, T, 0,
                             stream);
}

const char* cspn_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
