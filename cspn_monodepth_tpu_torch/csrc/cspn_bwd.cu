// CSPN adjoint on Hopper (sm_90a): the gradients of the propagation of
// csrc/cspn_fwd.cu, from the output's cotangent and the stash of every
// pre-iteration plane d^t that the stash forward wrote. One kernel,
// templated on the contract, behind three C entries:
//   cspn_bwd        (K3) with respect to the raw guidance, the blur depth
//                   and the sparse depth, the chain rule of the affinity
//                   normalization included (stash of K2);
//   cspn_tiled_bwd  (K6) the prenormalized contract of the H-tiled route
//                   (stash of K5): with respect to the nine gate planes
//                   (B, 9, H, W), [G_0, G_1..8], and to d^0 (lam^0, no anchor
//                   mask), and the sparse sum sum_t m lam^{t+1} of the
//                   per-iteration anchors. No chain rule: the caller's
//                   autograd of the normalization and of d^0's anchoring
//                   supplies it;
//   cspn_prenorm_bwd (K9) K6's contract on one rank's halo'd slab of the
//                   spatially sharded CSPN (stash of K8, one round of r <= k
//                   iterations): the slab's halo rows are image rows to it.
//
// Replaces: cspn_monodepth_tpu/ops/cspn_pallas.py:_cspn_bwd_kernel
// (launched by _cspn_pallas_bwd_impl), the whole-plane TPU adjoint of the
// training step (K3), and _cspn_tiled_bwd_kernel (launched by
// _tiled_bwd_launch), the H-tiled one (K6), and _cspn_prenorm_bwd_kernel
// (launched by _cspn_prenorm_bwd_impl), the spatial path's slab adjoint
// (K9). They compute the same
// functions; they do not copy the TPU layout, which keeps ~28 planes of one
// image (K3) or of one row tile (K6) resident in VMEM.
//
// The function, with lam = dL/dd^{t+1}, m = [sparse > 0] and t = T-1 .. 0:
//   lam_u = (1 - m) lam;  d_sparse += m lam;
//   G_k(j) += lam_u(j) d^t(j + off_k);  G_0(j) += lam_u(j) d^t(j);
//   lam(j) <- g0(j) lam_u(j) + sum_k g_k'(j + off_k) lam_u(j + off_k),
// where off_k' = -off_k (the transposed stencil, written as a gather);
// then d_blur = (1 - m) lam^0, d_sparse += m lam^0, and the chain rule of
// the affinity normalization (ops/cspn_ref.py:cspn_bwd_plain).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function must read
// the 8 guidance planes, sparse, the cotangent and the T stash planes once
// and write the 8 guidance gradients, d_blur and d_sparse once: (22 + T) * 4
// B/px, 390.4 MB at B=32, 228x304, T=24, about 117 us. Its ~40 flop/px per
// iteration are far below the f32 rate: bound by bytes. K6 reads 9 gate
// planes, sparse, the cotangent and the stash and writes 9 gate gradients,
// lam^0 and the sparse sum: (23 + T) * 4 B/px, 630.1 MB at KITTI's B=8 x
// 352x1216, T=24, about 188 us. K9 on KITTI's 2x4 slab (B=4 images of
// 96x1216, r=4) moves 22 + r = 26 planes, 48.6 MB, about 14.5 us.
//
// Design (simple first; making it fast is later work):
// * The same recompute-in-halo tiles as the forward, in reverse. A block
//   owns a TILE x TILE interior and loads lam on a SLAB x SLAB slab around
//   it; the adjoint stencil, like the forward one, moves information one
//   pixel per iteration, so after HALO reverse iterations the interior is
//   still exact. The host launches the forward's rounds in reverse order,
//   ping-ponging lam between two planes.
// * Gates of the whole slab are needed (the gather reads neighbours'
//   gates), so the 8 normalized gate planes live in shared memory with a
//   zero apron: with g0, lam_u and the d^t window the block takes 74.5 KB
//   of dynamic shared memory (opted in above the 48 KB default). d^t is
//   read only on the interior and a one-pixel ring.
// * Each pixel's gradient sums are owned by the one block whose interior
//   holds it: kept in registers within a round and added to device memory
//   once per round (the first round stores, later rounds read-modify-write,
//   the last one applies the chain rule and writes d_guid, d_blur and
//   d_sparse). No atomics, so the result is deterministic. K3: G_k
//   accumulates in d_guid itself, G_0 in a scratch plane; K6: G_0 and G_k
//   in the nine planes of d_gates9, which its last round leaves as they are.
// * K6 reads g0 from gate plane 0 instead of recomputing it; outside the
//   image every gate, g0 included, is 0 (the apron and unread pixels).
// * The image border: slab pixels outside the image have all gates 0 and
//   are masked like anchors, so lam there stays 0 and nothing flows back
//   from outside; d^t outside the image is 0, as in the forward.
//
// Built by ops/cspn_cuda.py with nvcc -gencode arch=compute_90a,code=sm_90a
// into a shared library with the plain C interface below, bound by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;                     // interior edge
constexpr int HALO = 4;                      // iterations per round
constexpr int SLAB = TILE + 2 * HALO;        // 40
constexpr int PITCH = SLAB + 2;              // one-pixel zero apron
constexpr int APRON = PITCH * PITCH;
constexpr int SLAB_PX = SLAB * SLAB;
constexpr int RING = TILE + 2;               // interior plus one pixel
constexpr int THREADS = 256;
constexpr int SPT = (SLAB_PX + THREADS - 1) / THREADS;   // slab px / thread
constexpr int IPT = TILE * TILE / THREADS;                // interior px / thread
static_assert(IPT * THREADS == TILE * TILE, "threads must tile the interior");
// Shared memory, in floats: gates[8][APRON], g0[SLAB_PX], lam_u[APRON],
// dt[RING * RING].
constexpr int SMEM_FLOATS = 8 * APRON + SLAB_PX + APRON + RING * RING;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

enum Norm { kSum = 0, kSumAbs = 1, kSumClamp = 2 };

// (dy, dx) of the 8 neighbours, ops/cspn_ref.py:NEIGHBOR_OFFSETS order.
__constant__ int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

// PRENORM false: K3 (guid = raw (B, 8, H, W), d_guid (B, 8, H, W), g0_acc
// a scratch plane, d_blur). PRENORM true: K6 (guid = gates9 (B, 9, H, W),
// d_guid = d_gates9 (B, 9, H, W), g0_acc unused, d_blur receives lam^0).
template <bool PRENORM>
__global__ void __launch_bounds__(THREADS)
cspn_bwd_round(const float* __restrict__ guid, int64_t guid_bstride,
               const float* __restrict__ sparse, int64_t sp_bstride,
               const float* __restrict__ lam_in, int64_t lam_bstride,
               const float* __restrict__ stash, int T, int t_lo, int iters,
               float* __restrict__ lam_out,
               float* __restrict__ d_guid, float* __restrict__ g0_acc,
               float* __restrict__ d_blur, float* __restrict__ d_sparse,
               int H, int W, int norm, bool first, bool last) {
  extern __shared__ float smem[];
  float* gate = smem;                       // [8][APRON]
  float* g0 = gate + 8 * APRON;             // [SLAB_PX]
  float* lu = g0 + SLAB_PX;                 // [APRON]
  float* dt = lu + APRON;                   // [RING * RING]

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE, tx0 = blockIdx.x * TILE;
  const int y0 = ty0 - HALO, x0 = tx0 - HALO;
  const int64_t plane = (int64_t)H * W;
  const float* g = guid + b * guid_bstride;
  const float* sp = sparse ? sparse + b * sp_bstride : nullptr;
  const float* lin = lam_in + b * lam_bstride;
  const float floor_ = norm == kSumClamp ? 1.0f : 1e-8f;

  for (int i = threadIdx.x; i < 8 * APRON; i += THREADS) gate[i] = 0.0f;
  for (int i = threadIdx.x; i < APRON; i += THREADS) lu[i] = 0.0f;
  __syncthreads();

  // Slab pixels of this thread: p = threadIdx.x + i * THREADS < SLAB_PX.
  float lam[SPT];
  float dsp[SPT];       // sum of m * lam over this round's iterations
  bool masked[SPT];     // lam_u = 0: an anchor, or outside the image
  bool anchor[SPT];     // an anchor inside the image (m = 1)
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    lam[i] = 0.0f;
    dsp[i] = 0.0f;
    masked[i] = true;
    anchor[i] = false;
    if (p >= SLAB_PX) continue;
    const int y = p / SLAB, x = p % SLAB;
    const int gy = y0 + y, gx = x0 + x;
    const int o = (y + 1) * PITCH + (x + 1);
    g0[p] = 0.0f;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    const int64_t idx = (int64_t)gy * W + gx;
    if constexpr (PRENORM) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        gate[k * APRON + o] = g[(k + 1) * plane + idx];
      g0[p] = g[idx];
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
        const float gk = a[k] / den;
        gate[k * APRON + o] = gk;
        gsum += gk;
      }
      g0[p] = 1.0f - gsum;
    }
    anchor[i] = sp && sp[idx] > 0.0f;
    masked[i] = anchor[i];
    lam[i] = lin[idx];
  }

  // Interior pixels of this thread: q = threadIdx.x + j * THREADS.
  float acc[IPT][9];    // [0..7] G_k, [8] G_0
#pragma unroll
  for (int j = 0; j < IPT; ++j)
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[j][k] = 0.0f;

  const float* st = stash + (int64_t)b * T * plane;
  for (int s = 0; s < iters; ++s) {
    const int t = t_lo + iters - 1 - s;
    const float* dplane = st + t * plane;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int p = threadIdx.x + i * THREADS;
      if (p >= SLAB_PX) continue;
      const int o = (p / SLAB + 1) * PITCH + (p % SLAB + 1);
      lu[o] = masked[i] ? 0.0f : lam[i];
      if (anchor[i]) dsp[i] += lam[i];
    }
    for (int e = threadIdx.x; e < RING * RING; e += THREADS) {
      const int gy = ty0 - 1 + e / RING, gx = tx0 - 1 + e % RING;
      dt[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? dplane[(int64_t)gy * W + gx] : 0.0f;
    }
    __syncthreads();

    // Gate gradients on the interior: G_k += lam_u * d^t(j + off_k).
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int q = threadIdx.x + j * THREADS;
      const int iy = q / TILE, ix = q % TILE;
      const float l = lu[(iy + HALO + 1) * PITCH + (ix + HALO + 1)];
      const int c = (iy + 1) * RING + (ix + 1);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[j][k] = fmaf(l, dt[c + kDy[k] * RING + kDx[k]], acc[j][k]);
      acc[j][8] = fmaf(l, dt[c], acc[j][8]);
    }

    // The adjoint stencil on the slab, as a gather over neighbours.
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int p = threadIdx.x + i * THREADS;
      if (p >= SLAB_PX) continue;
      const int o = (p / SLAB + 1) * PITCH + (p % SLAB + 1);
      float v = g0[p] * lu[o];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = o + kDy[k] * PITCH + kDx[k];
        v = fmaf(gate[(7 - k) * APRON + n], lu[n], v);   // k' = 7 - k
      }
      lam[i] = v;
    }
    __syncthreads();
  }

  // Slab pixels in the interior: lam^{t_lo} on, or the depth gradients.
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    if (p >= SLAB_PX) continue;
    const int y = p / SLAB, x = p % SLAB;
    const int gy = y0 + y, gx = x0 + x;
    if (y < HALO || y >= HALO + TILE || x < HALO || x >= HALO + TILE ||
        gy >= H || gx >= W)
      continue;
    const int64_t idx = b * plane + (int64_t)gy * W + gx;
    float ds = (first ? 0.0f : d_sparse[idx]) + dsp[i];
    if (last && PRENORM) {
      d_blur[idx] = lam[i];                 // K6: lam^0, unmasked
    } else if (last) {
      d_blur[idx] = anchor[i] ? 0.0f : lam[i];
      if (anchor[i]) ds += lam[i];
    } else {
      lam_out[idx] = lam[i];
    }
    d_sparse[idx] = ds;
  }

  // Interior gate sums: store, add, or finish with the chain rule.
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int q = threadIdx.x + j * THREADS;
    const int gy = ty0 + q / TILE, gx = tx0 + q % TILE;
    if (gy >= H || gx >= W) continue;
    const int64_t pix = (int64_t)gy * W + gx;
    // G_k at dg[k * plane], G_0 at *g0a.
    float* dg;
    float* g0a;
    if constexpr (PRENORM) {
      g0a = d_guid + b * 9 * plane + pix;
      dg = g0a + plane;
    } else {
      dg = d_guid + b * 8 * plane + pix;
      g0a = g0_acc + b * plane + pix;
    }
    if (!first) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[j][k] += dg[k * plane];
      acc[j][8] += *g0a;
    }
    if (PRENORM || !last) {
#pragma unroll
      for (int k = 0; k < 8; ++k) dg[k * plane] = acc[j][k];
      *g0a = acc[j][8];
      continue;
    }
    // Chain rule of gate_k = a_k / max(s, floor), s = sum |g_k| (a = g,
    // or |g| for 8sum_abs): Ghat_k = G_k - G_0, c1 = sum_k Ghat_k gate_k.
    float raw[8], a[8];
    float abs_sum = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      raw[k] = g[k * plane + pix];
      a[k] = norm == kSumAbs ? fabsf(raw[k]) : raw[k];
      abs_sum += fabsf(a[k]);
    }
    const float den = fmaxf(abs_sum, floor_);
    const float active = abs_sum > floor_ ? 1.0f : 0.0f;
    float c1 = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      c1 = fmaf(acc[j][k] - acc[j][8], a[k] / den, c1);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float ghat = acc[j][k] - acc[j][8];
      const float sgn = raw[k] > 0.0f ? 1.0f : (raw[k] < 0.0f ? -1.0f : 0.0f);
      dg[k * plane] = norm == kSumAbs ? sgn * (ghat - active * c1) / den
                                      : (ghat - sgn * (active * c1)) / den;
    }
  }
}

template <bool PRENORM>
int launch_rounds(const float* guid, int64_t guid_bstride,
                  const float* sparse, int64_t sp_bstride,
                  const float* grad_out, int64_t go_bstride,
                  const float* stash,
                  float* d_guid, float* d_blur, float* d_sparse,
                  float* g0_acc, float* lam_a, float* lam_b,
                  int B, int H, int W, int T, int norm, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cspn_bwd_round<PRENORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  const int rounds = T == 0 ? 1 : (T + HALO - 1) / HALO;
  const int64_t plane = (int64_t)H * W;
  const float* src = grad_out;
  int64_t src_bstride = go_bstride;
  for (int n = 0; n < rounds; ++n) {
    const int r = rounds - 1 - n;            // the forward's round, reversed
    const int t_lo = r * HALO;
    const int iters = T - t_lo < HALO ? T - t_lo : HALO;
    float* dst = n % 2 == 0 ? lam_a : lam_b;
    cspn_bwd_round<PRENORM>
        <<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
            guid, guid_bstride, sparse, sp_bstride, src, src_bstride, stash,
            T, t_lo, iters, dst, d_guid, g0_acc, d_blur, d_sparse, H, W,
            norm, n == 0, r == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
    src_bstride = plane;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// guid: (B, 8, H, W) raw guidance, batch stride guid_bstride (elements);
// sparse: (B, H, W), batch stride sp_bstride, or null (no anchors);
// grad_out: (B, H, W) cotangent of the output, batch stride go_bstride;
// stash: contiguous (B, T, H, W) from cspn_fwd_stash.
// Outputs, contiguous: d_guid (B, 8, H, W), d_blur and d_sparse (B, H, W)
// (d_sparse is 0 without a sparse map). Scratch, contiguous (B, H, W):
// g0_acc, and lam_a, lam_b (used when T > HALO).
// Launches ceil(T / HALO) rounds (one for T = 0) on `stream` and returns
// cudaGetLastError() of the first failing call.
int cspn_bwd(const float* guid, int64_t guid_bstride,
             const float* sparse, int64_t sp_bstride,
             const float* grad_out, int64_t go_bstride,
             const float* stash,
             float* d_guid, float* d_blur, float* d_sparse,
             float* g0_acc, float* lam_a, float* lam_b,
             int B, int H, int W, int T, int norm, void* stream) {
  return launch_rounds<false>(guid, guid_bstride, sparse, sp_bstride,
                              grad_out, go_bstride, stash, d_guid, d_blur,
                              d_sparse, g0_acc, lam_a, lam_b, B, H, W, T,
                              norm, stream);
}

// K6. gates9: (B, 9, H, W) prenormalized planes [g0, g_1..8], batch stride
// g_bstride; sparse, grad_out as in cspn_bwd; stash: contiguous
// (B, T, H, W) from cspn_tiled_fwd_stash. Outputs, contiguous: d_gates9
// (B, 9, H, W) = [G_0, G_1..8], lam0 (B, H, W) = dL/dd^0, d_sparse
// (B, H, W) = sum_t m lam^{t+1} (0 without a sparse map). Scratch lam_a,
// lam_b: contiguous (B, H, W), used when T > HALO.
int cspn_tiled_bwd(const float* gates9, int64_t g_bstride,
                   const float* sparse, int64_t sp_bstride,
                   const float* grad_out, int64_t go_bstride,
                   const float* stash,
                   float* d_gates9, float* lam0, float* d_sparse,
                   float* lam_a, float* lam_b,
                   int B, int H, int W, int T, void* stream) {
  return launch_rounds<true>(gates9, g_bstride, sparse, sp_bstride, grad_out,
                             go_bstride, stash, d_gates9, lam0, d_sparse,
                             nullptr, lam_a, lam_b, B, H, W, T, 0, stream);
}

// K9: cspn_tiled_bwd's contract on one rank's halo'd slab, the stash of
// cspn_prenorm_fwd_stash; T = the round's r <= k iterations.
int cspn_prenorm_bwd(const float* gates9, int64_t g_bstride,
                     const float* sparse, int64_t sp_bstride,
                     const float* grad_out, int64_t go_bstride,
                     const float* stash,
                     float* d_gates9, float* lam0, float* d_sparse,
                     float* lam_a, float* lam_b,
                     int B, int H, int W, int T, void* stream) {
  return launch_rounds<true>(gates9, g_bstride, sparse, sp_bstride, grad_out,
                             go_bstride, stash, d_gates9, lam0, d_sparse,
                             nullptr, lam_a, lam_b, B, H, W, T, 0, stream);
}

const char* cspn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
