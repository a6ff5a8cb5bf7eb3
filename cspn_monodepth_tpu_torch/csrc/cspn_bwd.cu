// CSPN adjoint on Hopper (sm_90a): the gradients of the propagation of
// csrc/cspn_fwd.cu, from the output's cotangent and the stash of every
// pre-iteration plane d^t that the stash forward wrote, and the affinity
// normalization's own pair. C entries:
//   cspn_bwd        with respect to the raw guidance, the blur depth and
//                   the sparse depth, the chain rule of the normalization
//                   and d^0's anchor included: K3 (stash of K2) and K6 (stash
//                   of K5), which compute the same function (K6's wrapper in
//                   ops/cspn_cuda.py launches this entry);
//   cspn_prenorm_bwd (K9) the prenormalized contract of the spatially
//                   sharded CSPN (stash of K8, one round of r <= k
//                   iterations on one rank's halo'd slab, whose halo rows
//                   are image rows to it): with respect to the nine gate
//                   planes (B, 9, H, W), [G_0, G_1..8], and to d^0 (lam^0),
//                   and the sparse sum sum_t m lam^{t+1} of the
//                   per-iteration anchors; where K8 anchored d^0 on load,
//                   also that anchor's gradients, as K3's;
//   cspn_gates9     the normalization, raw guidance (B, 8, H, W) to gates9
//                   (B, 9, H, W) = [1 - sum_k gate_k, gate_1..8]: K3's stage
//                   0, and the slab route's normalization;
//   cspn_gates9_bwd its adjoint, the guidance and d_gates9 to d_guidance by
//                   the chain rule that K3's sums stage applies, through the
//                   same device function;
// and one C entry per further stage (cspn_bwd_sweep, cspn_bwd_sums), through
// which the stages are checked and timed alone.
//
// Replaces: cspn_monodepth_tpu/ops/cspn_pallas.py:_cspn_bwd_kernel
// (launched by _cspn_pallas_bwd_impl), the whole-plane TPU adjoint of the
// training step (K3), and _cspn_tiled_bwd_kernel (launched by
// _tiled_bwd_launch) with the normalization's chain rule and the anchor's
// gradients that _cspn_tiled_adjoint_bwd_impl applies after it (jax.vjp of
// _prenorm_gates9), the H-tiled one (K6), and _cspn_prenorm_bwd_kernel
// (launched by _cspn_prenorm_bwd_impl), the spatial path's slab adjoint
// (K9); cspn_gates9 and cspn_gates9_bwd replace _prenorm_gates9 and its
// jax.vjp, the XLA fusions of the normalization
// (cspn_monodepth_tpu/parallel/halo.py normalizes each shard with it). They
// compute the same functions; they do not copy the TPU layout, which keeps
// ~28 planes of one image (K3) or of one row tile (K6) resident in VMEM
// and carries the gate sums there from one iteration to the next.
//
// The function, with lam^{t+1} = dL/dd^{t+1} (unmasked), m = [sparse > 0]
// and lam_u = (1 - m) lam, for t = T-1 .. 0:
//   sweep: lam^t(j) = g0(j) lam_u(j) + sum_k gT_k(j) lam_u(j + off_k),
//          gT_k(j) = g_{7-k}(j + off_k), 0 outside the image
//          (the transposed stencil: off_{7-k} = -off_k);
//   sums:  G_k(j) = sum_t lam_u^{t+1}(j) d^t(j + off_k),
//          G_0(j) = sum_t lam_u^{t+1}(j) d^t(j),
//          d_sparse = sum_t m lam^{t+1};
// then, K3/K6 (and K9 where d^0 was anchored on load), d_blur =
// (1 - m) lam^0 and d_sparse += m lam^0, and, K3/K6 only, the chain rule
// of the normalization (ops/cspn_ref.py:cspn_bwd_sums_plain).
// The sums need nothing of the recursion but the lam planes, so the fused
// adjoint splits into lean kernels, each run over the whole batch:
//   stage 0 (K3/K6) adjoint_gates9: the raw guidance (B, 8, H, W) to
//          gates9 (B, 9, H, W) in scratch, the forward's expression; after
//          it the sweep is K9's;
//   stage 1 adjoint_sweep_round: the lam recursion, the forward kernel's
//          structure on the transposed stencil; writes every lam^{t+1}
//          into a (B, T, H, W) adjoint stash, as K2 writes d^t, and lam^0;
//   stage 2 adjoint_sums: the gate sums in one streaming pass over t.
// Tensor cores do not apply: every pixel has its own 9 weights and no
// operand is shared between pixels, so there is no matrix product.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32), each input read once
// and each output written once; every stage does a few flop per byte, far
// below the f32 rate: all are bound by bytes. Per pixel, T = 24:
//   the function: K3 and K6 (22 + T) * 4 = 184 B (390.4 MB at NYU's B=32
//          x 228x304, 117 us; 630.1 MB at KITTI's B=8 x 352x1216, 188 us);
//          K9 (22 + r) planes, 48.6 MB on KITTI's 2x4 slab (B=4 x 96x1216,
//          r=4), 14.5 us;
//   stage 0: 8 planes in, 9 out, 68 B (150.8 MB at NYU B=32, 45 us; 232.9 MB
//          at KITTI B=8, 70 us);
//   cspn_gates9_bwd: 8 guidance and 9 gate-gradient planes in, 8 out, 100 B
//          (342.4 MB at KITTI B=8, 102 us);
//   stage 1: 9 gate planes, sparse and the cotangent in, T lam planes and
//          lam^0 out, (12 + T) * 4 = 144 B (319.4 MB at NYU B=32, 95 us;
//          493.1 MB at KITTI B=8, 147 us);
//   stage 2: the T stash and T lam planes and sparse in, 10 planes out
//          (K9: 9 gate sums, the sparse sum), (2T + 11) * 4 = 236 B; K3/K6
//          read the 8 raw planes and lam^0 and write the 8 guidance
//          gradients, d_blur and d_sparse, (2T + 20) * 4 = 272 B (603.3 MB
//          at NYU B=32, 180 us; 931.4 MB at KITTI B=8, 278 us).
// The split moves more bytes than the function (K3/K6 121 planes against
// 46) in exchange for kernels that keep the card busy; the
// fused kernel it replaces carried 36 gate sums per thread (253 registers,
// one block per SM) and re-read them from device memory every round.
//
// Design:
// * Stage 1 is csrc/cspn_fwd.cu's recompute-in-halo round with the
//   transposed gates: a block owns a TILE x TILE interior of a SLAB x SLAB
//   slab, runs up to HALO iterations (the stencil moves information one
//   pixel per iteration, so the interior stays exact), and the host
//   launches the forward's rounds in reverse order, ping-ponging lam
//   between two planes (the last round writes lam^0). Each thread loads g0
//   and the 8 transposed gates of its slab pixels into registers once per
//   round by shifted reads of gates9; only lam_u sits in shared memory, a
//   ping-pong pair with a zero apron (14 KB static). No gate sums: the
//   kernel keeps the forward's registers, two 320-thread blocks per SM.
// * Stage 2: a block owns SUM_W x SUM_H pixels, one per thread, and walks
//   t = T-1 .. 0 with G_0..G_8 and the sparse sum in registers. The d^t
//   window with a one-pixel apron and the lam^{t+1} tile are staged in
//   shared memory by cp.async (4-byte copies, zero-filled outside the
//   image), double-buffered over t so that the next plane is in flight
//   while this one is summed. Each pixel is written by one thread: no
//   atomics, the result is deterministic.
// * The image border: pixels outside the image have all gates 0 and are
//   masked like anchors, so lam there stays 0 and nothing flows back from
//   outside; d^t outside the image is 0, as in the forward.
//
// Built by ops/cspn_cuda.py with nvcc -gencode arch=compute_90a,code=sm_90a
// into a shared library with the plain C interface below, bound by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Stage 1: the forward's tiles.
constexpr int TILE = 32;                     // interior edge
constexpr int HALO = 4;                      // iterations per round
constexpr int SLAB = TILE + 2 * HALO;        // 40
constexpr int PITCH = SLAB + 2;              // one-pixel zero apron
constexpr int THREADS = 320;
constexpr int PPT = SLAB * SLAB / THREADS;   // slab pixels per thread
static_assert(PPT * THREADS == SLAB * SLAB, "threads must tile the slab");

// Stage 2: one pixel per thread, the d^t window with a one-pixel apron.
constexpr int SUM_W = 32, SUM_H = 8;
constexpr int SUM_THREADS = SUM_W * SUM_H;
constexpr int WIN_W = SUM_W + 2;
constexpr int WIN = WIN_W * (SUM_H + 2);

// Stage 0 and cspn_gates9_bwd: one pixel per thread.
constexpr int EW_THREADS = 256;

enum Norm { kSum = 0, kSumAbs = 1, kSumClamp = 2 };

// (dy, dx) of the 8 neighbours, ops/cspn_ref.py:NEIGHBOR_OFFSETS order.
__constant__ int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

// Asynchronous 4-byte copy global -> shared; zero-fills when !valid (src
// must still be a mapped address: no byte is read from it).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d^0's anchor, d^0 = (1 - m) blur + m sparse, in reverse: lam0 into d_blur
// = (1 - m) lam0, and d_sparse = ssum (the per-iteration anchors' sum) plus
// m lam0.
__device__ __forceinline__ void anchor_grad(bool m, float ssum, float lam0,
                                            float* d_blur, float* d_sparse) {
  *d_blur = m ? 0.0f : lam0;
  *d_sparse = m ? ssum + lam0 : ssum;
}

// The chain rule of gate_k = a_k / max(s, floor), s = sum |g_k| (a = g, or
// |g| for 8sum_abs), gate_0 = 1 - sum_k gate_k: from G (G[k] = dL/dgate_{k+1}
// for k < 8, G[8] = dL/dgate_0) and the raw guidance of one pixel (g, its 8
// planes `plane` apart) to dL/dg (dg, 8 planes apart). Ghat_k = G_k - G_0,
// c1 = sum_k Ghat_k gate_k; sign(0) = 0.
__device__ __forceinline__ void norm_chain_rule(const float* g, int64_t plane,
                                                const float G[9], float* dg,
                                                int norm) {
  const float floor_ = norm == kSumClamp ? 1.0f : 1e-8f;
  float raw[8], a[8];
  float abs_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    raw[k] = g[k * plane];
    a[k] = norm == kSumAbs ? fabsf(raw[k]) : raw[k];
    abs_sum += fabsf(a[k]);
  }
  const float den = fmaxf(abs_sum, floor_);
  const float active = abs_sum > floor_ ? 1.0f : 0.0f;
  float c1 = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) c1 = fmaf(G[k] - G[8], a[k] / den, c1);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float ghat = G[k] - G[8];
    const float sgn = raw[k] > 0.0f ? 1.0f : (raw[k] < 0.0f ? -1.0f : 0.0f);
    dg[k * plane] = norm == kSumAbs ? sgn * (ghat - active * c1) / den
                                    : (ghat - sgn * (active * c1)) / den;
  }
}

// Stage 0: gates9 = [1 - sum_k gate_k, gate_1..8], gate_k = a_k / max(s,
// floor), a = g (|g| for 8sum_abs), s = sum_k |a_k| (cspn_fwd.cu's
// normalization).
__global__ void __launch_bounds__(EW_THREADS)
adjoint_gates9(const float* __restrict__ guid, int64_t guid_bstride,
               float* __restrict__ gates9, int64_t plane, int norm) {
  const int64_t idx = (int64_t)blockIdx.x * EW_THREADS + threadIdx.x;
  if (idx >= plane) return;
  const float* g = guid + blockIdx.y * guid_bstride + idx;
  float* out = gates9 + (int64_t)blockIdx.y * 9 * plane + idx;
  const float floor_ = norm == kSumClamp ? 1.0f : 1e-8f;
  float a[8];
  float abs_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = g[k * plane];
    if (norm == kSumAbs) a[k] = fabsf(a[k]);
    abs_sum += fabsf(a[k]);
  }
  const float den = fmaxf(abs_sum, floor_);
  float gsum = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float gk = a[k] / den;
    out[(k + 1) * plane] = gk;
    gsum += gk;
  }
  out[0] = 1.0f - gsum;
}

// cspn_gates9_bwd: d_gates9 (B, 9, H, W) = [dL/dgate_0, dL/dgate_1..8] and
// the raw guidance -> d_guid (B, 8, H, W), contiguous.
__global__ void __launch_bounds__(EW_THREADS)
gates9_bwd(const float* __restrict__ guid, int64_t guid_bstride,
           const float* __restrict__ d_gates9, int64_t dg9_bstride,
           float* __restrict__ d_guid, int64_t plane, int norm) {
  const int64_t idx = (int64_t)blockIdx.x * EW_THREADS + threadIdx.x;
  if (idx >= plane) return;
  const float* d9 = d_gates9 + blockIdx.y * dg9_bstride + idx;
  float G[9];
#pragma unroll
  for (int k = 0; k < 8; ++k) G[k] = d9[(k + 1) * plane];
  G[8] = d9[0];
  norm_chain_rule(guid + blockIdx.y * guid_bstride + idx, plane, G,
                  d_guid + (int64_t)blockIdx.y * 8 * plane + idx, norm);
}

// Stage 1, one round: `iters` reverse iterations t = t_lo + iters - 1 ..
// t_lo from lam^{t_lo + iters} (lam_in, unmasked); writes lam^{t+1} to
// lstash[b, t] at each iteration's start and lam^{t_lo} to lam_out.
__global__ void __launch_bounds__(THREADS, 2)
adjoint_sweep_round(const float* __restrict__ gates9, int64_t g_bstride,
                    const float* __restrict__ sparse, int64_t sp_bstride,
                    const float* __restrict__ lam_in, int64_t lam_bstride,
                    float* __restrict__ lam_out, float* __restrict__ lstash,
                    int T, int t_lo, int iters, int H, int W) {
  __shared__ float buf[2][PITCH * PITCH];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE - HALO;
  const int x0 = blockIdx.x * TILE - HALO;
  const int64_t plane = (int64_t)H * W;
  const float* g = gates9 + b * g_bstride;
  const float* sp = sparse ? sparse + b * sp_bstride : nullptr;
  const float* lin = lam_in + b * lam_bstride;
  float* lout = lam_out + b * plane;
  float* st = lstash + (int64_t)b * T * plane;

  for (int i = threadIdx.x; i < 2 * PITCH * PITCH; i += THREADS)
    (&buf[0][0])[i] = 0.0f;
  __syncthreads();

  float gate[PPT][9];   // [0] = g0, [1 + k] = gT_k
  float lam[PPT];       // unmasked
  bool masked[PPT];     // an anchor, or outside the image
  bool interior[PPT];   // inside the image and in the tile's interior
  int off[PPT];
  int gidx[PPT];        // index in the plane (H * W < 2^31)

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    const int y = p / SLAB, x = p % SLAB;
    const int gy = y0 + y, gx = x0 + x;
    off[i] = (y + 1) * PITCH + (x + 1);
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    gidx[i] = inside ? gy * W + gx : 0;
    interior[i] = inside && y >= HALO && y < HALO + TILE && x >= HALO &&
                  x < HALO + TILE;
    lam[i] = 0.0f;
    masked[i] = true;
#pragma unroll
    for (int k = 0; k < 9; ++k) gate[i][k] = 0.0f;
    if (inside) {
      gate[i][0] = g[gidx[i]];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ny = gy + kDy[k], nx = gx + kDx[k];
        if (ny >= 0 && ny < H && nx >= 0 && nx < W)
          gate[i][k + 1] = g[(8 - k) * plane + ny * W + nx];   // g_{7-k}
      }
      lam[i] = lin[gidx[i]];
      masked[i] = sp && sp[gidx[i]] > 0.0f;
    }
    buf[0][off[i]] = masked[i] ? 0.0f : lam[i];
  }
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < iters; ++s) {
    const int t = t_lo + iters - 1 - s;
    const float* lc = buf[cur];
    float* ln = buf[cur ^ 1];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int o = off[i];
      if (interior[i]) st[t * plane + gidx[i]] = lam[i];    // lam^{t+1}
      float v = gate[i][0] * lc[o];
      v = fmaf(gate[i][1], lc[o - PITCH - 1], v);
      v = fmaf(gate[i][2], lc[o - PITCH], v);
      v = fmaf(gate[i][3], lc[o - PITCH + 1], v);
      v = fmaf(gate[i][4], lc[o - 1], v);
      v = fmaf(gate[i][5], lc[o + 1], v);
      v = fmaf(gate[i][6], lc[o + PITCH - 1], v);
      v = fmaf(gate[i][7], lc[o + PITCH], v);
      v = fmaf(gate[i][8], lc[o + PITCH + 1], v);
      lam[i] = v;
      ln[o] = masked[i] ? 0.0f : v;
    }
    __syncthreads();
    cur ^= 1;
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i)
    if (interior[i]) lout[gidx[i]] = lam[i];
}

// Stage 2. RAW false (K9): d_guid = d_gates9 (B, 9, H, W) = [G_0,
// G_1..8], d_sparse = sum_t m lam^{t+1}; guid unused; d_blur null, or
// (d^0 anchored on load) lam^0 on entry, (1 - m) lam^0 on return with
// d_sparse taking m lam^0. RAW true (K3, K6): guid the raw guidance
// (B, 8, H, W); d_blur holds lam^0 on entry and (1 - m) lam^0 on return;
// d_sparse also takes m lam^0; d_guid (B, 8, H, W) the guidance gradient by
// the normalization's chain rule.
template <bool RAW>
__global__ void __launch_bounds__(SUM_THREADS)
adjoint_sums(const float* __restrict__ guid, int64_t guid_bstride,
             const float* __restrict__ sparse, int64_t sp_bstride,
             const float* __restrict__ stash, const float* __restrict__ lstash,
             float* __restrict__ d_guid, float* __restrict__ d_blur,
             float* __restrict__ d_sparse, int H, int W, int T, int norm) {
  __shared__ float dwin[2][WIN];
  __shared__ float lwin[2][SUM_THREADS];

  const int b = blockIdx.z;
  const int tx = threadIdx.x % SUM_W, ty = threadIdx.x / SUM_W;
  const int wx0 = blockIdx.x * SUM_W - 1, wy0 = blockIdx.y * SUM_H - 1;
  const int gx = wx0 + 1 + tx, gy = wy0 + 1 + ty;
  const bool inside = gx < W && gy < H;
  const int64_t plane = (int64_t)H * W;
  const int pix = inside ? gy * W + gx : 0;
  const float* st = stash + (int64_t)b * T * plane;
  const float* ls = lstash + (int64_t)b * T * plane;
  const bool m = inside && sparse && sparse[b * sp_bstride + pix] > 0.0f;

  // Start the copies of d^t's window and lam^{t+1}'s tile into buffer c.
  auto load = [&](int t, int c) {
    const float* dp = st + t * plane;
    for (int e = threadIdx.x; e < WIN; e += SUM_THREADS) {
      const int y = wy0 + e / WIN_W, x = wx0 + e % WIN_W;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      cp_async4(&dwin[c][e], ok ? dp + y * W + x : dp, ok);
    }
    cp_async4(&lwin[c][threadIdx.x], ls + t * plane + pix, inside);
    cp_async_commit();
  };

  float acc[9];         // [0..7] G_k, [8] G_0
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.0f;
  float ssum = 0.0f;
  const int o = (ty + 1) * WIN_W + tx + 1;

  if (T > 0) load(T - 1, 0);
  for (int n = 0; n < T; ++n) {
    const int t = T - 1 - n, c = n & 1;
    if (t > 0) {
      load(t - 1, c ^ 1);    // buffer c ^ 1 was last read before the
      cp_async_wait<1>();    // previous iteration's closing barrier
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float lam = lwin[c][threadIdx.x];
    const float lu = m ? 0.0f : lam;
    if (m) ssum += lam;
    const float* d = dwin[c];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc[k] = fmaf(lu, d[o + kDy[k] * WIN_W + kDx[k]], acc[k]);
    acc[8] = fmaf(lu, d[o], acc[8]);
    __syncthreads();
  }

  if (!inside) return;
  const int64_t px = (int64_t)b * plane + pix;
  if (RAW || d_blur)
    anchor_grad(m, ssum, d_blur[px], d_blur + px, d_sparse + px);
  else
    d_sparse[px] = ssum;
  if constexpr (!RAW) {
    float* dg = d_guid + (int64_t)b * 9 * plane + pix;
    dg[0] = acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) dg[(k + 1) * plane] = acc[k];
  } else {
    norm_chain_rule(guid + b * guid_bstride + pix, plane, acc,
                    d_guid + (int64_t)b * 8 * plane + pix, norm);
  }
}

int launch_gates9(const float* guid, int64_t guid_bstride, float* gates9,
                  int B, int H, int W, int norm, cudaStream_t stream) {
  const int64_t plane = (int64_t)H * W;
  const dim3 grid((unsigned)((plane + EW_THREADS - 1) / EW_THREADS), B);
  adjoint_gates9<<<grid, EW_THREADS, 0, stream>>>(guid, guid_bstride, gates9,
                                                  plane, norm);
  return (int)cudaGetLastError();
}

int launch_sweep(const float* gates9, int64_t g_bstride,
                 const float* sparse, int64_t sp_bstride,
                 const float* grad_out, int64_t go_bstride,
                 float* lstash, float* lam0, float* lam_scratch,
                 int B, int H, int W, int T, cudaStream_t stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  const int rounds = T == 0 ? 1 : (T + HALO - 1) / HALO;
  const int64_t plane = (int64_t)H * W;
  const float* src = grad_out;
  int64_t src_bstride = go_bstride;
  for (int n = 0; n < rounds; ++n) {
    const int r = rounds - 1 - n;            // the forward's round, reversed
    const int t_lo = r * HALO;
    const int iters = T - t_lo < HALO ? T - t_lo : HALO;
    float* dst = r % 2 == 0 ? lam0 : lam_scratch;   // the last writes lam0
    adjoint_sweep_round<<<grid, THREADS, 0, stream>>>(
        gates9, g_bstride, sparse, sp_bstride, src, src_bstride, dst, lstash,
        T, t_lo, iters, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
    src_bstride = plane;
  }
  return (int)cudaSuccess;
}

template <bool RAW>
int launch_sums(const float* guid, int64_t guid_bstride,
                const float* sparse, int64_t sp_bstride,
                const float* stash, const float* lstash,
                float* d_guid, float* d_blur, float* d_sparse,
                int B, int H, int W, int T, int norm, cudaStream_t stream) {
  const dim3 grid((W + SUM_W - 1) / SUM_W, (H + SUM_H - 1) / SUM_H, B);
  adjoint_sums<RAW><<<grid, SUM_THREADS, 0, stream>>>(
      guid, guid_bstride, sparse, sp_bstride, stash, lstash, d_guid, d_blur,
      d_sparse, H, W, T, norm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 and K6. guid: (B, 8, H, W) raw guidance, batch stride guid_bstride
// (elements); sparse: (B, H, W), batch stride sp_bstride, or null (no
// anchors); grad_out: (B, H, W) cotangent of the output, batch stride
// go_bstride; stash: contiguous (B, T, H, W) from cspn_fwd_stash.
// Outputs, contiguous: d_guid (B, 8, H, W), d_blur and d_sparse (B, H, W)
// (d_sparse is 0 without a sparse map). Scratch, contiguous: gates9
// (B, 9, H, W), lstash (B, T, H, W), lam_scratch (B, H, W). Launches stage
// 0, the ceil(T / HALO) rounds of stage 1 (one for T = 0) and stage 2 on
// `stream` and returns cudaGetLastError() of the first failing launch.
int cspn_bwd(const float* guid, int64_t guid_bstride,
             const float* sparse, int64_t sp_bstride,
             const float* grad_out, int64_t go_bstride,
             const float* stash,
             float* d_guid, float* d_blur, float* d_sparse,
             float* gates9, float* lstash, float* lam_scratch,
             int B, int H, int W, int T, int norm, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int err = launch_gates9(guid, guid_bstride, gates9, B, H, W, norm, s);
  if (err != cudaSuccess) return err;
  err = launch_sweep(gates9, 9 * (int64_t)H * W, sparse, sp_bstride,
                     grad_out, go_bstride, lstash, d_blur, lam_scratch, B, H,
                     W, T, s);
  if (err != cudaSuccess) return err;
  return launch_sums<true>(guid, guid_bstride, sparse, sp_bstride, stash,
                           lstash, d_guid, d_blur, d_sparse, B, H, W, T, norm,
                           s);
}

// K9. gates9: (B, 9, H, W) prenormalized planes [g0, g_1..8], batch stride
// g_bstride; sparse, grad_out as in cspn_bwd; stash: contiguous
// (B, T, H, W) from cspn_prenorm_fwd_stash, T = the round's r <= k
// iterations. Outputs, contiguous: d_gates9 (B, 9, H, W) = [G_0, G_1..8],
// lam0 (B, H, W) = dL/dd^0, d_sparse (B, H, W) = sum_t m lam^{t+1} (0
// without a sparse map); with anchor0 non-zero (K8 anchored d^0 on load)
// lam0 = (1 - m) dL/dd^0 and d_sparse also takes m dL/dd^0. Scratch,
// contiguous: lstash (B, T, H, W), lam_scratch (B, H, W).
int cspn_prenorm_bwd(const float* gates9, int64_t g_bstride,
                     const float* sparse, int64_t sp_bstride,
                     const float* grad_out, int64_t go_bstride,
                     const float* stash,
                     float* d_gates9, float* lam0, float* d_sparse,
                     float* lstash, float* lam_scratch,
                     int B, int H, int W, int T, int anchor0, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int err = launch_sweep(gates9, g_bstride, sparse, sp_bstride, grad_out,
                         go_bstride, lstash, lam0, lam_scratch, B, H, W, T,
                         s);
  if (err != cudaSuccess) return err;
  return launch_sums<false>(nullptr, 0, sparse, sp_bstride, stash, lstash,
                            d_gates9, anchor0 ? lam0 : nullptr, d_sparse, B,
                            H, W, T, 0, s);
}

// The normalization (stage 0 alone): guid (B, 8, H, W), batch stride
// guid_bstride -> gates9, contiguous (B, 9, H, W).
int cspn_gates9(const float* guid, int64_t guid_bstride, float* gates9,
                int B, int H, int W, int norm, void* stream) {
  return launch_gates9(guid, guid_bstride, gates9, B, H, W, norm,
                       (cudaStream_t)stream);
}

// Its adjoint: guid (B, 8, H, W) and d_gates9 (B, 9, H, W), batch strides
// guid_bstride and dg9_bstride -> d_guid, contiguous (B, 8, H, W).
int cspn_gates9_bwd(const float* guid, int64_t guid_bstride,
                    const float* d_gates9, int64_t dg9_bstride,
                    float* d_guid, int B, int H, int W, int norm,
                    void* stream) {
  const int64_t plane = (int64_t)H * W;
  const dim3 grid((unsigned)((plane + EW_THREADS - 1) / EW_THREADS), B);
  gates9_bwd<<<grid, EW_THREADS, 0, (cudaStream_t)stream>>>(
      guid, guid_bstride, d_gates9, dg9_bstride, d_guid, plane, norm);
  return (int)cudaGetLastError();
}

// Stage 1 alone: gates9, sparse, grad_out as in cspn_prenorm_bwd -> lstash,
// contiguous (B, T, H, W), lstash[b, t] = lam^{t+1} unmasked, and lam0
// (B, H, W). Scratch lam_scratch (B, H, W).
int cspn_bwd_sweep(const float* gates9, int64_t g_bstride,
                   const float* sparse, int64_t sp_bstride,
                   const float* grad_out, int64_t go_bstride,
                   float* lstash, float* lam0, float* lam_scratch,
                   int B, int H, int W, int T, void* stream) {
  return launch_sweep(gates9, g_bstride, sparse, sp_bstride, grad_out,
                      go_bstride, lstash, lam0, lam_scratch, B, H, W, T,
                      (cudaStream_t)stream);
}

// Stage 2 alone, from the stash and stage 1's lstash (both contiguous
// (B, T, H, W)). guid null: K9's sums, d_guid = d_gates9 (B, 9, H, W),
// d_sparse; d_blur unused. guid the raw guidance (B, 8, H, W): K3's, with
// d_blur holding lam^0 on entry (see adjoint_sums).
int cspn_bwd_sums(const float* guid, int64_t guid_bstride,
                  const float* sparse, int64_t sp_bstride,
                  const float* stash, const float* lstash,
                  float* d_guid, float* d_blur, float* d_sparse,
                  int B, int H, int W, int T, int norm, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (guid)
    return launch_sums<true>(guid, guid_bstride, sparse, sp_bstride, stash,
                             lstash, d_guid, d_blur, d_sparse, B, H, W, T,
                             norm, s);
  return launch_sums<false>(nullptr, 0, sparse, sp_bstride, stash, lstash,
                            d_guid, nullptr, d_sparse, B, H, W, T, 0, s);
}

const char* cspn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
