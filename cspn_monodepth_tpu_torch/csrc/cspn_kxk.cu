// CSPN++'s k x k propagation on Hopper (sm_90a), k = 5 and 7 (Cheng, Wang,
// Guan, Yang, "CSPN++", AAAI 2020, arXiv:1911.05377): the function of
// csrc/cspn_fwd.cu and csrc/cspn_bwd.cu on a k x k neighbourhood of
// N = k^2 - 1 neighbours, on the raw contract of the H-tiled route (raw
// guidance (B, N, H, W), blur and sparse (B, H, W) in; the normalization,
// d^0's anchor and, backward, their chain rule inside). C entries:
//   cspn_kxk_fwd  the forward, and with a stash the training forward that
//                 also keeps every pre-iteration plane d^t in a (B, T, H, W)
//                 stash for the adjoint;
//   cspn_kxk_bwd  the adjoint over that stash: d_guidance (B, N, H, W),
//                 d_blur = (1 - m) lam^0, d_sparse = sum_t m lam^{t+1} +
//                 m lam^0, as ops/cspn_ref.py:cspn_kxk_bwd_plain.
// No TPU kernel has this function: the JAX package runs a 3 x 3 CSPN only.
// Every kernel's name starts with cspn_kxk_, and the adjoint's with
// cspn_kxk_adjoint_, by which a trace tells them apart.
//
// Bound on an H100 SXM (3.35 TB/s): read every operand once and write
// every result once, 4 (k^2 + 5) B/px forward with the stash's T planes
// left out (k = 5 120 B, k = 7 216 B) and 4 (2 k^2 + 5) B/px backward.
// The 3 x 3 kernels keep a pixel's 9 gates in registers for all the
// iterations of a round; 48 gates a pixel (k = 7) do not fit, nor a
// slab's gates in shared memory (a 56 x 56 slab's are 614 KB), and the
// halo grows by r = (k - 1) / 2 rows an iteration. So here the guidance is
// read once an iteration, and that sets the time: (k^2 + 4) planes an
// iteration, (53 at k = 7) 0.72 GB an iteration at KITTI's B = 8 x
// 352x1216, 0.22 ms at the card's rate.
//
// Design:
// * Normalize once, as a scale. `cspn_kxk_prep` reads the N raw planes and
//   writes two: the centre gate g0 = 1 - inv sum_n g'_n and inv =
//   1 / max(sum_n |g_n|, floor) (g' = |g| under 8sum_abs, else g), and
//   d^0 = the anchored blur. An iteration then reads the raw planes and
//   forms g0 d + inv sum_n g'_n d(j + off_n): the normalized gates are
//   never written, which saves N planes of writes.
// * One launch an iteration (`cspn_kxk_step`), each over the whole batch:
//   a block of 32 x 8 threads owns a 32 x 8 tile, loads its d with an
//   r-pixel halo (zero outside the image) into shared memory, and each
//   thread sums its pixel's N neighbours from there, the raw gates read
//   straight from device memory (a warp reads 32 adjacent pixels of a
//   plane: one line). Threads that own 2 or 4 rows each (tiles of 16 and
//   32 rows) were swept on an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md
//   section 6) and were no faster: k = 7, T = 24 forward 6.13 ms at one
//   row, 6.21 at two, 7.38 at four; the adjoint 10.05, 9.98, 10.35.
// * The stash is where the iterations run: the training forward's
//   iteration t reads stash[:, t] and writes stash[:, t + 1] (the last
//   writes out), so keeping d^t costs no copy. Without a stash d
//   ping-pongs between out and one scratch plane, so that the last
//   iteration writes out.
// * The adjoint, with lam^{t+1} = dL/dd^{t+1} and lam_u = (1 - m) lam:
//   `cspn_kxk_adjoint_prep` recomputes g0 and inv; T launches of
//   `cspn_kxk_adjoint_step` run the transposed stencil, lam^t(j) = g0(j)
//   lam_u(j) + sum_n g'_n(j - off_n) w(j - off_n) with w = lam_u inv, the
//   one plane a block loads into shared memory, and write every lam^t to
//   an adjoint stash, as the forward writes d^t; `cspn_kxk_adjoint_sums`
//   streams over t once, holding a pixel's N + 1 gate sums G_n =
//   sum_t lam_u^{t+1}(j) d^t(j + off_n) and G_0 in registers, then applies
//   the normalization's chain rule (csrc/cspn_bwd.cu's, over N
//   neighbours) and the anchor's gradients.
// * Zero border: d (and w) is 0 outside the image; an outside neighbour's
//   gate is never used.
// * Strides: each plane is contiguous (row stride W), the guidance planes
//   of one image H*W apart, and every input takes its own batch stride,
//   so the model's head output is passed as slices without a copy.
//
// Built by ops/cspn_cuda.py with nvcc -gencode arch=compute_90a,code=sm_90a
// into a shared library with the plain C interface below, bound by ctypes,
// the first time a kernel size above 3 is asked for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Norm { kSum = 0, kSumAbs = 1, kSumClamp = 2 };

constexpr int BX = 32, BY = 8;   // a block and its tile: a warp a row

// The k x k stencil: N neighbours, row-major with the centre (index N / 2
// of the k x k grid) left out: ops/cspn_ref.py:neighbor_offsets(k).
template <int K>
struct Stencil {
  static constexpr int R = K / 2, N = K * K - 1;
  __host__ __device__ static constexpr int dy(int n) {
    return (n < N / 2 ? n : n + 1) / K - R;
  }
  __host__ __device__ static constexpr int dx(int n) {
    return (n < N / 2 ? n : n + 1) % K - R;
  }
};

__device__ __forceinline__ float floor_of(int norm) {
  return norm == kSumClamp ? 1.0f : 1e-8f;
}

__device__ __forceinline__ float sign_of(float a) {
  return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : 0.0f);
}

// g0 and inv of one pixel from its N raw gates (plane stride `plane`).
template <int K>
__device__ __forceinline__ void normalize(const float* __restrict__ g,
                                          int64_t plane, int64_t idx,
                                          int norm, float* prep) {
  float abs_sum = 0.0f, sum = 0.0f;
#pragma unroll
  for (int n = 0; n < Stencil<K>::N; ++n) {
    const float a = g[n * plane + idx];
    abs_sum += fabsf(a);
    sum += norm == kSumAbs ? fabsf(a) : a;
  }
  const float inv = 1.0f / fmaxf(abs_sum, floor_of(norm));
  prep[idx] = 1.0f - sum * inv;   // g0
  prep[plane + idx] = inv;
}

// The normalization of every pixel into prep (B, 2, H, W) = [g0, inv], and
// d^0 = (1 - m) blur + m sparse.
template <int K>
__global__ void __launch_bounds__(BX * BY)
cspn_kxk_prep(const float* __restrict__ guid, int64_t guid_bstride,
              const float* __restrict__ blur, int64_t blur_bstride,
              const float* __restrict__ sparse, int64_t sp_bstride,
              float* __restrict__ prep, float* __restrict__ d0,
              int64_t d0_bstride, int H, int W, int norm) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int64_t plane = (int64_t)H * W, idx = (int64_t)y * W + x;
  normalize<K>(guid + b * guid_bstride, plane, idx, norm,
               prep + b * 2 * plane);
  const float s = sparse ? sparse[b * sp_bstride + idx] : 0.0f;
  d0[b * d0_bstride + idx] = s > 0.0f ? s : blur[b * blur_bstride + idx];
}

// The adjoint's own copy of the normalization (no d^0), so that a trace
// counts it with the adjoint.
template <int K>
__global__ void __launch_bounds__(BX * BY)
cspn_kxk_adjoint_prep(const float* __restrict__ guid, int64_t guid_bstride,
                      float* __restrict__ prep, int H, int W, int norm) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int64_t plane = (int64_t)H * W;
  normalize<K>(guid + b * guid_bstride, plane, (int64_t)y * W + x, norm,
               prep + b * 2 * plane);
}

// One iteration on a 32 x 8 tile. Forward (ADJ false): src = d^t, dst =
// d^{t+1} anchored. Adjoint (ADJ true): src = lam^{t+1}, dst = lam^t
// unmasked, on the transposed stencil.
template <int K, bool ADJ>
__device__ __forceinline__ void step(
    float* tile, const float* __restrict__ guid, int64_t guid_bstride,
    const float* __restrict__ prep, const float* __restrict__ sparse,
    int64_t sp_bstride, const float* __restrict__ src, int64_t src_bstride,
    float* __restrict__ dst, int64_t dst_bstride, int H, int W, int norm) {
  using S = Stencil<K>;
  constexpr int R = S::R, SW = BX + 2 * R, SH = BY + 2 * R;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int64_t plane = (int64_t)H * W;
  const float* g = guid + b * guid_bstride;
  const float* g0 = prep + b * 2 * plane;
  const float* inv = g0 + plane;
  const float* sp = sparse ? sparse + b * sp_bstride : nullptr;
  const float* s_in = src + b * src_bstride;

  // The tile and its halo: d, or w = lam_u inv; 0 outside the image.
  for (int i = threadIdx.y * BX + threadIdx.x; i < SH * SW; i += BX * BY) {
    const int gy = y0 - R + i / SW, gx = x0 - R + i % SW;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int64_t idx = (int64_t)gy * W + gx;
      v = s_in[idx];
      if (ADJ) v = (sp && sp[idx] > 0.0f) ? 0.0f : v * inv[idx];
    }
    tile[i] = v;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const bool abs_gates = norm == kSumAbs;
  const int64_t idx = (int64_t)y * W + x;
  const float* c = tile + (threadIdx.y + R) * SW + threadIdx.x + R;
  float acc = 0.0f;
  if (!ADJ) {
#pragma unroll
    for (int n = 0; n < S::N; ++n) {
      float a = g[n * plane + idx];
      if (abs_gates) a = fabsf(a);
      acc = fmaf(a, c[S::dy(n) * SW + S::dx(n)], acc);
    }
    const float v = fmaf(g0[idx], c[0], acc * inv[idx]);
    const float s = sp ? sp[idx] : 0.0f;
    dst[b * dst_bstride + idx] = s > 0.0f ? s : v;
  } else {
#pragma unroll
    for (int n = 0; n < S::N; ++n) {
      // The neighbour p = j - off_n reads j through its gate n. Its gate is
      // loaded from p clamped into the image, unconditionally, so that the
      // loads go out ahead of the sums, and taken as 0 outside.
      const int py = y - S::dy(n), px = x - S::dx(n);
      const bool in = py >= 0 && py < H && px >= 0 && px < W;
      const int cy = min(max(py, 0), H - 1), cx = min(max(px, 0), W - 1);
      float a = g[n * plane + (int64_t)cy * W + cx];
      if (abs_gates) a = fabsf(a);
      acc = fmaf(in ? a : 0.0f, c[-S::dy(n) * SW - S::dx(n)], acc);
    }
    const float lam = (sp && sp[idx] > 0.0f) ? 0.0f : s_in[idx];
    dst[b * dst_bstride + idx] = fmaf(g0[idx], lam, acc);
  }
}

template <int K>
__global__ void __launch_bounds__(BX * BY)
cspn_kxk_step(const float* __restrict__ guid, int64_t guid_bstride,
              const float* __restrict__ prep,
              const float* __restrict__ sparse, int64_t sp_bstride,
              const float* __restrict__ src, int64_t src_bstride,
              float* __restrict__ dst, int64_t dst_bstride, int H, int W,
              int norm) {
  __shared__ float tile[(BY + K - 1) * (BX + K - 1)];
  step<K, false>(tile, guid, guid_bstride, prep, sparse, sp_bstride,
                      src, src_bstride, dst, dst_bstride, H, W, norm);
}

template <int K>
__global__ void __launch_bounds__(BX * BY)
cspn_kxk_adjoint_step(const float* __restrict__ guid, int64_t guid_bstride,
                      const float* __restrict__ prep,
                      const float* __restrict__ sparse, int64_t sp_bstride,
                      const float* __restrict__ src, int64_t src_bstride,
                      float* __restrict__ dst, int64_t dst_bstride, int H,
                      int W, int norm) {
  __shared__ float tile[(BY + K - 1) * (BX + K - 1)];
  step<K, true>(tile, guid, guid_bstride, prep, sparse, sp_bstride, src,
                     src_bstride, dst, dst_bstride, H, W, norm);
}

// The gate sums over t and the chain rule, a pixel a thread on a 32 x 8
// tile: lam^{t+1} is grad_out for t = T - 1, else lam_stash[b, t] of a
// contiguous (B, T - 1, H, W) array; d^t is stash[b, t] of a contiguous
// (B, T, H, W) one; lam^0 is lam0 (batch stride lam0_bstride), which may
// be d_blur itself: a pixel's lam^0 is read before its d_blur is written.
template <int K>
__global__ void __launch_bounds__(BX * BY)
cspn_kxk_adjoint_sums(const float* __restrict__ guid, int64_t guid_bstride,
                      const float* __restrict__ sparse, int64_t sp_bstride,
                      const float* __restrict__ grad_out,
                      int64_t go_bstride, const float* __restrict__ stash,
                      const float* __restrict__ lam_stash,
                      const float* lam0, int64_t lam0_bstride,
                      float* __restrict__ d_guid, float* d_blur,
                      float* __restrict__ d_sparse, int H, int W, int T,
                      int norm) {
  using S = Stencil<K>;
  constexpr int R = S::R, SW = BX + 2 * R, SH = BY + 2 * R;
  __shared__ float tile[SH * SW];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const bool inside = x < W && y < H;
  const int64_t plane = (int64_t)H * W;
  const int64_t idx = inside ? (int64_t)y * W + x : 0;
  const float* sp = sparse ? sparse + b * sp_bstride : nullptr;
  const bool m = inside && sp && sp[idx] > 0.0f;
  const float* c = tile + (threadIdx.y + R) * SW + threadIdx.x + R;

  float acc[S::N];
#pragma unroll
  for (int n = 0; n < S::N; ++n) acc[n] = 0.0f;
  float acc0 = 0.0f, dsp = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const float* d = stash + ((int64_t)b * T + t) * plane;
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.y * BX + threadIdx.x; i < SH * SW; i += BX * BY) {
      const int gy = y0 - R + i / SW, gx = x0 - R + i % SW;
      tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    ? d[(int64_t)gy * W + gx] : 0.0f;
    }
    __syncthreads();
    if (inside) {
      const float lam = t == T - 1
          ? grad_out[b * go_bstride + idx]
          : lam_stash[((int64_t)b * (T - 1) + t) * plane + idx];
      const float lam_u = m ? 0.0f : lam;
      dsp += m ? lam : 0.0f;
      acc0 = fmaf(lam_u, c[0], acc0);
#pragma unroll
      for (int n = 0; n < S::N; ++n)
        acc[n] = fmaf(lam_u, c[S::dy(n) * SW + S::dx(n)], acc[n]);
    }
  }
  if (!inside) return;

  // The anchor's gradients, then the normalization's chain rule with
  // Ghat_n = G_n - G_0, c1 = sum_n Ghat_n gate_n, den = max(s, floor),
  // s = sum_n |g_n|, active = [s > floor] (csrc/cspn_bwd.cu's):
  //   signed norms: (Ghat_l - active sign(g_l) c1) / den
  //   8sum_abs:     sign(g_l) (Ghat_l - active c1) / den.
  const float l0 = lam0[b * lam0_bstride + idx];
  d_blur[b * plane + idx] = m ? 0.0f : l0;
  d_sparse[b * plane + idx] = dsp + (m ? l0 : 0.0f);
  const float* g = guid + b * guid_bstride;
  float s = 0.0f, dot = 0.0f;
#pragma unroll
  for (int n = 0; n < S::N; ++n) {
    const float a = g[n * plane + idx];
    s += fabsf(a);
    dot = fmaf(acc[n] - acc0, norm == kSumAbs ? fabsf(a) : a, dot);
  }
  const float fl = floor_of(norm);
  const float den = fmaxf(s, fl);
  const float c1 = s > fl ? dot / den : 0.0f;   // active c1
  float* dg = d_guid + b * (int64_t)S::N * plane;
#pragma unroll
  for (int n = 0; n < S::N; ++n) {
    const float sg = sign_of(g[n * plane + idx]);
    const float ghat = acc[n] - acc0;
    dg[n * plane + idx] = norm == kSumAbs ? sg * (ghat - c1) / den
                                          : (ghat - sg * c1) / den;
  }
}

// One call: the inputs, the outputs and the scratch.
struct Call {
  const float* guid;
  int64_t guid_bstride;
  const float* blur;        // forward
  int64_t blur_bstride;
  const float* sparse;
  int64_t sp_bstride;
  const float* grad_out;    // adjoint
  int64_t go_bstride;
  float* out;               // forward: d^T
  float* ping;              // forward without a stash: d's other plane
  float* stash;             // (B, T, H, W): written forward, read backward
  float* prep;              // (B, 2, H, W) scratch: g0, inv
  float* lam_stash;         // adjoint: (B, T - 1, H, W) scratch
  float* d_guid;            // adjoint outputs
  float* d_blur;            // (lam^0 lives here until the sums)
  float* d_sparse;
  int B, H, W, T, norm;
  cudaStream_t stream;
};

template <int K>
int forward(const Call& c) {
  const int64_t plane = (int64_t)c.H * c.W;
  const dim3 block(BX, BY);
  const dim3 grid((c.W + BX - 1) / BX, (c.H + BY - 1) / BY, c.B);
  // d^t: stash[:, t] (t < T) and out (t = T) with a stash; without one,
  // out where T - t is even, else ping.
  auto at = [&](int t, int64_t* bstride) -> float* {
    if (t == c.T) {
      *bstride = plane;
      return c.out;
    }
    if (c.stash) {
      *bstride = (int64_t)c.T * plane;
      return c.stash + t * plane;
    }
    *bstride = plane;
    return (c.T - t) % 2 == 0 ? c.out : c.ping;
  };
  int64_t d_bstride;
  float* d = at(0, &d_bstride);
  cspn_kxk_prep<K><<<grid, block, 0, c.stream>>>(
      c.guid, c.guid_bstride, c.blur, c.blur_bstride, c.sparse, c.sp_bstride,
      c.prep, d, d_bstride, c.H, c.W, c.norm);
  cudaError_t err = cudaGetLastError();
  for (int t = 0; t < c.T && err == cudaSuccess; ++t) {
    int64_t next_bstride;
    float* next = at(t + 1, &next_bstride);
    cspn_kxk_step<K><<<grid, block, 0, c.stream>>>(
        c.guid, c.guid_bstride, c.prep, c.sparse, c.sp_bstride, d, d_bstride,
        next, next_bstride, c.H, c.W, c.norm);
    err = cudaGetLastError();
    d = next;
    d_bstride = next_bstride;
  }
  return (int)err;
}

template <int K>
int adjoint(const Call& c) {
  const int64_t plane = (int64_t)c.H * c.W;
  const dim3 block(BX, BY);
  const dim3 grid((c.W + BX - 1) / BX, (c.H + BY - 1) / BY, c.B);
  cspn_kxk_adjoint_prep<K><<<grid, block, 0, c.stream>>>(
      c.guid, c.guid_bstride, c.prep, c.H, c.W, c.norm);
  cudaError_t err = cudaGetLastError();
  // lam^{t+1}: grad_out for t = T - 1, else lam_stash[:, t]; lam^0 goes to
  // d_blur, which the sums overwrite with (1 - m) lam^0 pixel by pixel.
  const float* lam = c.grad_out;
  int64_t lam_bstride = c.go_bstride;
  const int64_t stash_bstride = (int64_t)(c.T - 1) * plane;
  for (int t = c.T - 1; t >= 0 && err == cudaSuccess; --t) {
    float* next = t > 0 ? c.lam_stash + (t - 1) * plane : c.d_blur;
    const int64_t next_bstride = t > 0 ? stash_bstride : plane;
    cspn_kxk_adjoint_step<K><<<grid, block, 0, c.stream>>>(
        c.guid, c.guid_bstride, c.prep, c.sparse, c.sp_bstride, lam,
        lam_bstride, next, next_bstride, c.H, c.W, c.norm);
    err = cudaGetLastError();
    lam = next;
    lam_bstride = next_bstride;
  }
  if (err != cudaSuccess) return (int)err;
  cspn_kxk_adjoint_sums<K><<<grid, block, 0, c.stream>>>(
      c.guid, c.guid_bstride, c.sparse, c.sp_bstride, c.grad_out,
      c.go_bstride, c.stash, c.lam_stash, lam, lam_bstride, c.d_guid,
      c.d_blur, c.d_sparse, c.H, c.W, c.T, c.norm);
  return (int)cudaGetLastError();
}

// Kernel sizes 5 and 7.
int run(const Call& c, int K, bool backward) {
  if (K == 5) return backward ? adjoint<5>(c) : forward<5>(c);
  if (K == 7) return backward ? adjoint<7>(c) : forward<7>(c);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The forward of raw guidance (B, k^2 - 1, H, W) (batch stride
// guid_bstride, in elements), blur and sparse (B, H, W) (sparse may be
// null: no anchors) into out (contiguous (B, H, W)). prep: contiguous
// (B, 2, H, W) scratch. With a stash (contiguous (B, T, H, W)), writes d^t
// to stash[b, t] and ping may be null; without one, ping is a contiguous
// (B, H, W) scratch. Launches T + 1 kernels on `stream`; returns
// cudaGetLastError() of the first failing launch.
int cspn_kxk_fwd(const float* guid, int64_t guid_bstride,
                 const float* blur, int64_t blur_bstride,
                 const float* sparse, int64_t sp_bstride, float* out,
                 float* prep, float* ping, float* stash, int B, int H, int W,
                 int T, int K, int norm, void* stream) {
  Call c{guid, guid_bstride, blur, blur_bstride, sparse, sp_bstride,
         nullptr, 0, out, ping, stash, prep, nullptr, nullptr, nullptr,
         nullptr, B, H, W, T, norm, (cudaStream_t)stream};
  return run(c, K, false);
}

// The adjoint over cspn_kxk_fwd's stash (contiguous (B, T, H, W)) for the
// cotangent grad_out (B, H, W), batch stride go_bstride: d_guid
// (contiguous (B, k^2 - 1, H, W)), d_blur, d_sparse (contiguous (B, H,
// W); d_sparse is zero without a sparse map). prep: contiguous (B, 2, H,
// W) scratch; lam_stash: contiguous (B, T - 1, H, W) scratch (null for
// T <= 1). Launches T + 2 kernels.
int cspn_kxk_bwd(const float* guid, int64_t guid_bstride,
                 const float* sparse, int64_t sp_bstride,
                 const float* grad_out, int64_t go_bstride,
                 const float* stash, float* d_guid, float* d_blur,
                 float* d_sparse, float* prep, float* lam_stash, int B,
                 int H, int W, int T, int K, int norm, void* stream) {
  Call c{guid, guid_bstride, nullptr, 0, sparse, sp_bstride, grad_out,
         go_bstride, nullptr, nullptr, const_cast<float*>(stash), prep,
         lam_stash, d_guid, d_blur, d_sparse, B, H, W, T, norm,
         (cudaStream_t)stream};
  return run(c, K, true);
}

const char* cspn_kxk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
