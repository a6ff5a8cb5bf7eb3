// Train-mode BatchNorm on Hopper (sm_90a), for models/resnet.py:BatchNorm2d
// in train mode on one card: the batch statistics of an (N, C, H, W)
// tensor, its normalization and its backward. C entries:
//   batch_norm_fwd  y = w (x - mean) invstd + b with the mean and biased
//                   variance over (N, H, W) in f32; writes mean and invstd
//                   for the backward and folds mean and the biased variance
//                   into the running statistics in place (flax's update);
//   batch_norm_bwd  dx = (dy - (x - mean) proj_scale - sum(dy) / n)
//                   invstd w with proj_scale = sum(dy (x - mean)) invstd^2
//                   / n, dweight = sum(dy (x - mean)) invstd, dbias =
//                   sum(dy), in f32.
// No TPU kernel has this function: the JAX package leaves BatchNorm to XLA.
// It replaces ATen's kernels for a contiguous NCHW input
// (ATen/native/cuda/Normalization.cuh: batch_norm_collect_statistics_kernel,
// batch_norm_transform_input_kernel, batch_norm_backward_kernel), which run
// one block of 512 threads a channel through every pass: at the 64-channel
// full-resolution sites of the decoder, which hold most of the bytes, 64
// blocks then stream millions of elements each on 132 SMs, 2 bytes a load.
// Every kernel's name starts with batch_norm_, by which a trace files it.
//
// The numbers are ATen's, bit for bit where its sums are kept in order:
// the benchmark's reference runs those kernels, and its gradient check
// reads the BatchNorm parameters' gradients of a ResNet's first stages,
// which bf16 roundings move by 13-25 % of a leaf's norm from f32 (the train
// cells' first step). Sums taken exactly in f32 read a grad_gap of 0.19
// against it in kitti1216-train-b8, where the limit is 0.04; ATen's mean
// and invstd with this backward 0.0044 (H100, seed 3100000007). So:
// * forward statistics: ATen's 512 threads a channel (bdx x 512 / bdx,
//   bdx = aten_threads(H W) in ops/batch_norm.py), thread (tx, ty) folding
//   x at hw = tx (mod bdx) of the images n = ty (mod 512 / bdx) into a
//   Welford count, mean and M2 in order; its XOR-shuffle merges within
//   each warp, then over the 16 warps; invstd = rsqrt(M2 / N + eps) (ATen's
//   batch_norm_update_stats_and_invert). Pass 1 runs those threads, a block
//   of kStatThreads of them, kAhead loads ahead of their updates; pass 2,
//   a block of 512 a channel, their merges.
// * backward sums: the same threads' sums of dy and of dy (x - mean), each
//   product rounded to x's dtype (ATen's GradOp builds its terms in the
//   input's type), then its block reduction, which rounds each shuffled
//   partial sum to x's dtype too (Float2's warp_shfl_down). Pass 1 takes
//   the threads' sums by parts, a block for a part of a plane of some of a
//   ty's images, each real thread owning VEC of them; pass 2, a block of
//   512 a channel, adds each thread's parts in order and runs the tree.
// * y and dx in ATen's expressions.
//
// Bound on an H100 SXM (3.35 TB/s), bytes an element of x in bf16 (twice
// as many in f32), each input read once and each output written once:
// forward 4 (x, y), backward 6 (x, dy, dx). Each direction takes two
// passes over the data, because every output waits on its channel's sums
// and a channel does not fit on one SM (6.8 MB in bf16 at the decoder's
// last block at KITTI's batch 8), so their floor is forward 6 (x read by
// the statistics pass and again by the normalizing pass, y written) and
// backward 10 (x and dy read by the sums pass and again by the dx pass, dx
// written).
//
// Design of the passes over the data:
// * The forward's statistics: the 512 threads of a channel are all there
//   is to run in parallel (each one's Welford updates are a chain), so the
//   pass loads kAhead elements a thread ahead of them.
// * The backward's sums and the two elementwise passes are cut further:
//   the sums by images and parts of planes (ops/batch_norm.py:sum_plan, ~2048
//   blocks), the elementwise passes into S slices a channel of equal
//   length, S = ceil(1024 / C) but no slice under 8192 elements
//   (ops/batch_norm.py:slices), so that a pass runs ~1024 blocks of 256
//   threads: 16 slices at 64 channels, 1 from 1024 channels.
// * A channel's elements are rows of contiguous elements: each image's
//   (H, W) plane where its rows are W apart, else each row of W (a cropped
//   view, whose rows are further apart). A thread of those passes reads VEC
//   elements, 16 B, a load where every tensor's base, strides and row
//   length allow it, and fewer where they do not.
// * No atomics: every sum is taken in a fixed order, so two runs agree bit
//   for bit.
//
// Built by ops/cspn_cuda.py with nvcc -gencode arch=compute_90a,code=sm_90a
// into a shared library with the plain C interface below, bound by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // a block
constexpr int kUnroll = 4;      // loads in flight a thread
constexpr int kStatThreads = 128;   // a block of the forward's first pass
constexpr int kAhead = 16;          // its loads in flight a thread

enum DType { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back: the precision in which ATen's
// batch_norm_backward_kernel takes the products dy (x - mean) and the
// partial sums its reduction shuffles.
template <typename T>
__device__ __forceinline__ float in_dtype(float v) {
  return to_f32(from_f32<T>(v));
}

// The integer type of one load or store of BYTES bytes.
template <int BYTES>
struct Bits;
template <>
struct Bits<2> { typedef unsigned short type; };
template <>
struct Bits<4> { typedef unsigned int type; };
template <>
struct Bits<8> { typedef uint2 type; };
template <>
struct Bits<16> { typedef uint4 type; };

// VEC elements of T, loaded as one access of their bytes.
template <typename T, int VEC>
struct Vec {
  typedef typename Bits<sizeof(T) * VEC>::type B;
  B bits;
  __device__ __forceinline__ float get(int i) const {
    return to_f32(reinterpret_cast<const T*>(&bits)[i]);
  }
};

// The 32 bits of elements 2k, 2k + 1 of bf16 o, or of element k of f32 o.
template <typename T>
__device__ __forceinline__ unsigned int word(const float* o, int k);
template <>
__device__ __forceinline__ unsigned int word<float>(const float* o, int k) {
  return __float_as_uint(o[k]);
}
template <>
__device__ __forceinline__ unsigned int word<bf16>(const float* o, int k) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16(o[2 * k])) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16(o[2 * k + 1]))
          << 16);
}

// o's VEC values in T, packed into one access of their bytes.
template <typename T, int VEC>
__device__ __forceinline__ typename Vec<T, VEC>::B pack(const float* o) {
  constexpr int kBytes = sizeof(T) * VEC;
  if constexpr (kBytes == 2) {
    return __bfloat16_as_ushort(__float2bfloat16(o[0]));
  } else if constexpr (kBytes == 4) {
    return word<T>(o, 0);
  } else if constexpr (kBytes == 8) {
    return make_uint2(word<T>(o, 0), word<T>(o, 1));
  } else {
    return make_uint4(word<T>(o, 0), word<T>(o, 1), word<T>(o, 2),
                      word<T>(o, 3));
  }
}

// Element strides of an (N, C, H, W) tensor; W's is 1.
struct Strides {
  int64_t n, c, h;
};

// A channel's elements as `rows` rows of `len` contiguous elements,
// `per_image` rows an image (1 where a row is a whole plane), cut into
// `slices` slices of vectors of VEC elements.
struct Rows {
  int rows, len, per_image, slices;
};

// Slice s of a channel: vectors [*beg, *end) of its rows * len / VEC.
template <int VEC>
__device__ __forceinline__ void slice_of(const Rows& g, int s, int* beg,
                                         int* end) {
  const int total = g.rows * (g.len / VEC);
  const int per = (total + g.slices - 1) / g.slices;
  *beg = min(s * per, total);
  *end = min(*beg + per, total);
}

// visit(n, h, lo, hi) for each row that vectors [beg, end) of a channel
// touch: image n, row h of the image (0 where a row is a plane), the row's
// vectors [lo, hi).
template <int VEC, typename Visit>
__device__ __forceinline__ void walk(const Rows& g, int beg, int end,
                                     Visit&& visit) {
  const int lv = g.len / VEC;
  for (int r = beg / lv; r * lv < end; ++r) {
    const int n = r / g.per_image;
    visit(n, r - n * g.per_image, max(beg - r * lv, 0),
          min(end - r * lv, lv));
  }
}

// Vector j of a row: elements j VEC .. j VEC + VEC - 1.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> vec_at(const T* row, int j) {
  Vec<T, VEC> v;
  v.bits = *reinterpret_cast<const typename Vec<T, VEC>::B*>(
      row + (int64_t)j * VEC);
  return v;
}

// Stores o's VEC values as vector j of a row.
template <typename T, int VEC>
__device__ __forceinline__ void vec_put(T* row, int j, const float* o) {
  *reinterpret_cast<typename Vec<T, VEC>::B*>(row + (int64_t)j * VEC) =
      pack<T, VEC>(o);
}

// The layout of ATen's blocks over a channel: bdx x 512 / bdx threads,
// and how the backward's sums pass covers the planes (images of a ty a
// block, parts of chunk elements).
struct SumPlan {
  int n, h, w, merged, bdx, images, groups, parts, chunk;
};

// Pass 1 forward: the Welford state (count, mean, M2) of each of ATen's
// virtual threads (tx, ty) of channel c, as its
// batch_norm_collect_statistics_kernel's thread (tx, ty) builds it: over
// the images n = ty (mod 512 / bdx), then hw = tx (mod bdx), in order.
// Block b of a channel holds virtual threads b kStatThreads .. + kStatThreads
// - 1; each loads kAhead elements ahead of its updates.
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
batch_norm_stats(const T* __restrict__ x, Strides xs, SumPlan q,
                 float* __restrict__ state) {
  const int per = 512 / kStatThreads;
  const int c = blockIdx.x / per;
  const int tid = (blockIdx.x % per) * kStatThreads + threadIdx.x;
  const int tx = tid % q.bdx, ty = tid / q.bdx, bdy = 512 / q.bdx;
  const int hw = q.h * q.w;
  int n = 0;
  float avg = 0.f, var_n = 0.f;
  for (int batch = ty; batch < q.n; batch += bdy) {
    const T* plane = x + c * xs.c + batch * xs.n;
    for (int x0 = tx; x0 < hw; x0 += q.bdx * kAhead) {
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int at = x0 + u * q.bdx;
        v[u] = at < hw ? to_f32(plane[q.merged ? at : (at / q.w) * xs.h +
                                                       at % q.w])
                       : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (x0 + u * q.bdx < hw) {
          const float d1 = v[u] - avg;
          n++;
          avg += d1 / n;
          var_n += d1 * (v[u] - avg);
        }
      }
    }
  }
  float* out = state + (int64_t)c * 3 * 512;
  out[tid] = (float)n;
  out[512 + tid] = avg;
  out[1024 + tid] = var_n;
}

// One step of ATen's Welford merge across lanes (its XOR shuffles).
__device__ __forceinline__ void welford_xor(int* n, float* avg,
                                            float* var_n, int mask) {
  const float o_avg = __shfl_xor_sync(0xffffffffu, *avg, mask, 32);
  const int o_n = __shfl_xor_sync(0xffffffffu, *n, mask, 32);
  const float factor = 1.0 / fmaxf(1.0, *n + o_n);
  *var_n += __shfl_xor_sync(0xffffffffu, *var_n, mask, 32) +
            (*avg - o_avg) * (*avg - o_avg) * *n * o_n * factor;
  *avg = (*n * *avg + o_n * o_avg) * factor;
  *n += o_n;
}

// Pass 2 forward, a block of 512 a channel: the virtual threads' states
// merged as ATen's kernel merges them (within each warp, then across the
// 16 warps), mean and invstd = rsqrt(M2 / N + eps) as ATen writes them;
// and the running statistics folded in place with the biased variance.
__global__ void __launch_bounds__(512)
batch_norm_stats_merge(SumPlan q, const float* __restrict__ state,
                       float* running_mean, float* running_var,
                       float* save_mean, float* save_invstd, float momentum,
                       float eps) {
  __shared__ int shared_n[32];
  __shared__ float shared_avg_var[64];
  const int c = blockIdx.x, tid = threadIdx.x;
  const float* in = state + (int64_t)c * 3 * 512;
  int n = (int)in[tid];
  float avg = in[512 + tid], var_n = in[1024 + tid];
  for (int i = 0; i < 5; ++i) welford_xor(&n, &avg, &var_n, 1 << i);
  __syncthreads();
  if (tid % 32 == 0) {
    shared_n[tid / 32] = n;
    shared_avg_var[tid / 32 * 2] = avg;
    shared_avg_var[tid / 32 * 2 + 1] = var_n;
  }
  __syncthreads();
  if (tid < 32) {
    n = tid < 16 ? shared_n[tid] : 0;
    avg = tid < 16 ? shared_avg_var[2 * tid] : 0.f;
    var_n = tid < 16 ? shared_avg_var[2 * tid + 1] : 0.f;
  }
  for (int i = 0; i < 5; ++i) welford_xor(&n, &avg, &var_n, 1 << i);
  if (tid == 0) {
    const int count = q.n * q.h * q.w;
    const float var = var_n / count;   // biased
    // As ATen's batch_norm_update_stats_and_invert takes it.
    const float invstd = var == 0.f && eps == 0.f ? 0.f : rsqrtf(var + eps);
    save_mean[c] = avg;
    save_invstd[c] = invstd;
    running_mean[c] = (1.f - momentum) * running_mean[c] + momentum * avg;
    running_var[c] = (1.f - momentum) * running_var[c] + momentum * var;
  }
}

// Pass 3 forward: y = w (x - mean) invstd + b over block (c, s)'s slice, as
// ATen's batch_norm_transform_input_kernel writes it.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
batch_norm_apply(const T* __restrict__ x, Strides xs, T* __restrict__ y,
                 Strides ys, Rows g, const float* __restrict__ weight,
                 const float* __restrict__ bias,
                 const float* __restrict__ save_mean,
                 const float* __restrict__ save_invstd) {
  const int c = blockIdx.x / g.slices, s = blockIdx.x - c * g.slices;
  const float gamma = weight[c], beta = bias[c];
  const float mean = save_mean[c], invstd = save_invstd[c];
  int beg, end;
  slice_of<VEC>(g, s, &beg, &end);
  walk<VEC>(g, beg, end, [&](int n, int h, int lo, int hi) {
    const T* xrow = x + c * xs.c + n * xs.n + h * xs.h;
    T* yrow = y + c * ys.c + n * ys.n + h * ys.h;
    for (int j = lo + (int)threadIdx.x; j < hi; j += kThreads * kUnroll) {
      Vec<T, VEC> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + u * kThreads < hi)
          v[u] = vec_at<T, VEC>(xrow, j + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u * kThreads < hi) {
          float o[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            o[i] = gamma * (v[u].get(i) - mean) * invstd + beta;
          vec_put<T, VEC>(yrow, j + u * kThreads, o);
        }
      }
    }
  });
}

// The backward's channel sums as ATen's batch_norm_backward_kernel takes
// them (see the note at the top): per virtual thread (tx, ty) of its block
// of bdx x bdy = 512 threads, the sums of dy and of dy (x - mean), each
// product rounded to T, over the elements at hw = tx (mod bdx) of the
// images n = ty (mod bdy); then its block reduction. A block of pass 1
// covers, for one ty, `images` of those images (group kg) and one part of
// `chunk` (a multiple of bdx) elements of each plane.

// Pass 1 backward: block (c, ty, kg, p) sums, for each virtual tx, thread
// t owning tx = t VEC .. t VEC + VEC - 1, to partial[(((c bdy + ty) groups
// + kg) parts + p) bdx + tx] (sum dy, sum dy (x - mean)).
template <typename T, int VEC>
__global__ void __launch_bounds__(512)
batch_norm_grad_stats(const T* __restrict__ dy, Strides ds,
                      const T* __restrict__ x, Strides xs, SumPlan q,
                      const float* __restrict__ mean,
                      float2* __restrict__ partial) {
  const int bdy = 512 / q.bdx;
  int i = blockIdx.x;
  const int p = i % q.parts;
  i /= q.parts;
  const int kg = i % q.groups;
  i /= q.groups;
  const int ty = i % bdy, c = i / bdy;
  const float mu = mean[c];
  const int start = p * q.chunk;
  const int stop = min(start + q.chunk, q.h * q.w);
  float a[VEC], b[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) a[k] = b[k] = 0.f;
  for (int m = 0; m < q.images; ++m) {
    const int n = ty + bdy * (kg * q.images + m);
    if (n >= q.n) break;
    const T* drow = dy + c * ds.c + n * ds.n;
    const T* xrow = x + c * xs.c + n * xs.n;
    for (int hw = start + (int)threadIdx.x * VEC; hw < stop;
         hw += q.bdx * kUnroll) {
      Vec<T, VEC> d[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int at = hw + u * q.bdx;
        if (at < stop) {
          // A merged plane is one row; a cropped one is read row by row, an
          // element a load.
          d[u] = vec_at<T, VEC>(
              drow + (q.merged ? at : (at / q.w) * ds.h + at % q.w), 0);
          v[u] = vec_at<T, VEC>(
              xrow + (q.merged ? at : (at / q.w) * xs.h + at % q.w), 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (hw + u * q.bdx < stop) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float gy = d[u].get(k);
            a[k] += gy;
            b[k] += in_dtype<T>(gy * (v[u].get(k) - mu));
          }
        }
      }
    }
  }
  float2* out = partial + (int64_t)blockIdx.x * q.bdx + threadIdx.x * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = make_float2(a[k], b[k]);
}

// One step of ATen's warp reduction (WarpReduce with its Float2's
// warp_shfl_down): lane l < off adds lane l + off's sums, rounded to T.
template <typename T>
__device__ __forceinline__ void warp_step(float* sa, float* sb, float* a,
                                          float* b, int off) {
  const int t = threadIdx.x, lane = t % 32;
  float na = *a, nb = *b;
  if (lane < off) {
    na += in_dtype<T>(sa[t + off]);
    nb += in_dtype<T>(sb[t + off]);
  }
  __syncthreads();
  *a = na;
  *b = nb;
  sa[t] = na;
  sb[t] = nb;
  __syncthreads();
}

// Pass 2 backward: channel c's sums from its virtual threads' partials
// and ATen's BlockReduce over its 512 threads (a warp tree, then one over
// the 16 warps' sums); writes sums[2 c], sums[2 c + 1] (sum dy, sum dy
// (x - mean)), dweight and dbias.
template <typename T>
__global__ void __launch_bounds__(512)
batch_norm_grad_reduce(SumPlan q, const float2* __restrict__ partial,
                       const float* __restrict__ invstd, float* sums,
                       float* dweight, float* dbias) {
  __shared__ float sa[512], sb[512];
  const int c = blockIdx.x, t = threadIdx.x;
  const int tx = t % q.bdx, ty = t / q.bdx, bdy = 512 / q.bdx;
  const int per = q.groups * q.parts;
  const float2* mine = partial + (int64_t)(c * bdy + ty) * per * q.bdx + tx;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < per; ++k) {
    a += mine[k * q.bdx].x;
    b += mine[k * q.bdx].y;
  }
  sa[t] = a;
  sb[t] = b;
  __syncthreads();
  for (int off = 16; off > 0; off >>= 1) warp_step<T>(sa, sb, &a, &b, off);
  // Warp w's sums are lane 0's: sa[32 w]. Warp 0 then reduces the 16 of
  // them, its other lanes 0.
  const float wa = t < 16 ? sa[32 * t] : 0.f, wb = t < 16 ? sb[32 * t] : 0.f;
  __syncthreads();
  a = wa;
  b = wb;
  sa[t] = a;
  sb[t] = b;
  __syncthreads();
  for (int off = 16; off > 0; off >>= 1) warp_step<T>(sa, sb, &a, &b, off);
  if (t == 0) {
    sums[2 * c] = a;
    sums[2 * c + 1] = b;
    dbias[c] = a;
    dweight[c] = b * invstd[c];
  }
}

// Pass 3 backward: dx over block (c, s)'s slice, as ATen's kernel writes
// it: (dy - (x - mean) proj_scale - grad_mean) grad_scale.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
batch_norm_grad_apply(const T* __restrict__ dy, Strides ds,
                      const T* __restrict__ x, Strides xs,
                      T* __restrict__ dx, Strides dxs, Rows g,
                      const float* __restrict__ sums,
                      const float* __restrict__ weight,
                      const float* __restrict__ mean_,
                      const float* __restrict__ invstd_) {
  const int c = blockIdx.x / g.slices, s = blockIdx.x - c * g.slices;
  const float mean = mean_[c], invstd = invstd_[c];
  const float norm = 1.f / (float)(g.rows * g.len);
  const float grad_mean = sums[2 * c] * norm;
  const float proj_scale = sums[2 * c + 1] * norm * invstd * invstd;
  const float grad_scale = invstd * weight[c];
  int beg, end;
  slice_of<VEC>(g, s, &beg, &end);
  walk<VEC>(g, beg, end, [&](int n, int h, int lo, int hi) {
    const T* drow = dy + c * ds.c + n * ds.n + h * ds.h;
    const T* xrow = x + c * xs.c + n * xs.n + h * xs.h;
    T* orow = dx + c * dxs.c + n * dxs.n + h * dxs.h;
    for (int j = lo + (int)threadIdx.x; j < hi; j += kThreads * kUnroll) {
      Vec<T, VEC> d[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u * kThreads < hi) {
          d[u] = vec_at<T, VEC>(drow, j + u * kThreads);
          v[u] = vec_at<T, VEC>(xrow, j + u * kThreads);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u * kThreads < hi) {
          float o[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float go = d[u].get(i);
            const float proj = (v[u].get(i) - mean) * proj_scale;
            o[i] = (go - proj - grad_mean) * grad_scale;
          }
          vec_put<T, VEC>(orow, j + u * kThreads, o);
        }
      }
    }
  });
}

// f(T(), std::integral_constant<int, VEC>()) for the dtype and VEC the
// wrapper picked: f32 with 1, 2 or 4 elements a load, bf16 with 1 to 8.
template <typename F>
int dispatch(int dtype, int vec, F&& f) {
  using std::integral_constant;
  if (dtype == kF32) {
    switch (vec) {
      case 1: return f(float(), integral_constant<int, 1>());
      case 2: return f(float(), integral_constant<int, 2>());
      case 4: return f(float(), integral_constant<int, 4>());
    }
  } else if (dtype == kBF16) {
    switch (vec) {
      case 1: return f(bf16(), integral_constant<int, 1>());
      case 2: return f(bf16(), integral_constant<int, 2>());
      case 4: return f(bf16(), integral_constant<int, 4>());
      case 8: return f(bf16(), integral_constant<int, 8>());
    }
  }
  return (int)cudaErrorInvalidValue;
}

Rows rows_of(int n, int h, int w, int merged, int slices) {
  return merged ? Rows{n, h * w, 1, slices} : Rows{n * h, w, h, slices};
}

}  // namespace

extern "C" {

// The forward of x (N, C, H, W) in f32 (dtype 0) or bf16 (dtype 1), element
// strides (xn, xc, xh) and W's 1, into y with strides (yn, yc, yh); each
// image's plane taken as one row (`merged`, where every tensor's rows are W
// apart) or row by row; `vec` elements a load and `slices` blocks a channel
// in the y pass; bdx as ATen's (ops/batch_norm.py:aten_threads). weight,
// bias, the running statistics (updated in place) and save_mean,
// save_invstd (written) are f32 (C); scratch is f32 of 3 x 512 C.
// Returns cudaGetLastError() of the first failing launch.
int batch_norm_fwd(const void* x, int64_t xn, int64_t xc, int64_t xh,
                   void* y, int64_t yn, int64_t yc, int64_t yh, int n, int c,
                   int h, int w, int merged, int vec, int dtype, int slices,
                   int bdx, const float* weight, const float* bias,
                   float* running_mean, float* running_var, float* save_mean,
                   float* save_invstd, float* scratch, float momentum,
                   float eps, cudaStream_t stream) {
  const Rows g = rows_of(n, h, w, merged, slices);
  const SumPlan q{n, h, w, merged, bdx, 1, 1, 1, 1};
  const Strides xs{xn, xc, xh}, ys{yn, yc, yh};
  return dispatch(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    batch_norm_stats<T><<<c * (512 / kStatThreads), kStatThreads, 0,
                          stream>>>(static_cast<const T*>(x), xs, q,
                                    scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    batch_norm_stats_merge<<<c, 512, 0, stream>>>(
        q, scratch, running_mean, running_var, save_mean, save_invstd,
        momentum, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    batch_norm_apply<T, V><<<c * slices, kThreads, 0, stream>>>(
        static_cast<const T*>(x), xs, static_cast<T*>(y), ys, g, weight,
        bias, save_mean, save_invstd);
    return (int)cudaGetLastError();
  });
}

// The backward: dy and x as batch_norm_fwd's x (one dtype), dx written
// with strides (dxn, dxc, dxh); weight, mean and invstd (the forward's
// save_mean, save_invstd) f32 (C) in, dweight and dbias f32 (C) out. The
// sums pass (SumPlan) reads `sum_vec` elements a load (1 where not merged)
// in blocks of bdx / sum_vec threads; the dx pass as batch_norm_fwd's y
// pass. scratch: f32, 2 C for the sums, then 2 C (512 / bdx) groups parts
// bdx for the partials.
int batch_norm_bwd(const void* dy, int64_t dn, int64_t dc, int64_t dh,
                   const void* x, int64_t xn, int64_t xc, int64_t xh,
                   void* dx, int64_t dxn, int64_t dxc, int64_t dxh, int n,
                   int c, int h, int w, int merged, int vec, int dtype,
                   int slices, int sum_vec, int bdx, int images, int groups,
                   int parts, int chunk,
                   const float* weight, const float* mean,
                   const float* invstd, float* dweight, float* dbias,
                   float* scratch, cudaStream_t stream) {
  const Rows g = rows_of(n, h, w, merged, slices);
  const SumPlan q{n, h, w, merged, bdx, images, groups, parts, chunk};
  const Strides ds{dn, dc, dh}, xs{xn, xc, xh}, dxs{dxn, dxc, dxh};
  float* sums = scratch;
  float2* partial = reinterpret_cast<float2*>(scratch + 2 * c);
  int err = dispatch(dtype, sum_vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    batch_norm_grad_stats<T, V>
        <<<c * (512 / bdx) * groups * parts, bdx / V, 0, stream>>>(
        static_cast<const T*>(dy), ds, static_cast<const T*>(x), xs, q,
        mean, partial);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    batch_norm_grad_reduce<T><<<c, 512, 0, stream>>>(q, partial, invstd,
                                                     sums, dweight, dbias);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  return dispatch(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    batch_norm_grad_apply<T, V><<<c * slices, kThreads, 0, stream>>>(
        static_cast<const T*>(dy), ds, static_cast<const T*>(x), xs,
        static_cast<T*>(dx), dxs, g, sums, weight, mean, invstd);
    return (int)cudaGetLastError();
  });
}

const char* batch_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
