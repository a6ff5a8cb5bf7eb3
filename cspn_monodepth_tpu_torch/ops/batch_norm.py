"""Train-mode BatchNorm on the port's own kernels (csrc/batch_norm.cu).

`batch_norm_train(x, weight, bias, running_mean, running_var, momentum=,
eps=)` is what models/resnet.py:BatchNorm2d calls in train mode on one
card (the CPU and the mesh's global statistics keep their own code); each
call counts one `bn.train_calls` (utils/profiling.py). It is
`BatchNormTrainFunction`: the forward normalizes x (N, C, H, W) with its
batch mean and biased variance over (N, H, W), reduced in f32 also for a
bf16 x, and folds them into the running statistics in place with
`momentum` (flax's update: the biased variance, where torch's own update
takes the unbiased one); the backward gives dx, dweight and dbias.

The kernels compute ATen's numbers (csrc/batch_norm.cu, its note): its
threads' Welford statistics and its reduction of the backward's sums,
which round to x's dtype where ATen's do, because the benchmark's
reference runs ATen and its gradient check reads those roundings.

The wrappers, each with a `.launches` count of the calls that launched its
kernels:
  batch_norm_train_fwd  ATen's statistics (two passes), then y;
  batch_norm_train_bwd  the sums, ATen's reduction of them (`aten_sums`),
                        then dx.
On CUDA tensors a wrapper launches its kernels or raises; on CPU tensors it
runs its plain version (batch_norm_train_fwd_plain, _bwd_plain), which
computes the same in plain PyTorch, its statistics from float64 sums.

The launch plans come from the shape and the tensors' layout alone: ATen's
threads a channel (`aten_threads`), how the backward's sums pass covers
the planes (`sum_plan`), the slices a channel is cut into in the
elementwise passes, S = `slices(C, N H W)`, whether each image's plane is
one contiguous row, and the elements a load (`plan`).
"""

from __future__ import annotations

import functools
import math

import torch

from cspn_monodepth_tpu_torch.ops import cspn_cuda
from cspn_monodepth_tpu_torch.utils import profiling

# An elementwise pass aims at this many blocks of 256 threads, about what
# an H100's 132 SMs hold at once; a slice reads at least SLICE_MIN
# elements.
PASS_BLOCKS = 1024
SLICE_MIN = 8192
# The backward's sums pass aims at this many blocks (of 64 threads at 16
# bytes a load).
SUM_BLOCKS = 2048
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C entries' codes


def slices(channels: int, per_channel: int) -> int:
    """S, the blocks a channel is cut into: ceil(PASS_BLOCKS / C), fewer
    where a slice would read under SLICE_MIN elements, at least 1. 16 at
    the decoder's 64 channels at full resolution, 1 from 1024 channels."""
    return max(1, min(math.ceil(PASS_BLOCKS / channels),
                      per_channel // SLICE_MIN))


def aten_threads(hw: int) -> int:
    """bdx of ATen's batch_norm_collect_statistics_kernel and
    batch_norm_backward_kernel for planes of hw elements (getNumThreads in
    ATen/native/cuda/Normalization.cuh): the first of 32, 64, 128, 256 that
    holds them, else 512; their blocks are bdx x 512 / bdx."""
    return next((t for t in (32, 64, 128, 256) if hw <= t), 512)


@functools.lru_cache(maxsize=1024)
def sum_plan(n: int, c: int, h: int, w: int, merged: bool,
             vec: int) -> tuple:
    """(sum_vec, bdx, images, groups, parts, chunk) of the backward's sums
    pass: ATen's virtual threads (bdx, 512 / bdx); a block covers `images`
    of a ty's images and `chunk` elements (a multiple of bdx) of each
    plane, so that about SUM_BLOCKS blocks cover the tensor."""
    hw = h * w
    bdx = aten_threads(hw)
    per_ty = _cdiv(n, 512 // bdx)
    images = max(1, min(per_ty, c * n // SUM_BLOCKS))
    parts = max(1, min(_cdiv(SUM_BLOCKS, c * n), _cdiv(hw, 8 * bdx)))
    chunk = _cdiv(_cdiv(hw, parts), bdx) * bdx
    return (vec if merged else 1, bdx, images, _cdiv(per_ty, images),
            _cdiv(hw, chunk), chunk)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(tensors: tuple, shape: tuple) -> tuple[bool, int]:
    """(merged, vec) for kernels that read or write `tensors`, each
    (N, C, H, W) of `shape` with W's stride 1: merged where every tensor's
    rows are W apart, so that an image's plane is one contiguous row; vec
    the most elements, up to 16 bytes, that every load can take aligned."""
    return _plan(tuple(shape), tuple(t.stride() for t in tensors),
                 tuple(t.data_ptr() % 16 for t in tensors),
                 tensors[0].element_size())


@functools.lru_cache(maxsize=1024)
def _plan(shape, strides, offsets, size):
    """plan() of tensors with these strides and base addresses mod 16,
    cached: a call is bound by the host where the tensor is small."""
    n, c, h, w = shape
    merged = h == 1 or all(st[2] == w for st in strides)
    length = h * w if merged else w
    vec = 16 // size
    while vec > 1 and not (length % vec == 0 and all(
            off % (vec * size) == 0 and st[0] % vec == 0
            and st[1] % vec == 0 and (merged or st[2] % vec == 0)
            for st, off in zip(strides, offsets))):
        vec //= 2
    return merged, vec


def batch_norm_train_fwd_plain(x, weight, bias, running_mean, running_var,
                               *, momentum: float, eps: float):
    """The forward in plain PyTorch: (y, mean, invstd), the running
    statistics updated in place. Mean and biased variance from float64
    sums, then y = w (x - mean) invstd + b in float32 (float64 for a
    float64 x), in the kernel's order."""
    acc = torch.promote_types(x.dtype, torch.float32)
    var, mean = torch.var_mean(x.double(), dim=(0, 2, 3), correction=0)
    invstd = torch.rsqrt(var + eps).to(acc)
    var, mean = var.to(acc), mean.to(acc)
    y = weight[:, None, None] * (x.to(acc) - mean[:, None, None]) \
        * invstd[:, None, None] + bias[:, None, None]
    with torch.no_grad():
        running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1 - momentum) * running_var + momentum * var)
    return y.to(x.dtype), mean, invstd


def aten_sums(terms: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The channel sums (C,) of terms (N, C, H, W) as ATen's
    batch_norm_backward_kernel reduces them: the sum of each of its virtual
    threads (tx, ty) (bdx = aten_threads(H W), ty < 512 / bdx) over hw = tx
    (mod bdx) of the images n = ty (mod 512 / bdx), taken here in float64
    and rounded to float32; then a tree over each warp of 32 threads and one
    over the 16 warps' sums, in which each step adds lane l + off's sum,
    rounded to `dtype`, to lane l's."""
    n, c, h, w = terms.shape
    hw = h * w
    bdx = aten_threads(hw)
    bdy = 512 // bdx
    t = terms.double().reshape(n, c, hw)
    t = torch.nn.functional.pad(t, (0, _cdiv(hw, bdx) * bdx - hw,
                                    0, 0, 0, _cdiv(n, bdy) * bdy - n))
    acc = torch.promote_types(dtype, torch.float32)
    virt = t.reshape(-1, bdy, c, _cdiv(hw, bdx), bdx).sum((0, 3))
    lanes = virt.permute(1, 0, 2).reshape(c, 16, 32).to(acc)
    for _ in range(2):
        for off in (16, 8, 4, 2, 1):
            lanes[..., :off] = lanes[..., :off] + lanes[
                ..., off:2 * off].to(dtype).to(acc)
        lanes = torch.nn.functional.pad(lanes[..., 0], (0, 16))[:, None]
    return lanes[:, 0, 0]


def batch_norm_train_bwd_plain(dy, x, weight, mean, invstd):
    """The backward in plain PyTorch: (dx, dweight, dbias). The channel
    sums of dy and of the products dy (x - mean), each rounded to x's
    dtype, as ATen's CUDA kernel takes them (`aten_sums`); dx = (dy - (x -
    mean) proj_scale - grad_mean) grad_scale in float32, in its order."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xmu = x.to(acc) - mean[:, None, None]
    dya = dy.to(acc)
    sum_dy = aten_sums(dya, x.dtype).to(acc)
    dot_p = aten_sums((dya * xmu).to(x.dtype).to(acc), x.dtype).to(acc)
    norm = 1.0 / (x.numel() // x.shape[1])
    proj_scale = dot_p * norm * invstd * invstd
    dx = (dya - xmu * proj_scale[:, None, None]
          - (sum_dy * norm)[:, None, None]) \
        * (invstd * weight)[:, None, None]
    return dx.to(x.dtype), dot_p * invstd, sum_dy


def _check_x(x: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs); checks what the
    kernels need of a CUDA one and raises on anything else."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no BatchNorm kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    n, c, h, w = x.shape
    if not 1 < n * h * w < 2 ** 31:
        raise ValueError(f"{n * h * w} values a channel: the kernels take "
                         f"2 to 2**31 - 1")
    if c * slices(c, n * h * w) >= 2 ** 31:
        raise ValueError(f"{c} channels are beyond the kernels' grid")
    return False


def _check(x: torch.Tensor, maps: dict, vectors: dict):
    """Raises unless each of `maps` is x's shape and dtype with contiguous
    rows and each of `vectors` is a contiguous float32 (C), all on x's
    card."""
    card, shape, dtype = x.get_device(), x.shape, x.dtype
    if all(t.get_device() == card and t.dtype == dtype and t.shape == shape
           and (shape[3] == 1 or t.stride(3) == 1) for t in maps.values()) \
            and all(t.get_device() == card and t.dtype == torch.float32
                    and t.shape == shape[1:2] and t.is_contiguous()
                    for t in vectors.values()):
        return
    for name, t in (*maps.items(), *vectors.items()):
        want = (dtype, shape) if name in maps else (torch.float32,
                                                    shape[1:2])
        if t.get_device() != card:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if (t.dtype, t.shape) != want:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {want[0]} {tuple(want[1])}")
        if name in maps and shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name}'s rows must be contiguous, strides "
                             f"{t.stride()}")
        if name in vectors and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=1024)
def _launch_plan(shape, dtype, strides, offsets):
    """The C entries' (N, C, H, W, merged, vec, dtype code, S) for maps of
    `shape` and `dtype` with these strides and base addresses mod 16 beside
    a fresh contiguous output, cached: a small call is bound by the host."""
    n, c, h, w = shape
    out = (c * h * w, h * w, w, 1)
    merged, vec = _plan(shape, (*strides, out), (*offsets, 0),
                        dtype.itemsize)
    return (n, c, h, w, merged, vec, DTYPES[dtype], slices(c, n * h * w))


def _call(entry: str, x: torch.Tensor, *args) -> None:
    """Launch C entry `entry` on x's card and its current stream; raises if
    a launch failed."""
    with torch.cuda.device(x.device):
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        err = getattr(cspn_cuda._load("batch_norm"), entry)(*args, stream)
    cspn_cuda._raise_on(err, "batch_norm", entry)


def batch_norm_train_fwd(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, running_mean: torch.Tensor,
                         running_var: torch.Tensor, *, momentum: float,
                         eps: float):
    """Train-mode BatchNorm forward: x (N, C, H, W) float32 or bfloat16,
    rows contiguous, any other strides (a cropped view is read in place);
    weight, bias and the running statistics float32 (C). Returns (y, mean,
    invstd): y in x's dtype, contiguous; mean and invstd = 1 / sqrt(var +
    eps) float32 (C), for the backward. Updates the running statistics in
    place with the batch mean and biased variance."""
    if _check_x(x):
        return batch_norm_train_fwd_plain(
            x, weight, bias, running_mean, running_var, momentum=momentum,
            eps=eps)
    _check(x, {"x": x}, {"weight": weight, "bias": bias,
                         "running_mean": running_mean,
                         "running_var": running_var})
    xs = x.stride()
    size = _launch_plan(x.shape, x.dtype, (xs,), (x.data_ptr() % 16,))
    n, c, h, w = size[:4]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    # mean, invstd, then the scratch: 3 floats of state for each of ATen's
    # 512 virtual threads a channel.
    buf = torch.empty(c * (2 + 3 * 512), dtype=torch.float32,
                      device=x.device)
    stats = buf.data_ptr()
    _call("batch_norm_fwd", x, x.data_ptr(), *xs[:3], y.data_ptr(),
          *y.stride()[:3], *size, aten_threads(h * w), weight.data_ptr(),
          bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
          stats, stats + 4 * c, stats + 8 * c, momentum, eps)
    batch_norm_train_fwd.launches += 1
    return y, buf[:c], buf[c:2 * c]


def batch_norm_train_bwd(dy: torch.Tensor, x: torch.Tensor,
                         weight: torch.Tensor, mean: torch.Tensor,
                         invstd: torch.Tensor):
    """Train-mode BatchNorm backward on the forward's mean and invstd: dy
    and x (N, C, H, W) of one dtype, rows contiguous. Returns (dx in x's
    dtype, contiguous; dweight, dbias float32 (C))."""
    if _check_x(x):
        return batch_norm_train_bwd_plain(dy, x, weight, mean, invstd)
    _check(x, {"x": x, "dy": dy}, {"weight": weight, "mean": mean,
                                   "invstd": invstd})
    ds, xs = dy.stride(), x.stride()
    size = _launch_plan(x.shape, x.dtype, (ds, xs),
                        (dy.data_ptr() % 16, x.data_ptr() % 16))
    n, c, h, w, merged, vec = size[:6]
    sums = sum_plan(n, c, h, w, merged, vec)
    bdx, groups, parts = sums[1], sums[3], sums[4]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    # dweight, dbias, then the scratch: the 2 C sums and the partial sums
    # of every virtual thread of every block of the sums pass.
    buf = torch.empty(4 * c + 2 * c * (512 // bdx) * groups * parts * bdx,
                      dtype=torch.float32, device=x.device)
    out = buf.data_ptr()
    _call("batch_norm_bwd", x, dy.data_ptr(), *ds[:3], x.data_ptr(),
          *xs[:3], dx.data_ptr(), *dx.stride()[:3], *size, *sums,
          weight.data_ptr(), mean.data_ptr(), invstd.data_ptr(), out,
          out + 4 * c, out + 8 * c)
    batch_norm_train_bwd.launches += 1
    return dx, buf[:c], buf[c:2 * c]


WRAPPERS = (batch_norm_train_fwd, batch_norm_train_bwd)
for _wrapper in WRAPPERS:
    _wrapper.launches = 0


class BatchNormTrainFunction(torch.autograd.Function):
    """Train-mode BatchNorm: batch_norm_train_fwd forward (the running
    statistics updated in place), batch_norm_train_bwd backward. Saves x,
    weight and the batch's mean and invstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        y, mean, invstd = batch_norm_train_fwd(
            x, weight, bias, running_mean, running_var, momentum=momentum,
            eps=eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        if dy.shape[3] > 1 and dy.stride(3) != 1:
            dy = dy.contiguous()
        dx, dweight, dbias = batch_norm_train_bwd(dy, x, weight, mean,
                                                  invstd)
        return dx, dweight, dbias, None, None, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var, *,
                     momentum: float, eps: float) -> torch.Tensor:
    """Train-mode BatchNorm of x (N, C, H, W) on one process, counting one
    `bn.train_calls`; see the module docstring."""
    profiling.count("bn.train_calls", 1)
    return BatchNormTrainFunction.apply(x, weight, bias, running_mean,
                                        running_var, momentum, eps)
