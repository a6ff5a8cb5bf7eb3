"""The 3 x 3 CSPN's head convolution on the port's own kernels
(csrc/head_conv.cu).

`head_conv(x, conv, pad_h=)` is what models/cspn_net.py:Head calls: the
head's 3 x 3 conv (stride 1, W padded by one pixel, H by `pad_h`: 1 on
whole images, 0 on the rows layout's halo'd window) of the decoder's map
x (B, Cin, H, W) into float32 planes (B, Cout, H + 2 pad_h - 2, W). The
head's output channels pick the path, and nothing else does:
* at most MAX_OUT (the 3 x 3 CSPN's 9 planes): the kernels. x is read as
  it is, bf16 under the model's autocast or f32, and converted to f32 in
  the kernel, so no f32 copy of the map is made or saved; each call counts
  one `head.conv_calls` (utils/profiling.py) inside the span
  `head.forward`. With a gradient wanted, `HeadConvFunction`: forward
  `head_conv3x3_fwd`, backward `head_conv3x3_bwd` (span `head.backward`),
  which gives dx in x's dtype (bf16 rounded to nearest even from the f32
  sum, as autocast's cast of the f32 map's gradient rounds it) and dw, db
  in f32; without one, the registered operator
  `torch.ops.cspn_monodepth_tpu_torch.head_conv3x3` (ops/library.py), so
  that eager serving and an exported program launch the same operator.
* more (CSPN++'s 96 planes, whose GEMM tiles cuDNN fills): cuDNN's float32
  conv of the f32 map with TF32 off, as before.
All arithmetic of the kernels is f32 FMA; their dw and db sums are taken in
a fixed order, so two runs agree bit for bit.

The wrappers, each with a `.launches` count of the calls that launched its
kernels (`WRAPPERS`):
  head_conv3x3_fwd  the forward (one launch);
  head_conv3x3_bwd  dx, then dw and db (a pass that writes each block's
                    partial sums, then their sum in block order).
On CUDA tensors a wrapper launches its kernels or raises; on CPU tensors
it runs its plain version (`head_conv3x3_fwd_plain`, `_bwd_plain`): F.conv2d
of the f32 map and its two input gradients, the CPU's own numbers.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from cspn_monodepth_tpu_torch.ops import cspn_cuda
from cspn_monodepth_tpu_torch.utils import profiling

# The largest head the kernels take: their outputs a thread are compiled
# for 9 (the 3 x 3 CSPN's blur and eight affinities) and 16 (no registered
# configuration has a head of 10 to 16 planes).
MAX_OUT = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C entries' codes


def head_conv3x3_fwd_plain(x, weight, bias, *, pad_h: int):
    """The forward in plain PyTorch: F.conv2d of x in f32."""
    return F.conv2d(x.float(), weight, bias, padding=(pad_h, 1))


def head_conv3x3_bwd_plain(dy, x, weight, *, pad_h: int):
    """The backward in plain PyTorch: (dx in x's dtype, dw, db)."""
    pad = (pad_h, 1)
    dx = torch.nn.grad.conv2d_input(x.shape, weight, dy, padding=pad)
    dw = torch.nn.grad.conv2d_weight(x.float(), weight.shape, dy,
                                     padding=pad)
    return dx.to(x.dtype), dw, dy.sum((0, 2, 3))


def _out_shape(x: torch.Tensor, cout: int, pad_h: int) -> tuple:
    b, _, h, w = x.shape
    return b, cout, h + 2 * pad_h - 2, w


def _check(x: torch.Tensor, weight: torch.Tensor, pad_h: int) -> bool:
    """True for a CPU tensor (the plain version runs); checks what the
    kernels need of a CUDA one and raises on anything else."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no head conv kernel for device {x.device}")
    if x.dim() != 4 or x.dtype not in DTYPES:
        raise ValueError(f"x must be (B, Cin, H, W) float32 or bfloat16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, cin, h, w = x.shape
    if tuple(weight.shape) != (weight.shape[0], cin, 3, 3) or \
            not 0 < weight.shape[0] <= MAX_OUT:
        raise ValueError(f"weight must be (Cout <= {MAX_OUT}, {cin}, 3, 3), "
                         f"got {tuple(weight.shape)}")
    if pad_h not in (0, 1) or h + 2 * pad_h - 2 < 1 or not 0 < b <= 65535:
        raise ValueError(f"no head conv of {tuple(x.shape)} at pad_h "
                         f"{pad_h}")
    if x.numel() >= 2 ** 31 or (h + 15) // 16 > 65535:
        raise ValueError(f"{tuple(x.shape)} is beyond the kernels' index")
    return False


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"expected float32 on {device}, got {t.dtype} on "
                         f"{t.device}")
    return t.contiguous()


def _call(entry: str, device, *args) -> None:
    """Launch C entry `entry` on `device`'s current stream; raises if a
    launch failed."""
    with torch.cuda.device(device):
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        err = getattr(cspn_cuda._load("head_conv"), entry)(*args, stream)
    cspn_cuda._raise_on(err, "head_conv", entry)


def head_conv3x3_fwd(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, *, pad_h: int) -> torch.Tensor:
    """The head's conv of x (B, Cin, H, W), f32 or bf16, with weight (Cout,
    Cin, 3, 3) and bias (Cout) f32: (B, Cout, H + 2 pad_h - 2, W) f32,
    contiguous."""
    if _check(x, weight, pad_h):
        return head_conv3x3_fwd_plain(x, weight, bias, pad_h=pad_h)
    x = x.contiguous()
    weight, bias = _f32(weight, x.device), _f32(bias, x.device)
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    y = torch.empty(_out_shape(x, cout, pad_h), dtype=torch.float32,
                    device=x.device)
    _call("head_conv3x3_fwd", x.device, x.data_ptr(), weight.data_ptr(),
          bias.data_ptr(), y.data_ptr(), b, cin, cout, h, w, pad_h,
          DTYPES[x.dtype])
    head_conv3x3_fwd.launches += 1
    return y


def _scratch_floats(device: torch.device, cin: int) -> int:
    """Room for the weight-gradient pass's partial sums, an upper bound that
    csrc/head_conv.cu fits its blocks into: two blocks an SM, each at most
    MAX_OUT x 64 x 9 sums of dw for each of its blocks of 64 input channels
    and MAX_OUT of db (one block of every channel block where Cin is
    larger)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(2 * sms, cin) * MAX_OUT * (64 * 9 + 1)


def head_conv3x3_bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                     *, pad_h: int):
    """From dy (B, Cout, H', W) f32 and the forward's x and weight: (dx in
    x's dtype and shape, contiguous; dw (Cout, Cin, 3, 3) and db (Cout)
    f32)."""
    if _check(x, weight, pad_h):
        return head_conv3x3_bwd_plain(dy, x, weight, pad_h=pad_h)
    x = x.contiguous()
    weight = _f32(weight, x.device)
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(dy.shape) != _out_shape(x, cout, pad_h):
        raise ValueError(f"dy must be {_out_shape(x, cout, pad_h)}, got "
                         f"{tuple(dy.shape)}")
    dy = _f32(dy, x.device)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty(weight.shape, dtype=torch.float32, device=x.device)
    db = torch.empty(cout, dtype=torch.float32, device=x.device)
    floats = _scratch_floats(x.device, cin)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    _call("head_conv3x3_bwd", x.device, dy.data_ptr(), x.data_ptr(),
          weight.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
          scratch.data_ptr(), floats, b, cin, cout, h, w, pad_h,
          DTYPES[x.dtype])
    head_conv3x3_bwd.launches += 1
    return dx, dw, db


WRAPPERS = (head_conv3x3_fwd, head_conv3x3_bwd)
for _wrapper in WRAPPERS:
    _wrapper.launches = 0


class HeadConvFunction(torch.autograd.Function):
    """The head's conv with the kernels' backward: x (B, Cin, H, W) f32 or
    bf16, weight, bias f32 -> (B, Cout, H', W) f32. Saves x as it is (the
    decoder's last ReLU keeps the same tensor) and the weight."""

    @staticmethod
    def forward(ctx, x, weight, bias, pad_h: int):
        ctx.save_for_backward(x, weight)
        ctx.pad_h = pad_h
        return head_conv3x3_fwd(x, weight, bias, pad_h=pad_h)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        with profiling.span("head.backward"):
            dx, dw, db = head_conv3x3_bwd(dy.contiguous(), x, weight,
                                          pad_h=ctx.pad_h)
        return dx, dw, db, None


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full float32 (TF32 is cuDNN's default)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def head_conv(x: torch.Tensor, conv: nn.Conv2d, *, pad_h: int = 1
              ) -> torch.Tensor:
    """The head `conv` (3 x 3, stride 1, padding 1, with a bias) of x with H
    padded by pad_h: float32 (B, Cout, H + 2 pad_h - 2, W). See the module
    docstring for the two paths."""
    if conv.out_channels > MAX_OUT:
        with no_tf32():
            return F.conv2d(x.float(), conv.weight, conv.bias,
                            padding=(pad_h, 1))
    if (conv.kernel_size, conv.stride, conv.dilation, conv.groups) != (
            (3, 3), (1, 1), (1, 1), 1) or conv.bias is None:
        raise ValueError(f"the head conv is 3x3, stride 1, with a bias: "
                         f"got {conv}")
    profiling.count("head.conv_calls", 1)
    with profiling.span("head.forward"):
        if _wants_grad(x, conv.weight, conv.bias):
            return HeadConvFunction.apply(x, conv.weight, conv.bias, pad_h)
        return torch.ops.cspn_monodepth_tpu_torch.head_conv3x3(
            x, conv.weight, conv.bias, pad_h)
