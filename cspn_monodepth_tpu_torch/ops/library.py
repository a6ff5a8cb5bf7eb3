"""The CSPN forward K1, the normalization and the 3 x 3 CSPN's head conv
as PyTorch custom operators, and the loader of an exported serving
program.

    torch.ops.cspn_monodepth_tpu_torch.cspn_fwd(
        guidance, blur, sparse, num_iters, norm_type)          # K1
    torch.ops.cspn_monodepth_tpu_torch.cspn_gates9(
        guidance, norm_type)                                    # gates9
    torch.ops.cspn_monodepth_tpu_torch.head_conv3x3(
        x, weight, bias, pad_h)                                 # H1

The kernels are bound with ctypes (ops/cspn_cuda.py), which `torch.export`
cannot trace: a FakeTensor has no data pointer. As registered operators
with a fake implementation they appear in an exported graph as one node
each, and the no-gradient branches of ops/cspn.py call them, so that eager
serving and an exported program launch the same operator. K1 takes the
raw guidance, as JAX's ops do, and normalizes and anchors in the kernel;
it serves every image size, so an exported NYU or KITTI program holds one
`cspn_fwd` node. The head conv's no-gradient forward (ops/head_conv.py)
is `head_conv3x3`, one node too.

Each operator has two implementations and no other: on a CUDA tensor the
kernel's wrapper in ops/cspn_cuda.py or ops/head_conv.py (it launches or
raises, and counts its launches there), on a CPU tensor the kernel's plain
version from ops/cspn_ref.py or ops/head_conv.py. Inputs are float32 (the
head conv's x also bfloat16); the result is a new contiguous float32
tensor. The wrappers' `geometry` keyword stays theirs (for the
geometry sweeps); the operators take the geometry by shape.

A process that loads a program exported by `DepthPredictor.export_program`
imports this module by name, since a loaded graph resolves its operators in
the registry. It builds no model and reads no config:

    from cspn_monodepth_tpu_torch.ops.library import load_program
    program = load_program("depth.pt2")           # exported on "cuda"
    depth = program(x)                            # (B, H, W, C) -> (B, H, W, 1)

CSPN++'s k x k stencils (k = 5, 7; ops/cspn_cuda.py's cspn_kxk_*) have
no operator here: `check_exportable` raises where one is traced, so that
exporting such a model fails with that message.

This module imports torch, ops/cspn_cuda.py, ops/cspn_ref.py and
ops/head_conv.py only.
"""

from __future__ import annotations

import torch

from cspn_monodepth_tpu_torch.ops import cspn_cuda, head_conv
from cspn_monodepth_tpu_torch.ops.cspn_ref import prenorm_gates9

NAMESPACE = "cspn_monodepth_tpu_torch"


def check_exportable(kernel_size: int) -> None:
    """Raise where a k x k stencil above 3 runs under `torch.export` or
    `torch.compile`: its kernels are bound with ctypes and have no
    operator, so no traced program can hold them. Eager calls pass."""
    if kernel_size > 3 and (torch.compiler.is_exporting()
                            or torch.compiler.is_compiling()):
        raise NotImplementedError(
            f"a {kernel_size}x{kernel_size} CSPN stencil cannot be exported "
            f"or compiled: only the 3x3 stencil has registered operators "
            f"(ops/library.py); serve such a model eagerly")


def _result(out: torch.Tensor, num_iters: int) -> torch.Tensor:
    """At T = 0 a plain version can return an input plane itself; an
    operator's result may not alias an input."""
    return out.clone() if num_iters == 0 else out.contiguous()


def _check_float32(**tensors):
    for name, t in tensors.items():
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")


def _fake(planes: torch.Tensor, channels: int, d: torch.Tensor):
    b, c, h, w = planes.shape
    if c != channels or tuple(d.shape) != (b, h, w):
        raise ValueError(f"expected ({b}, {channels}, H, W) gates and "
                         f"({b}, H, W) depth, got {tuple(planes.shape)} and "
                         f"{tuple(d.shape)}")
    return d.new_empty((b, h, w), dtype=torch.float32)


@torch.library.custom_op(
    f"{NAMESPACE}::cspn_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor guidance, Tensor blur, Tensor? sparse, int num_iters, "
           "str norm_type) -> Tensor")
def cspn_fwd(guidance: torch.Tensor, blur: torch.Tensor,
             sparse: torch.Tensor | None, num_iters: int,
             norm_type: str) -> torch.Tensor:
    """K1: raw guidance (B, 8, H, W), blur and sparse (B, H, W) -> the
    refined depth (B, H, W). This body is the CPU implementation, the
    plain version."""
    _check_float32(guidance=guidance, blur=blur, sparse=sparse)
    return _result(cspn_cuda.cspn_fwd_plain(
        guidance, blur, sparse, num_iters=num_iters, norm_type=norm_type),
        num_iters)


@cspn_fwd.register_kernel("cuda")
def _cspn_fwd_cuda(guidance, blur, sparse, num_iters, norm_type):
    return cspn_cuda.cspn_fwd(guidance, blur, sparse, num_iters=num_iters,
                              norm_type=norm_type)


@cspn_fwd.register_fake
def _cspn_fwd_fake(guidance, blur, sparse, num_iters, norm_type):
    return _fake(guidance, 8, blur)


@torch.library.custom_op(
    f"{NAMESPACE}::cspn_gates9", mutates_args=(), device_types="cpu",
    schema="(Tensor guidance, str norm_type) -> Tensor")
def cspn_gates9(guidance: torch.Tensor, norm_type: str) -> torch.Tensor:
    """The normalization: raw guidance (B, 8, H, W) -> gates9 (B, 9, H, W)
    = [1 - sum_k gate_k, gate_1..8]. This body is the CPU implementation,
    the plain version."""
    _check_float32(guidance=guidance)
    return prenorm_gates9(guidance, norm_type).contiguous()


@cspn_gates9.register_kernel("cuda")
def _cspn_gates9_cuda(guidance, norm_type):
    return cspn_cuda.cspn_gates9(guidance, norm_type=norm_type)


@cspn_gates9.register_fake
def _cspn_gates9_fake(guidance, norm_type):
    b, c, h, w = guidance.shape
    if c != 8:
        raise ValueError(f"expected ({b}, 8, H, W) guidance, got "
                         f"{tuple(guidance.shape)}")
    return guidance.new_empty((b, 9, h, w), dtype=torch.float32)


@torch.library.custom_op(
    f"{NAMESPACE}::head_conv3x3", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor weight, Tensor bias, int pad_h) -> Tensor")
def head_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 pad_h: int) -> torch.Tensor:
    """The 3 x 3 CSPN's head conv: x (B, Cin, H, W) float32 or bfloat16,
    weight (Cout, Cin, 3, 3), bias (Cout) -> (B, Cout, H + 2 pad_h - 2, W)
    float32. This body is the CPU implementation, the plain version."""
    _check_float32(weight=weight, bias=bias)
    return head_conv.head_conv3x3_fwd_plain(x, weight, bias,
                                            pad_h=pad_h).contiguous()


@head_conv3x3.register_kernel("cuda")
def _head_conv3x3_cuda(x, weight, bias, pad_h):
    return head_conv.head_conv3x3_fwd(x, weight, bias, pad_h=pad_h)


@head_conv3x3.register_fake
def _head_conv3x3_fake(x, weight, bias, pad_h):
    b, cin, h, w = x.shape
    if tuple(weight.shape[1:]) != (cin, 3, 3) or \
            tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"expected ({weight.shape[0]}, {cin}, 3, 3) weight "
                         f"and ({weight.shape[0]},) bias, got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    return x.new_empty((b, weight.shape[0], h + 2 * pad_h - 2, w),
                       dtype=torch.float32)


class LoadedProgram(torch.nn.Module):
    """An exported serving program, run as `DepthPredictor.predict_batch`
    runs the model: without gradients."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.program = module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.program(x)


def exported_device(program: torch.export.ExportedProgram) -> torch.device:
    """The device the program was traced on: its input's."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.name == name)
    return node.meta["val"].device


def load_program(path, device: str | torch.device = "cuda") -> LoadedProgram:
    """Load a program that `DepthPredictor.export_program` wrote. It runs on
    the kind of device it was exported on (the bf16 autocast node holds
    that device type): asking for another raises ValueError."""
    program = torch.export.load(path)
    exported = exported_device(program)
    if exported.type != torch.device(device).type:
        raise ValueError(f"{path} was exported on {exported.type}, not "
                         f"{torch.device(device).type}: export it again "
                         f"there")
    return LoadedProgram(program.module())
