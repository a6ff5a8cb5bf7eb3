"""The CSPN forwards K1 and K4 and the normalization as PyTorch custom
operators, and the loader of an exported serving program.

    torch.ops.cspn_monodepth_tpu_torch.cspn_fwd(
        guidance, blur, sparse, num_iters, norm_type)          # K1
    torch.ops.cspn_monodepth_tpu_torch.cspn_tiled_fwd_raw(
        guidance, blur, sparse, num_iters, norm_type)          # K4
    torch.ops.cspn_monodepth_tpu_torch.cspn_gates9(
        guidance, norm_type)                                    # gates9
    torch.ops.cspn_monodepth_tpu_torch.cspn_tiled_fwd(
        gates9, d0, sparse, num_iters)           # gates9 contract (K7's)

The kernels are bound with ctypes (ops/cspn_cuda.py), which `torch.export`
cannot trace: a FakeTensor has no data pointer. As registered operators
with a fake implementation they appear in an exported graph as one node
each, and the no-gradient branches of ops/cspn.py call them, so that eager
serving and an exported program launch the same operator. K4 takes the raw
guidance, as JAX's H-tiled op does, and normalizes and anchors in the
kernel. `cspn_tiled_fwd` keeps the gates9 contract of K4 before it took raw
guidance (prenormalized gates9 and an anchored d0), so that a program
exported then still loads and runs: its CUDA implementation is the slab
forward K7's wrapper, the same function.

Each operator has two implementations and no other: on a CUDA tensor the
kernel's wrapper in ops/cspn_cuda.py (it launches or raises, and counts its
launches there), on a CPU tensor the kernel's plain version from
ops/cspn_ref.py. Inputs are float32; the result is a new contiguous
float32 tensor. The wrappers' `geometry` keyword stays theirs (for the
geometry sweeps); the operators take the geometry by shape.

A process that loads a program exported by `DepthPredictor.export_program`
imports this module by name, since a loaded graph resolves its operators in
the registry. It builds no model and reads no config:

    from cspn_monodepth_tpu_torch.ops.library import load_program
    program = load_program("depth.pt2")           # exported on "cuda"
    depth = program(x)                            # (B, H, W, C) -> (B, H, W, 1)

This module imports torch, ops/cspn_cuda.py and ops/cspn_ref.py only.
"""

from __future__ import annotations

import contextlib

import torch

from cspn_monodepth_tpu_torch.ops import cspn_cuda
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    cspn_prenorm_fwd_plain,
    cspn_tiled_fwd_plain,
    prenorm_gates9,
)

NAMESPACE = "cspn_monodepth_tpu_torch"


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
    f"{NAMESPACE}::cspn_tiled_fwd_raw", mutates_args=(), device_types="cpu",
    schema="(Tensor guidance, Tensor blur, Tensor? sparse, int num_iters, "
           "str norm_type) -> Tensor")
def cspn_tiled_fwd_raw(guidance: torch.Tensor, blur: torch.Tensor,
                       sparse: torch.Tensor | None, num_iters: int,
                       norm_type: str) -> torch.Tensor:
    """K4: raw guidance (B, 8, H, W), blur and sparse (B, H, W) -> the
    refined depth (B, H, W), as the H-tiled route computes it. This body is
    the CPU implementation, the plain version."""
    _check_float32(guidance=guidance, blur=blur, sparse=sparse)
    return _result(cspn_tiled_fwd_plain(
        guidance, blur, sparse, num_iters=num_iters, norm_type=norm_type),
        num_iters)


@cspn_tiled_fwd_raw.register_kernel("cuda")
def _cspn_tiled_fwd_raw_cuda(guidance, blur, sparse, num_iters, norm_type):
    return cspn_cuda.cspn_tiled_fwd(guidance, blur, sparse,
                                    num_iters=num_iters, norm_type=norm_type)


@cspn_tiled_fwd_raw.register_fake
def _cspn_tiled_fwd_raw_fake(guidance, blur, sparse, num_iters, norm_type):
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
    f"{NAMESPACE}::cspn_tiled_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor gates9, Tensor d0, Tensor? sparse, int num_iters) "
           "-> Tensor")
def cspn_tiled_fwd(gates9: torch.Tensor, d0: torch.Tensor,
                   sparse: torch.Tensor | None,
                   num_iters: int) -> torch.Tensor:
    """The gates9 contract of programs exported before K4 took raw
    guidance: prenormalized gates9 (B, 9, H, W), the anchored d0 and sparse
    (B, H, W) -> the refined depth (B, H, W), the slab forward K7's
    function. This body is the CPU implementation, the plain version."""
    _check_float32(gates9=gates9, d0=d0, sparse=sparse)
    return _result(cspn_prenorm_fwd_plain(gates9, d0, sparse,
                                          num_iters=num_iters), num_iters)


@cspn_tiled_fwd.register_kernel("cuda")
def _cspn_tiled_fwd_cuda(gates9, d0, sparse, num_iters):
    return cspn_cuda.cspn_prenorm_fwd(gates9, d0, sparse,
                                      num_iters=num_iters)


@cspn_tiled_fwd.register_fake
def _cspn_tiled_fwd_fake(gates9, d0, sparse, num_iters):
    return _fake(gates9, 9, d0)


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full float32 (TF32 is cuDNN's default)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class LoadedProgram(torch.nn.Module):
    """An exported serving program, run as `DepthPredictor.predict_batch`
    runs the model: without gradients and with cuDNN's TF32 off, a global
    flag that the graph does not hold (the model turns it off around its
    float32 head)."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.program = module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), no_tf32():
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
