"""CSPN propagation dispatcher.

`cspn_propagate` is the public op the model calls. It sends a CUDA tensor
to the hand-written Hopper kernels (ops/cspn_cuda.py) and a CPU tensor to
their plain PyTorch versions (ops/cspn_ref.py). There is no fallback: a
CUDA tensor whose kernel fails to build or launch raises.

Gradients (counterpart of the JAX package's `_cspn_pallas` custom VJP,
ops/cspn_pallas.py): when an input needs one, `CSPNFunction` runs the
stash forward (K2) and its backward the hand-written adjoint (K3); with
no gradient wanted, the forward is K1 alone. `impl="torch"` is the
independent plain loop under torch autograd.
"""

from __future__ import annotations

import torch

from torch.autograd.function import once_differentiable

from cspn_monodepth_tpu_torch.ops.cspn_cuda import (
    cspn_bwd,
    cspn_fwd,
    cspn_fwd_stash,
)
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    _squeeze_depth,
    cspn_propagate_ref_nchw,
)

IMPLS = ("auto", "torch", "cuda")


def _planes(t: torch.Tensor) -> torch.Tensor:
    """float32 with contiguous (H, W) planes, as the kernel reads them;
    a batch stride is kept (no copy for the head's channel slices)."""
    t = t.float()
    h, w = t.shape[-2:]
    inner = (h * w, w, 1) if t.dim() == 4 else (w, 1)
    return t if t.stride()[1:] == inner else t.contiguous()


class CSPNFunction(torch.autograd.Function):
    """CSPN propagation with the hand-written adjoint: guidance
    (B, 8, H, W), blur and sparse (B, H, W) float32 with contiguous planes
    (sparse may be None) -> (B, H, W). Gradients reach all three inputs;
    sparse gets none when it is None."""

    @staticmethod
    def forward(ctx, guidance, blur, sparse, num_iters: int, norm_type: str):
        out, stash = cspn_fwd_stash(guidance, blur, sparse,
                                    num_iters=num_iters, norm_type=norm_type)
        ctx.save_for_backward(guidance, sparse, stash)
        ctx.num_iters, ctx.norm_type = num_iters, norm_type
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        guidance, sparse, stash = ctx.saved_tensors
        d_guid, d_blur, d_sparse = cspn_bwd(
            guidance, sparse, stash, _planes(grad_out),
            num_iters=ctx.num_iters, norm_type=ctx.norm_type)
        return (d_guid, d_blur, None if sparse is None else d_sparse,
                None, None)


def cspn_propagate(
    guidance: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    num_iters: int = 24,
    norm_type: str = "8sum",
    impl: str = "auto",
    guidance_layout: str = "NHWC",
) -> torch.Tensor:
    """Refine blur_depth by CSPN propagation. See cspn_propagate_ref_nchw.

    guidance: (B, H, W, 8) for guidance_layout "NHWC", (B, 8, H, W) for
      "NCHW" (the plane-major layout the model's head emits).
    blur_depth, sparse_depth: (B, H, W) or (B, H, W, 1); the result has
      blur_depth's shape.
    impl: "auto" (the kernel for a CUDA tensor, the plain loop for a CPU
      tensor), "cuda" (the kernel; raises on a CPU tensor) or "torch" (the
      plain loop on any device).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r}")
    if guidance_layout == "NHWC":
        guidance = guidance.permute(0, 3, 1, 2)
    elif guidance_layout != "NCHW":
        raise ValueError(f"unknown guidance_layout: {guidance_layout!r}")
    if impl == "torch":
        return cspn_propagate_ref_nchw(
            guidance, blur_depth, sparse_depth,
            num_iters=num_iters, norm_type=norm_type)
    if impl == "cuda" and guidance.device.type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got {guidance.device}")

    squeeze = blur_depth.dim() == 4
    sp = _squeeze_depth(sparse_depth)
    args = (_planes(guidance), _planes(_squeeze_depth(blur_depth)),
            None if sp is None else _planes(sp))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        out = CSPNFunction.apply(*args, num_iters, norm_type)
    else:
        out = cspn_fwd(*args, num_iters=num_iters, norm_type=norm_type)
    out = out.to(blur_depth.dtype)
    return out[..., None] if squeeze else out
