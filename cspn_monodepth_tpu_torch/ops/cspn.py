"""CSPN propagation dispatcher.

`cspn_propagate` is the public op the model calls. It sends a CUDA tensor
to the hand-written Hopper kernel (ops/cspn_cuda.py) and a CPU tensor to
the plain PyTorch loop (ops/cspn_ref.py). There is no fallback: a CUDA
tensor whose kernel fails to build or launch raises.
"""

from __future__ import annotations

import torch

from cspn_monodepth_tpu_torch.ops.cspn_cuda import cspn_fwd
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
    out = cspn_fwd(
        _planes(guidance), _planes(_squeeze_depth(blur_depth)),
        None if sp is None else _planes(sp),
        num_iters=num_iters, norm_type=norm_type)
    out = out.to(blur_depth.dtype)
    return out[..., None] if squeeze else out
