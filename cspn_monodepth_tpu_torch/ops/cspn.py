"""CSPN propagation dispatcher.

`cspn_propagate` is the public op the model calls. It sends a CUDA tensor
to the hand-written Hopper kernels (ops/cspn_cuda.py) and a CPU tensor to
their plain PyTorch versions (ops/cspn_ref.py). There is no fallback: a
CUDA tensor whose kernel fails to build or launch raises.

Two routes, as in the JAX package (its ops/cspn.py routes by image size):
* whole-plane, `impl="cuda"` (counterpart of JAX's "pallas"): the kernels
  normalize the raw guidance themselves. When an input needs a gradient,
  `CSPNFunction` runs the stash forward (K2) and its backward the
  hand-written adjoint with the chain rule (K3); with no gradient wanted,
  the forward is K1 alone, as the operator `cspn_fwd` (ops/library.py).
* H-tiled, `impl="cuda_tiled"` (JAX's "pallas_tiled", `_cspn_pallas_tiled`):
  `prenorm_gates9` and the anchoring of d^0 run in plain torch, then
  `TiledCSPNFunction` runs K5 forward and K6 backward (K4 alone without a
  gradient, as the operator `cspn_tiled_fwd`) on the prenormalized gates.
  The normalization's chain rule and the anchor's gradient, d_blur =
  (1 - m) lam^0 and d_sparse += m lam^0, are torch autograd of those plain
  ops, as JAX takes `jax.vjp` of them.
`impl="auto"` picks the route the JAX package picks on a TPU (`route`);
`impl="torch"` is the independent plain loop under torch autograd.

`cspn_propagate_prenorm` is the slab body of the spatially sharded CSPN
(parallel/halo.py; JAX's `cspn_propagate_prenorm_pallas`): prenormalized
gates9 and d^0 as given, `PrenormCSPNFunction` with K8 forward and K9
backward, or K7 alone without a gradient.
"""

from __future__ import annotations

import torch

from torch.autograd.function import once_differentiable

import cspn_monodepth_tpu_torch.ops.library  # noqa: F401 (the operators)
from cspn_monodepth_tpu_torch.ops.cspn_cuda import (
    cspn_bwd,
    cspn_fwd_stash,
    cspn_prenorm_bwd,
    cspn_prenorm_fwd,
    cspn_prenorm_fwd_stash,
    cspn_tiled_bwd,
    cspn_tiled_fwd_stash,
)
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    _squeeze_depth,
    anchor,
    cspn_propagate_prenorm_ref,
    cspn_propagate_ref_nchw,
    prenorm_gates9,
)

IMPLS = ("auto", "torch", "cuda", "cuda_tiled")

# K1 and K4 without a gradient: the registered operators (ops/library.py),
# whose CUDA implementations are the wrappers of the same names in
# ops/cspn_cuda.py, so that eager serving and an exported program launch
# the same operator.
cspn_fwd = torch.ops.cspn_monodepth_tpu_torch.cspn_fwd
cspn_tiled_fwd = torch.ops.cspn_monodepth_tpu_torch.cspn_tiled_fwd

# The JAX package's routing rule, kept as the port's own copy
# (cspn_monodepth_tpu/ops/cspn.py:_fits_vmem): an image whose ~13 f32
# planes fit 10 MiB takes the whole-plane kernels, a larger one the H-tiled
# ones. On Hopper both routes use the same 2-D tiles; the rule is kept so
# that each shape runs the counterpart of the kernel JAX runs there.
_PLANE_BUDGET_BYTES = 10 * 1024 * 1024


def route(h: int, w: int) -> str:
    """The impl "auto" picks for an h x w image: "cuda" (whole-plane,
    K1-K3; NYU 228x304) or "cuda_tiled" (H-tiled, K4-K6; KITTI 352x1216)."""
    return "cuda" if 13 * 4 * h * w <= _PLANE_BUDGET_BYTES else "cuda_tiled"


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


class TiledCSPNFunction(torch.autograd.Function):
    """The H-tiled route's kernels with the hand-written adjoint: gates9
    (B, 9, H, W) from `prenorm_gates9`, d0 (B, H, W) already anchored and
    sparse (B, H, W) or None, float32 with contiguous planes -> (B, H, W).
    K5 forward, K6 backward; the gradients are d_gates9, lam^0 for d0, and
    the per-iteration anchors' sum for sparse."""

    @staticmethod
    def forward(ctx, gates9, d0, sparse, num_iters: int):
        return _stash_forward(ctx, cspn_tiled_fwd_stash, gates9, d0, sparse,
                              num_iters)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        return _adjoint(ctx, cspn_tiled_bwd, grad_out)


class PrenormCSPNFunction(torch.autograd.Function):
    """The spatial path's slab kernels with the hand-written adjoint (JAX's
    `_cspn_prenorm` custom VJP): TiledCSPNFunction's contract on one rank's
    halo'd slab. K8 forward, K9 backward."""

    @staticmethod
    def forward(ctx, gates9, d0, sparse, num_iters: int):
        return _stash_forward(ctx, cspn_prenorm_fwd_stash, gates9, d0, sparse,
                              num_iters)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        return _adjoint(ctx, cspn_prenorm_bwd, grad_out)


def _stash_forward(ctx, fwd_stash, gates9, d0, sparse, num_iters: int):
    out, stash = fwd_stash(gates9, d0, sparse, num_iters=num_iters)
    ctx.save_for_backward(gates9, sparse, stash)
    ctx.num_iters = num_iters
    return out


def _adjoint(ctx, bwd, grad_out):
    gates9, sparse, stash = ctx.saved_tensors
    d_gates9, lam0, d_sparse = bwd(gates9, sparse, stash, _planes(grad_out),
                                   num_iters=ctx.num_iters)
    return d_gates9, lam0, None if sparse is None else d_sparse, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _propagate_tiled(guidance, blur, sparse, num_iters: int,
                     norm_type: str) -> torch.Tensor:
    """The H-tiled route: gates and the anchored d^0 in plain torch, then
    K5/K6 under TiledCSPNFunction, or K4 alone without a gradient."""
    gates9 = prenorm_gates9(guidance, norm_type)
    d0 = anchor(blur, sparse)
    if _wants_grad(gates9, d0, sparse):
        return TiledCSPNFunction.apply(gates9, d0, sparse, num_iters)
    return cspn_tiled_fwd(gates9, d0, sparse, num_iters=num_iters)


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
    impl: "auto" (the route `route` picks for the image size), "cuda"
      (the whole-plane kernels K1-K3; raises on a CPU tensor), "cuda_tiled"
      (the H-tiled kernels K4-K6 at any size) or "torch" (the plain loop
      on any device). On a CPU tensor every kernel's wrapper runs its plain
      version, so "auto" and "cuda_tiled" run there too, as JAX's
      "pallas_tiled" runs interpreted on a CPU.
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
    if impl == "auto":
        impl = route(*guidance.shape[-2:])

    squeeze = blur_depth.dim() == 4
    sp = _squeeze_depth(sparse_depth)
    args = (_planes(guidance), _planes(_squeeze_depth(blur_depth)),
            None if sp is None else _planes(sp))
    if impl == "cuda_tiled":
        out = _propagate_tiled(*args, num_iters, norm_type)
    elif _wants_grad(*args):
        out = CSPNFunction.apply(*args, num_iters, norm_type)
    else:
        out = cspn_fwd(*args, num_iters=num_iters, norm_type=norm_type)
    out = out.to(blur_depth.dtype)
    return out[..., None] if squeeze else out


def cspn_propagate_prenorm(gates9: torch.Tensor, d0: torch.Tensor,
                           sparse: torch.Tensor | None = None, *,
                           num_iters: int, impl: str = "auto") -> torch.Tensor:
    """Propagation on prenormalized gates9 (B, 9, H, W) from d0 (B, H, W)
    as given (no anchor on entry), the anchor after every iteration (JAX's
    `cspn_propagate_prenorm_pallas`, the spatial path's slab body).

    impl: "auto" (K8/K9 under PrenormCSPNFunction when an input needs a
    gradient, K7 otherwise; on a CPU tensor their plain versions) or
    "torch" (the plain loop under torch autograd, JAX's "jnp").
    """
    if impl == "torch":
        return cspn_propagate_prenorm_ref(gates9, d0, sparse,
                                          num_iters=num_iters)
    if impl != "auto":
        raise ValueError(f"unknown impl: {impl!r}")
    args = (_planes(gates9), _planes(d0),
            None if sparse is None else _planes(sparse))
    if _wants_grad(*args):
        return PrenormCSPNFunction.apply(*args, num_iters)
    return cspn_prenorm_fwd(*args, num_iters=num_iters)
