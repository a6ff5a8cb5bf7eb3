"""CSPN propagation dispatcher.

`cspn_propagate` is the public op the model calls. It sends a CUDA tensor
to the hand-written Hopper kernels (ops/cspn_cuda.py) and a CPU tensor to
their plain PyTorch versions (ops/cspn_ref.py). There is no fallback: a
CUDA tensor whose kernel fails to build or launch raises.

Two routes, as in the JAX package (its ops/cspn.py routes by image size),
both on JAX's contract: raw guidance, blur and sparse in, the affinity
normalization and the anchoring of d^0 inside the kernels, their chain rule
inside the hand-written adjoint.
* whole-plane, `impl="cuda"` (counterpart of JAX's "pallas"): when an
  input needs a gradient, `CSPNFunction` runs the stash forward (K2) and
  its backward the adjoint (K3); with no gradient wanted, the forward is
  K1 alone, as the operator `cspn_fwd` (ops/library.py).
* H-tiled, `impl="cuda_tiled"` (JAX's "pallas_tiled", `_cspn_pallas_tiled`,
  a custom VJP over the raw inputs whose residuals are the guidance, the
  inputs and the stash): `TiledCSPNFunction` runs K5 forward and K6
  backward, which return d_guidance, d_blur = (1 - m) lam^0 and d_sparse
  = sum_t m lam^{t+1} + m lam^0 as `_cspn_tiled_adjoint_bwd_impl` does;
  K4 alone without a gradient, as the operator `cspn_tiled_fwd_raw`. On
  the card K4-K6 compute K1-K3's functions with K1-K3's C entries.
`impl="auto"` picks the route the JAX package picks on a TPU (`route`);
`impl="torch"` is the independent plain loop under torch autograd.

`cspn_propagate_prenorm` is the slab body of the spatially sharded CSPN
(parallel/halo.py; JAX's `cspn_propagate_prenorm_pallas`): prenormalized
gates9 and d^0 as given (or anchored on load, the slab route's first
round), `PrenormCSPNFunction` with K8 forward and K9 backward, or K7 alone
without a gradient. `cspn_normalize` is that route's normalization on the
card: `Gates9Function` (`cspn_gates9` forward, `cspn_gates9_bwd` backward),
or the operator `cspn_gates9` without a gradient.
"""

from __future__ import annotations

import torch

from torch.autograd.function import once_differentiable

import cspn_monodepth_tpu_torch.ops.library  # noqa: F401 (the operators)
from cspn_monodepth_tpu_torch.ops import cspn_cuda
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

# K1, K4 and the normalization without a gradient: the registered
# operators (ops/library.py), whose CUDA implementations are the wrappers
# in ops/cspn_cuda.py, so that eager serving and an exported program launch
# the same operator.
cspn_fwd = torch.ops.cspn_monodepth_tpu_torch.cspn_fwd
cspn_tiled_fwd = torch.ops.cspn_monodepth_tpu_torch.cspn_tiled_fwd_raw
cspn_gates9 = torch.ops.cspn_monodepth_tpu_torch.cspn_gates9

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


def _raw_stash_forward(ctx, fwd_stash, guidance, blur, sparse,
                       num_iters: int, norm_type: str):
    out, stash = fwd_stash(guidance, blur, sparse, num_iters=num_iters,
                           norm_type=norm_type)
    ctx.save_for_backward(guidance, sparse, stash)
    ctx.num_iters, ctx.norm_type = num_iters, norm_type
    return out


def _raw_adjoint(ctx, bwd, grad_out):
    guidance, sparse, stash = ctx.saved_tensors
    d_guid, d_blur, d_sparse = bwd(guidance, sparse, stash,
                                   _planes(grad_out),
                                   num_iters=ctx.num_iters,
                                   norm_type=ctx.norm_type)
    return (d_guid, d_blur, None if sparse is None else d_sparse,
            None, None)


class CSPNFunction(torch.autograd.Function):
    """CSPN propagation with the hand-written adjoint: guidance
    (B, 8, H, W), blur and sparse (B, H, W) float32 with contiguous planes
    (sparse may be None) -> (B, H, W). Gradients reach all three inputs;
    sparse gets none when it is None. K2 forward, K3 backward; saved: the
    guidance, sparse and the stash."""

    @staticmethod
    def forward(ctx, guidance, blur, sparse, num_iters: int, norm_type: str):
        return _raw_stash_forward(ctx, cspn_fwd_stash, guidance, blur,
                                  sparse, num_iters, norm_type)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        return _raw_adjoint(ctx, cspn_bwd, grad_out)


class TiledCSPNFunction(torch.autograd.Function):
    """The H-tiled route's kernels on JAX's contract (`_cspn_pallas_tiled`):
    raw guidance (B, 8, H, W), blur and sparse (B, H, W) or None, float32
    with contiguous planes -> (B, H, W). K5 forward (the normalization and
    d^0's anchor in its first round), K6 backward (the normalization
    recomputed, the chain rule and the anchor's gradients in its sums).
    Saved: JAX's residuals, the guidance, sparse and the stash; no gates9."""

    @staticmethod
    def forward(ctx, guidance, blur, sparse, num_iters: int, norm_type: str):
        return _raw_stash_forward(ctx, cspn_tiled_fwd_stash, guidance, blur,
                                  sparse, num_iters, norm_type)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        return _raw_adjoint(ctx, cspn_tiled_bwd, grad_out)


class PrenormCSPNFunction(torch.autograd.Function):
    """The spatial path's slab kernels with the hand-written adjoint (JAX's
    `_cspn_prenorm` custom VJP): gates9 (B, 9, H, W), d0 (B, H, W) as given
    or, with anchor_d0, anchored on load, and sparse (B, H, W) or None, on
    one rank's halo'd slab -> (B, H, W). K8 forward, K9 backward: d_gates9,
    d0's gradient (through its anchor with anchor_d0) and sparse's."""

    @staticmethod
    def forward(ctx, gates9, d0, sparse, num_iters: int, anchor_d0: bool):
        out, stash = cspn_prenorm_fwd_stash(gates9, d0, sparse,
                                            num_iters=num_iters,
                                            anchor_d0=anchor_d0)
        ctx.save_for_backward(gates9, sparse, stash)
        ctx.num_iters, ctx.anchor_d0 = num_iters, anchor_d0
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        gates9, sparse, stash = ctx.saved_tensors
        d_gates9, d_d0, d_sparse = cspn_prenorm_bwd(
            gates9, sparse, stash, _planes(grad_out),
            num_iters=ctx.num_iters, anchor_d0=ctx.anchor_d0)
        return (d_gates9, d_d0, None if sparse is None else d_sparse, None,
                None)


class Gates9Function(torch.autograd.Function):
    """The normalization on the card: raw guidance (B, 8, H, W), float32
    with contiguous planes -> gates9 (B, 9, H, W) = [1 - sum_k gate_k,
    gate_1..8] (`cspn_gates9`); its backward is `cspn_gates9_bwd`, the
    chain rule of K3's sums stage. Saved: the guidance."""

    @staticmethod
    def forward(ctx, guidance, norm_type: str):
        ctx.save_for_backward(guidance)
        ctx.norm_type = norm_type
        return cspn_cuda.cspn_gates9(guidance, norm_type=norm_type)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_gates9):
        (guidance,) = ctx.saved_tensors
        return cspn_cuda.cspn_gates9_bwd(guidance, _planes(d_gates9),
                                         norm_type=ctx.norm_type), None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def cspn_normalize(guidance: torch.Tensor, *, norm_type: str,
                   impl: str = "auto") -> torch.Tensor:
    """The affinity normalization alone, raw guidance (B, 8, H, W) ->
    gates9 (B, 9, H, W), the slab route's (JAX's parallel/halo.py
    normalizes each shard).

    impl: "auto" (`Gates9Function` when the guidance needs a gradient, the
    operator `cspn_gates9` otherwise; on a CPU tensor their plain
    versions) or "torch" (`prenorm_gates9` under torch autograd).
    """
    if impl == "torch":
        return prenorm_gates9(guidance, norm_type)
    if impl != "auto":
        raise ValueError(f"unknown impl: {impl!r}")
    guidance = _planes(guidance)
    if _wants_grad(guidance):
        return Gates9Function.apply(guidance, norm_type)
    return cspn_gates9(guidance, norm_type)


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
    tiled = impl == "cuda_tiled"
    if _wants_grad(*args):
        out = (TiledCSPNFunction if tiled else CSPNFunction).apply(
            *args, num_iters, norm_type)
    else:
        out = (cspn_tiled_fwd if tiled else cspn_fwd)(
            *args, num_iters=num_iters, norm_type=norm_type)
    out = out.to(blur_depth.dtype)
    return out[..., None] if squeeze else out


def cspn_propagate_prenorm(gates9: torch.Tensor, d0: torch.Tensor,
                           sparse: torch.Tensor | None = None, *,
                           num_iters: int, impl: str = "auto",
                           anchor_d0: bool = False) -> torch.Tensor:
    """Propagation on prenormalized gates9 (B, 9, H, W) from d0 (B, H, W)
    as given (no anchor on entry), the anchor after every iteration (JAX's
    `cspn_propagate_prenorm_pallas`, the spatial path's slab body). With
    anchor_d0, d0 is anchored first (the slab route's first round).

    impl: "auto" (K8/K9 under PrenormCSPNFunction when an input needs a
    gradient, K7 otherwise; on a CPU tensor their plain versions) or
    "torch" (the plain loop under torch autograd, JAX's "jnp").
    """
    if impl == "torch":
        return cspn_propagate_prenorm_ref(
            gates9, anchor(d0, sparse) if anchor_d0 else d0, sparse,
            num_iters=num_iters)
    if impl != "auto":
        raise ValueError(f"unknown impl: {impl!r}")
    args = (_planes(gates9), _planes(d0),
            None if sparse is None else _planes(sparse))
    if _wants_grad(*args):
        return PrenormCSPNFunction.apply(*args, num_iters, anchor_d0)
    return cspn_prenorm_fwd(*args, num_iters=num_iters, anchor_d0=anchor_d0)
