"""CSPN propagation dispatcher.

`cspn_propagate` is the public op the model calls. It sends a CUDA tensor
to the hand-written Hopper kernels (ops/cspn_cuda.py) and a CPU tensor to
their plain PyTorch versions (ops/cspn_ref.py). There is no fallback: a
CUDA tensor whose kernel fails to build or launch raises.

One path at every image size, on JAX's contract (its `_cspn_pallas_tiled`
and `cspn_propagate_pallas` take the same inputs): raw guidance, blur and
sparse in, the affinity normalization and the anchoring of d^0 inside the
kernels, their chain rule inside the hand-written adjoint. The stencil
size, read from the guidance's k^2 - 1 planes, picks the kernels:
* 3 x 3: when an input needs a gradient, `CSPNFunction` runs the stash
  forward K2 (`cspn_fwd_stash`) and its backward the adjoint K3
  (`cspn_bwd`), which returns d_guidance, d_blur = (1 - m) lam^0 and
  d_sparse = sum_t m lam^{t+1} + m lam^0 as JAX's
  `_cspn_tiled_adjoint_bwd_impl` does; with no gradient wanted, the
  forward is K1 alone, as the operator `cspn_fwd` (ops/library.py). The
  tile geometry comes from the shape (ops/cspn_cuda.py `fwd_plan`), so
  NYU's 228x304 and KITTI's 352x1216 run the same C entries.
* CSPN++'s k x k (k 5 or 7): `CSPNFunction` with `cspn_kxk_fwd_stash`
  and `cspn_kxk_bwd` (csrc/cspn_kxk.cu), or `cspn_kxk_fwd` alone without
  a gradient; each call counts one `cspn.kxk_calls`. They have no
  registered operator, so a program that holds one cannot be exported
  (ops/library.py `check_exportable`).
`impl="auto"` is that path; `impl="torch"` is the independent plain loop
under torch autograd.

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
    cspn_kxk_bwd,
    cspn_kxk_fwd,
    cspn_kxk_fwd_stash,
    cspn_prenorm_bwd,
    cspn_prenorm_fwd,
    cspn_prenorm_fwd_stash,
)
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    _squeeze_depth,
    anchor,
    cspn_propagate_prenorm_ref,
    cspn_propagate_ref_nchw,
    kernel_size_of,
    prenorm_gates9,
)
from cspn_monodepth_tpu_torch.ops.library import check_exportable
from cspn_monodepth_tpu_torch.utils import profiling

IMPLS = ("auto", "torch")

# K1 and the normalization without a gradient: the registered operators
# (ops/library.py), whose CUDA implementations are the wrappers in
# ops/cspn_cuda.py, so that eager serving and an exported program launch
# the same operator.
cspn_fwd = torch.ops.cspn_monodepth_tpu_torch.cspn_fwd
cspn_gates9 = torch.ops.cspn_monodepth_tpu_torch.cspn_gates9


def _kernels(k: int):
    """(no-gradient forward, stash forward, adjoint) of the k x k stencil,
    looked up at the call."""
    if k == 3:
        return cspn_fwd, cspn_fwd_stash, cspn_bwd
    return cspn_kxk_fwd, cspn_kxk_fwd_stash, cspn_kxk_bwd


def _planes(t: torch.Tensor) -> torch.Tensor:
    """float32 with contiguous (H, W) planes, as the kernel reads them;
    a batch stride is kept (no copy for the head's channel slices)."""
    t = t.float()
    h, w = t.shape[-2:]
    inner = (h * w, w, 1) if t.dim() == 4 else (w, 1)
    return t if t.stride()[1:] == inner else t.contiguous()


class CSPNFunction(torch.autograd.Function):
    """CSPN propagation with the hand-written adjoint: raw guidance
    (B, k^2 - 1, H, W), blur and sparse (B, H, W) float32 with contiguous
    planes (sparse may be None) -> (B, H, W). The stash forward and the
    adjoint of the guidance's stencil size (`_kernels`); gradients reach
    all three inputs, sparse none when it is None. Saved: JAX's residuals,
    the guidance, sparse and the stash; no gates9."""

    @staticmethod
    def forward(ctx, guidance, blur, sparse, num_iters: int, norm_type: str):
        _, fwd_stash, ctx.bwd = _kernels(kernel_size_of(guidance.shape[1]))
        out, stash = fwd_stash(guidance, blur, sparse, num_iters=num_iters,
                               norm_type=norm_type)
        ctx.save_for_backward(guidance, sparse, stash)
        ctx.num_iters, ctx.norm_type = num_iters, norm_type
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        guidance, sparse, stash = ctx.saved_tensors
        with profiling.span("cspn.backward"):
            d_guid, d_blur, d_sparse = ctx.bwd(
                guidance, sparse, stash, _planes(grad_out),
                num_iters=ctx.num_iters, norm_type=ctx.norm_type)
        return (d_guid, d_blur, None if sparse is None else d_sparse,
                None, None)


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

    guidance: (B, H, W, N) for guidance_layout "NHWC", (B, N, H, W) for
      "NCHW" (the plane-major layout the model's head emits); N = k^2 - 1
      for the k x k stencil (k = 3, or CSPN++'s 5 and 7).
    blur_depth, sparse_depth: (B, H, W) or (B, H, W, 1); the result has
      blur_depth's shape.
    impl: "auto" (the kernels of the stencil size, K1-K3 for 3 x 3, on
      any image size; on a CPU tensor every kernel's wrapper runs its
      plain version, as JAX's Pallas kernels run interpreted on a CPU) or
      "torch" (the plain loop under torch autograd, on any device).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r}")
    with profiling.span("cspn.forward"):
        return _propagate(guidance, blur_depth, sparse_depth, num_iters,
                          norm_type, impl, guidance_layout)


def _propagate(guidance, blur_depth, sparse_depth, num_iters: int,
               norm_type: str, impl: str, guidance_layout: str):
    if guidance_layout == "NHWC":
        guidance = guidance.permute(0, 3, 1, 2)
    elif guidance_layout != "NCHW":
        raise ValueError(f"unknown guidance_layout: {guidance_layout!r}")
    k = kernel_size_of(guidance.shape[1])
    if impl == "torch":
        return cspn_propagate_ref_nchw(
            guidance, blur_depth, sparse_depth,
            num_iters=num_iters, norm_type=norm_type)
    squeeze = blur_depth.dim() == 4
    sp = _squeeze_depth(sparse_depth)
    args = (_planes(guidance), _planes(_squeeze_depth(blur_depth)),
            None if sp is None else _planes(sp))
    if k > 3:
        check_exportable(k)
        profiling.count("cspn.kxk_calls", 1)
    if _wants_grad(*args):
        out = CSPNFunction.apply(*args, num_iters, norm_type)
    else:
        out = _kernels(k)[0](*args, num_iters=num_iters, norm_type=norm_type)
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
