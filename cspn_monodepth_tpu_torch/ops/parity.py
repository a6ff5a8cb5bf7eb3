"""Parity of the CSPN kernels against the plain loop, forward and gradients
(the counterpart of cspn_monodepth_tpu/ops/parity.py).

The CPU tests reach the kernels' plain versions only: a CUDA kernel runs on
the card alone. This module runs the kernel routes on the device it is
given and holds them to `cspn_propagate(impl="torch")`, the independent
plain loop under torch autograd, so a build or a launch that computes
wrong numbers cannot pass unseen; the port's bench runs it before timing
and embeds the result, as the JAX package's bench.py does.

Inputs come from `np.random.default_rng(0)` in the JAX module's order, so
that both checks see the same numbers. With random N(0, 1) guidance the
signed-gate propagation is expansive (row abs sums ~2): T=24 iterations
take values to ~1e9 and float32 ordering differences to ~1e3 absolute.
That is the dynamics, not a kernel bug, so parity is judged relative to
the output's magnitude, and `8sum_abs` (row sums exactly 1, non-expansive)
is the absolute-scale control.
"""

from __future__ import annotations

import numpy as np
import torch

from cspn_monodepth_tpu_torch.ops.cspn import (
    cspn_propagate,
    cspn_propagate_prenorm,
    route,
)
from cspn_monodepth_tpu_torch.ops.cspn_cuda import (
    FWD_GEOMETRIES,
    fwd_plan,
    rounds,
)
from cspn_monodepth_tpu_torch.ops.cspn_ref import prenorm_gates9

FWD_TOL = 2e-5
GRAD_TOL = 2e-4
# One round of the spatial path's slab kernels: its default halo_k rows on
# each side (parallel/halo.py).
HALO_K = 4


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max(1, max|want|)."""
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def _fwd_and_grads(fn, inputs: tuple, cot: torch.Tensor):
    """fn(*inputs) with no gradient, then the gradients of <fn(*inputs),
    cot> with respect to every input."""
    with torch.no_grad():
        out = fn(*inputs)
    leaves = tuple(t.detach().requires_grad_() for t in inputs)
    grads = torch.autograd.grad((fn(*leaves) * cot).sum(), leaves)
    return out, grads


def _compare(kernel, plain, inputs: tuple, cot: torch.Tensor,
             what: str) -> dict:
    out_k, grads_k = _fwd_and_grads(kernel, inputs, cot)
    out_p, grads_p = _fwd_and_grads(plain, inputs, cot)
    fwd_rel = _rel(out_k, out_p)
    grad_rel = max(_rel(x, y) for x, y in zip(grads_k, grads_p))
    if not fwd_rel < FWD_TOL:
        raise AssertionError(f"{what}: forward max-rel {fwd_rel} >= "
                             f"{FWD_TOL}")
    if not grad_rel < GRAD_TOL:
        raise AssertionError(f"{what}: gradient max-rel {grad_rel} >= "
                             f"{GRAD_TOL}")
    return {"fwd_maxrel": fwd_rel, "grad_maxrel": grad_rel,
            "out_mag": float(out_p.abs().max())}


def cspn_parity_check(
    norms: tuple[str, ...] = ("8sum_clamp", "8sum", "8sum_abs"),
    batch: int = 4,
    h: int = 228,
    w: int = 304,
    num_iters: int = 24,
    impl: str = "cuda",
    device: str = "cuda",
) -> dict:
    """The kernel route `impl` against the plain loop on `device`, per norm:
    the forward with no gradient (K1; K4 under impl="cuda_tiled") and the
    forward and all three gradients with one wanted (K2/K3; K5/K6). Returns
    {norm: {fwd_maxrel, grad_maxrel, out_mag}}; raises AssertionError where
    an error reaches FWD_TOL or GRAD_TOL.

    impl: "cuda" (the whole-plane kernels, CUDA tensors only),
    "cuda_tiled", or "auto" (the route `route` picks for h x w). On CPU
    tensors every route runs the kernels' plain versions.
    """
    rng = np.random.default_rng(0)
    results = {}
    for norm in norms:
        guid = rng.normal(size=(batch, h, w, 8)).astype(np.float32)
        blur = rng.uniform(0.5, 9.5, (batch, h, w)).astype(np.float32)
        sp = blur * (rng.random((batch, h, w)) < 0.01)
        cot = rng.normal(size=(batch, h, w)).astype(np.float32)
        inputs = tuple(torch.from_numpy(a).to(device)
                       for a in (guid, blur, sp.astype(np.float32)))
        kw = dict(num_iters=num_iters, norm_type=norm)

        def kernel(g, d, s, kw=kw):
            return cspn_propagate(g, d, s, impl=impl, **kw)

        def plain(g, d, s, kw=kw):
            return cspn_propagate(g, d, s, impl="torch", **kw)

        results[norm] = _compare(kernel, plain, inputs,
                                 torch.from_numpy(cot).to(device),
                                 f"{impl} {norm}")
    return results


def prenorm_parity_check(
    batch: int = 2,
    h: int = 96,
    w: int = 304,
    num_iters: int = 8,
    device: str = "cuda",
) -> dict:
    """The spatial path's slab kernels (K7 forward; K8 and K9 with a
    gradient wanted) against the plain prenorm loop on `device`, on gates9
    of `8sum_clamp`. These are the kernels a mesh run executes every step.
    The default is a KITTI-class slab: H 352 / 4-way spatial shard plus
    halo rows. Returns {fwd_maxrel, grad_maxrel, out_mag}."""
    rng = np.random.default_rng(0)
    guid = torch.from_numpy(
        rng.normal(size=(batch, h, w, 8)).astype(np.float32)).to(device)
    gates9 = prenorm_gates9(guid.permute(0, 3, 1, 2), "8sum_clamp")
    d0 = rng.uniform(0.5, 9.5, (batch, h, w)).astype(np.float32)
    sp = (d0 * (rng.random((batch, h, w)) < 0.01)).astype(np.float32)
    cot = rng.normal(size=(batch, h, w)).astype(np.float32)
    inputs = (gates9.contiguous(), torch.from_numpy(d0).to(device),
              torch.from_numpy(sp).to(device))

    def kernel(g9, d, s):
        return cspn_propagate_prenorm(g9, d, s, num_iters=num_iters)

    def plain(g9, d, s):
        return cspn_propagate_prenorm(g9, d, s, num_iters=num_iters,
                                      impl="torch")

    return _compare(kernel, plain, inputs, torch.from_numpy(cot).to(device),
                    "prenorm")


def _geometry(b: int, h: int, w: int, num_iters: int) -> tuple[int, int]:
    """(TILE, HALO) of the forward plan for a (B, H, W) call."""
    return FWD_GEOMETRIES[fwd_plan(b, h, w, num_iters)][:2]


def _slab_fits(b: int, h: int, w: int) -> bool:
    """A halo'd slab of one round (r = HALO_K) is one launch of the slab
    forward, and its pixels are within the adjoint's 32-bit index."""
    return (rounds(fwd_plan(b, h, w, HALO_K), HALO_K) == 1
            and h * w < 2 ** 31)


def routing_check() -> dict:
    """What routes where on this card (free: Python only, nothing built),
    in the place of the JAX package's VMEM budget asserts: the port has no
    VMEM budgets. NYU takes the whole-plane kernels and KITTI the H-tiled
    ones; the forward plan's tile geometry (TILE, HALO) by shape is the
    one the H100 sweep chose; the deployed slabs are within the slab
    kernels' contract. Raises AssertionError where one does not hold."""
    checks = {
        "nyu_whole_plane": route(228, 304) == "cuda",
        "kitti_tiled": route(352, 1216) == "cuda_tiled",
        "nyu_b1_32x8": _geometry(1, 228, 304, 24) == (32, 8),
        "nyu_b32_48x8": _geometry(32, 228, 304, 24) == (48, 8),
        "kitti_b1_48x8": _geometry(1, 352, 1216, 24) == (48, 8),
        "kitti_b8_40x12": _geometry(8, 352, 1216, 24) == (40, 12),
        # kitti_1216 on 2x4: 4 images of 352/4 + 2k rows; multihost on
        # 16x2: 16 images of 228/2 + 2k rows.
        "kitti_slab_32x4": _geometry(4, 352 // 4 + 2 * HALO_K, 1216,
                                     HALO_K) == (32, 4),
        "nyu_slab_32x4": _geometry(16, 228 // 2 + 2 * HALO_K, 304,
                                   HALO_K) == (32, 4),
        "kitti_slab_prenorm": _slab_fits(4, 352 // 4 + 2 * HALO_K, 1216),
        "nyu_slab_prenorm": _slab_fits(16, 228 // 2 + 2 * HALO_K, 304),
    }
    if not all(checks.values()):
        raise AssertionError(f"routing: {checks}")
    return checks
