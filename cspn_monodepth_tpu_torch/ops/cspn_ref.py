"""Plain PyTorch CSPN spatial propagation: the reference the kernel is held to.

Cheng, Wang, Yang - "Learning Depth with Convolutional Spatial Propagation
Network", TPAMI 2019, arXiv:1810.02695, Eq. 1-5. This is the plain version
of the Hopper kernel in `csrc/cspn_fwd.cu`: a Python loop of elementwise
torch ops, one iteration per step, the same arithmetic in the same order.

Layouts: the public entry `cspn_propagate_ref` takes channels-last guidance
(B, H, W, 8) like the JAX package; `cspn_propagate_ref_nchw` takes the
plane-major (B, 8, H, W) guidance the model's head emits. Depth maps are
(B, H, W) or (B, H, W, 1). The 8 neighbor channels are ordered row-major
over the 3x3 neighborhood with the center removed (NEIGHBOR_OFFSETS).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (dy, dx) offsets of the 8 neighbors, row-major, center excluded. Channel k
# of the guidance weights the neighbor at (i+dy_k, j+dx_k): a gather stencil.
NEIGHBOR_OFFSETS: tuple[tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1),           (0, 1),
    (1, -1), (1, 0), (1, 1),
)

NORM_TYPES = ("8sum", "8sum_abs", "8sum_clamp")


def normalize_affinity(guidance: torch.Tensor, norm_type: str = "8sum",
                       eps: float = 1e-8, dim: int = -1):
    """Affinity normalization [P, Eq. 2-3] over the 8-neighbor axis `dim`.

    norm_type:
      "8sum": signed, divide by the abs-sum (floored at eps).
      "8sum_abs": non-negative, use |g-hat|.
      "8sum_clamp": signed, divide by max(abs-sum, 1): the identity map at
        g-hat = 0, which is what lets the model train from scratch.

    Returns (gate, gate_center): gate has the shape of `guidance`, and
    gate_center (size 1 along `dim`) is 1 - sum_k gate_k, so the 9-weight
    row sums to exactly 1.
    """
    if norm_type == "8sum_abs":
        guidance = guidance.abs()
    elif norm_type not in ("8sum", "8sum_clamp"):
        raise ValueError(f"unknown norm_type: {norm_type!r}")
    abs_sum = guidance.abs().sum(dim=dim, keepdim=True)
    floor = 1.0 if norm_type == "8sum_clamp" else eps
    gate = guidance / abs_sum.clamp_min(floor)
    gate_center = 1.0 - gate.sum(dim=dim, keepdim=True)
    return gate, gate_center


def _squeeze_depth(x: torch.Tensor | None) -> torch.Tensor | None:
    if x is None:
        return None
    return x[..., 0] if x.dim() == 4 else x


def cspn_propagate_ref_nchw(
    guidance: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    num_iters: int = 24,
    norm_type: str = "8sum",
) -> torch.Tensor:
    """CSPN propagation [P, Eq. 1] with plane-major guidance (B, 8, H, W).

    d^{t+1}(i,j) = g0(i,j) d^t(i,j) + sum_k g_k(i,j) d^t(i+dy_k, j+dx_k),
    zero outside the image; with sparse_depth, d^0 is anchored and every
    iteration ends with d <- (1-m) d + m d_sparse, m = (d_sparse > 0).

    Returns the refined depth with the shape of blur_depth.
    """
    squeeze = blur_depth.dim() == 4
    d = _squeeze_depth(blur_depth)
    sp = _squeeze_depth(sparse_depth)

    gates, g0 = normalize_affinity(guidance, norm_type, dim=1)
    g0 = g0[:, 0]
    mask = None
    if sp is not None:
        mask = (sp > 0).to(d.dtype)
        # Anchor d^0 as well so iteration 1 already sees the sparse points.
        d = (1.0 - mask) * d + mask * sp

    h, w = d.shape[-2:]
    for _ in range(num_iters):
        padded = F.pad(d, (1, 1, 1, 1))
        new = g0 * d
        for k, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
            new = new + gates[:, k] * padded[:, 1 + dy:1 + dy + h,
                                             1 + dx:1 + dx + w]
        if mask is not None:
            new = (1.0 - mask) * new + mask * sp
        d = new
    return d[..., None] if squeeze else d


def cspn_propagate_ref(
    guidance: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    num_iters: int = 24,
    norm_type: str = "8sum",
) -> torch.Tensor:
    """CSPN propagation with channels-last guidance (B, H, W, 8); the same
    contract as the JAX package's `cspn_propagate_ref`."""
    return cspn_propagate_ref_nchw(
        guidance.permute(0, 3, 1, 2), blur_depth, sparse_depth,
        num_iters=num_iters, norm_type=norm_type)
