"""Plain PyTorch CSPN spatial propagation: the reference the kernel is held to.

Cheng, Wang, Yang - "Learning Depth with Convolutional Spatial Propagation
Network", TPAMI 2019, arXiv:1810.02695, Eq. 1-5. This is the plain version
of the Hopper kernels in `csrc/`: Python loops of elementwise torch ops,
one iteration per step, the same arithmetic in the same order.

* `cspn_propagate_ref_nchw`: the forward (kernel K1, `csrc/cspn_fwd.cu`),
  differentiable by torch autograd;
* `cspn_fwd_stash_plain`: the forward that also returns every
  pre-iteration depth plane d^t (kernel K2, the training forward);
* `cspn_bwd_plain`: the hand-written adjoint that sweeps that stash in
  reverse (kernel K3, `csrc/cspn_bwd.cu`), composed of the plain versions
  of the adjoint kernels' stages: `prenorm_gates9` (stage 0),
  `adjoint_sweep_plain` (stage 1, the lam recursion on the
  `transposed_gates`, which writes every lam^{t+1} to an adjoint stash),
  `adjoint_sums_plain` (stage 2, the gate sums over both stashes) and
  `cspn_bwd_sums_plain` (stage 2's outputs in K3's and K9's forms);
* the H-tiled route's K4, K5 and K6 compute the same three functions
  (JAX's `_cspn_pallas_tiled` takes the raw guidance too), so their plain
  versions are these (`cspn_tiled_fwd_plain`, `cspn_tiled_fwd_stash_plain`,
  `cspn_tiled_bwd_plain`);
* `prenorm_gates9` (the normalization, `cspn_gates9`'s plain version) and
  `prenorm_gates9_bwd_plain` (its adjoint, torch autograd of it);
* `cspn_propagate_prenorm_ref`: the prenormalized contract of the
  spatially sharded CSPN (gates9 (B, 9, H, W) with the centre in channel 0,
  d^0 taken as given, an anchor after every iteration), and the plain
  versions of its slab kernels K7-K9 (`cspn_prenorm_fwd_plain`,
  `cspn_prenorm_fwd_stash_plain`, `cspn_prenorm_bwd_plain`), which anchor
  d^0 on request (the slab route's first round).

`prenorm_gates9` and `anchor` count their calls on a CUDA tensor
(`.cuda_calls`): on the card every route normalizes and anchors in its
kernels, so only a comparison with a plain version calls them there.

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
    d = _propagate(guidance, _squeeze_depth(blur_depth),
                   _squeeze_depth(sparse_depth), num_iters, norm_type)
    return d[..., None] if squeeze else d


def anchor(d: torch.Tensor, sp: torch.Tensor | None) -> torch.Tensor:
    """d with the sparse points put in: (1 - m) d + m sp, m = [sp > 0]."""
    if d.is_cuda:
        anchor.cuda_calls += 1
    if sp is None:
        return d
    mask = (sp > 0).to(d.dtype)
    return (1.0 - mask) * d + mask * sp


anchor.cuda_calls = 0


def _propagate(guidance, d, sp, num_iters: int, norm_type: str,
               stash: list | None = None) -> torch.Tensor:
    """The propagation loop on (B, H, W) planes; appends each d^t, the
    plane iteration t starts from, to `stash` when one is given."""
    gates, g0 = normalize_affinity(guidance, norm_type, dim=1)
    # Anchor d^0 as well so iteration 1 already sees the sparse points.
    return _iterate(g0[:, 0], gates, anchor(d, sp), sp, num_iters, stash)


def _iterate(g0, gates, d, sp, num_iters: int,
             stash: list | None = None) -> torch.Tensor:
    """`num_iters` iterations from d as given, each ending with the anchor:
    d <- g0 d + sum_k gates[:, k] d(j + off_k), zero outside the image."""
    mask = None if sp is None else (sp > 0).to(d.dtype)
    for _ in range(num_iters):
        if stash is not None:
            stash.append(d)
        new = _stencil(g0, gates, d)
        if mask is not None:
            new = (1.0 - mask) * new + mask * sp
        d = new
    return d


def _stencil(g0, gates, d) -> torch.Tensor:
    """One gather step: g0 d + sum_k gates[:, k] d(j + off_k), with d zero
    outside the image."""
    h, w = d.shape[-2:]
    padded = F.pad(d, (1, 1, 1, 1))
    new = g0 * d
    for k, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
        new = new + gates[:, k] * padded[:, 1 + dy:1 + dy + h,
                                         1 + dx:1 + dx + w]
    return new


def _stacked(stash: list, d: torch.Tensor) -> torch.Tensor:
    """The stash list as a (B, T, H, W) tensor (T may be 0)."""
    b, h, w = d.shape
    return torch.stack(stash, 1) if stash else d.new_zeros((b, 0, h, w))


def cspn_fwd_stash_plain(
    guidance: torch.Tensor,
    blur: torch.Tensor,
    sparse: torch.Tensor | None,
    *,
    num_iters: int,
    norm_type: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: guidance (B, 8, H, W), blur and sparse
    (B, H, W) -> (out (B, H, W), stash (B, T, H, W)), where stash[:, t] is
    d^t, the (anchored) depth plane iteration t starts from."""
    stash: list[torch.Tensor] = []
    out = _propagate(guidance, blur, sparse, num_iters, norm_type, stash)
    return out, _stacked(stash, blur)


def cspn_bwd_plain(
    guidance: torch.Tensor,
    sparse: torch.Tensor | None,
    stash: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    num_iters: int,
    norm_type: str,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adjoint of the propagation: (d_guidance (B, 8, H, W), d_blur,
    d_sparse (B, H, W)) for the output cotangent grad_out (B, H, W), from
    the raw guidance, the sparse map and the stash of
    `cspn_fwd_stash_plain`. d_sparse is zero without a sparse map.

    The stages of kernel K3: the normalized gates9 (`prenorm_gates9`), the
    reverse sweep of lam = dL/dd^{t+1} (`adjoint_sweep_plain`), the gate
    sums over both stashes with the normalization's chain rule
    (`cspn_bwd_sums_plain`).
    """
    if norm_type not in NORM_TYPES:
        raise ValueError(f"unknown norm_type: {norm_type!r}")
    gates9 = prenorm_gates9(guidance, norm_type, eps)
    lam_stash, lam0 = adjoint_sweep_plain(gates9, sparse, grad_out,
                                          num_iters=num_iters)
    return cspn_bwd_sums_plain(sparse, stash, lam_stash, num_iters=num_iters,
                               guidance=guidance, lam0=lam0,
                               norm_type=norm_type, eps=eps)


def cspn_bwd_sums_plain(
    sparse: torch.Tensor | None,
    stash: torch.Tensor,
    lam_stash: torch.Tensor,
    *,
    num_iters: int,
    guidance: torch.Tensor | None = None,
    lam0: torch.Tensor | None = None,
    norm_type: str | None = None,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, ...]:
    """The plain version of the sums stage kernel, in its two forms.
    Without guidance (K9): (d_gates9 (B, 9, H, W) = [G_0, G_1..8],
    sum_t m lam^{t+1}), from `adjoint_sums_plain`. With the raw guidance,
    lam^0 and norm_type (K3, K6): (d_guidance, d_blur = (1 - m) lam^0,
    d_sparse + m lam^0), the chain rule of the normalization with
    Ghat_k = G_k - G_0, c1 = sum_k Ghat_k gate_k, den = max(s, floor),
    s = sum_k |g_k| and active = [s > floor]:
      signed norms: (Ghat_l - active sign(g_l) c1) / den
      8sum_abs:     sign(g_l) (Ghat_l - active c1) / den."""
    g_acc, g0_acc, d_sparse = adjoint_sums_plain(sparse, stash, lam_stash,
                                                 num_iters=num_iters)
    if guidance is None:
        return torch.cat([g0_acc[:, None], g_acc], dim=1), d_sparse
    raw = guidance.abs() if norm_type == "8sum_abs" else guidance
    s = guidance.abs().sum(1)
    floor = 1.0 if norm_type == "8sum_clamp" else eps
    den = s.clamp_min(floor)
    gates = raw / den[:, None]
    active = (s > floor).to(lam0.dtype)
    d_blur, d_sparse = anchor_grad_plain(sparse, lam0, d_sparse)
    ghat = g_acc - g0_acc[:, None]
    c1 = (ghat * gates).sum(1)
    sgn = torch.sign(guidance)
    if norm_type == "8sum_abs":
        d_guid = sgn * (ghat - (active * c1)[:, None]) / den[:, None]
    else:
        d_guid = (ghat - sgn * (active * c1)[:, None]) / den[:, None]
    return d_guid, d_blur, d_sparse


def anchor_grad_plain(sparse: torch.Tensor | None, lam0: torch.Tensor,
                      d_sparse: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """`anchor` in reverse: from lam0 = dL/dd^0 of an anchored d^0 and the
    per-iteration anchors' sum d_sparse, (d_blur = (1 - m) lam0, d_sparse
    + m lam0)."""
    if sparse is None:
        return lam0, d_sparse
    masked, zero = sparse > 0, torch.zeros_like(lam0)
    return (torch.where(masked, zero, lam0),
            d_sparse + torch.where(masked, lam0, zero))


def transposed_gates(gates9: torch.Tensor) -> torch.Tensor:
    """The adjoint stencil's gates in the forward's gather form: channel 0
    the centre g0, channel 1 + k gT_k(j) = g_{7-k}(j + off_k), the gate
    with which the neighbour j + off_k reads j (off_{7-k} = -off_k), 0
    where j + off_k lies outside the image. Then lam^t = the forward's
    stencil on these gates applied to lam_u = (1 - m) lam^{t+1}."""
    h, w = gates9.shape[-2:]
    gpad = F.pad(gates9[:, 1:], (1, 1, 1, 1))
    return torch.stack(
        [gates9[:, 0]] + [gpad[:, 7 - k, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for k, (dy, dx) in enumerate(NEIGHBOR_OFFSETS)], 1)


def adjoint_sweep_plain(
    gates9: torch.Tensor,
    sparse: torch.Tensor | None,
    grad_out: torch.Tensor,
    *,
    num_iters: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 of the adjoint kernels: the reverse sweep, t = T-1 .. 0,
      lam^t = g0 lam_u + sum_k gT_k lam_u(j + off_k),  lam_u = (1 - m)
      lam^{t+1},  m = [sparse > 0],
    from lam^T = grad_out. Returns the adjoint stash (B, T, H, W),
    stash[:, t] = lam^{t+1} unmasked, and lam^0 (B, H, W), unmasked."""
    gt = transposed_gates(gates9)
    masked = None if sparse is None else sparse > 0
    lam = grad_out
    stash: list = [None] * num_iters
    for t in reversed(range(num_iters)):
        stash[t] = lam
        lam_u = lam if masked is None else torch.where(
            masked, torch.zeros_like(lam), lam)
        lam = _stencil(gt[:, 0], gt[:, 1:], lam_u)
    return _stacked(stash, grad_out), lam


def adjoint_sums_plain(
    sparse: torch.Tensor | None,
    stash: torch.Tensor,
    lam_stash: torch.Tensor,
    *,
    num_iters: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 2 of the adjoint kernels: from the forward's stash (d^t) and
    the adjoint stash of `adjoint_sweep_plain` (lam^{t+1}), summed over
    t = T-1 .. 0 with lam_u = (1 - m) lam^{t+1}: G_k (B, 8, H, W) =
    sum_t lam_u d^t(j + off_k) (d^t zero outside the image), G_0 =
    sum_t lam_u d^t and sum_t m lam^{t+1} (B, H, W), zero without a sparse
    map."""
    b, _, h, w = stash.shape
    masked = None if sparse is None else sparse > 0
    g_acc = stash.new_zeros((b, 8, h, w))
    g0_acc = stash.new_zeros((b, h, w))
    d_sparse = stash.new_zeros((b, h, w))
    for t in reversed(range(num_iters)):
        lam = lam_stash[:, t]
        lam_u = lam
        if masked is not None:
            zero = torch.zeros_like(lam)
            lam_u = torch.where(masked, zero, lam)
            d_sparse = d_sparse + torch.where(masked, lam, zero)
        d = stash[:, t]
        dpad = F.pad(d, (1, 1, 1, 1))
        g0_acc = g0_acc + lam_u * d
        for k, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
            g_acc[:, k] += lam_u * dpad[:, 1 + dy:1 + dy + h,
                                        1 + dx:1 + dx + w]
    return g_acc, g0_acc, d_sparse


# The H-tiled route's kernels K4-K6 take JAX's contract of
# `_cspn_pallas_tiled` (raw guidance, blur and sparse; the normalization and
# d^0's anchor inside the op, their gradients inside the adjoint): the
# functions of K1-K3.
cspn_tiled_fwd_plain = cspn_propagate_ref_nchw      # K4
cspn_tiled_fwd_stash_plain = cspn_fwd_stash_plain   # K5
cspn_tiled_bwd_plain = cspn_bwd_plain               # K6


# ---------------------------------------------------------------------------
# The normalization alone (`cspn_gates9`, the slab route's) and the
# prenormalized contract of the spatially sharded CSPN (the JAX package's
# parallel/halo.py normalizes each shard, then runs its slab kernels on
# gates9): the slab kernels K7-K9 see only gates9, d^0 and the sparse map.


def prenorm_gates9(guidance: torch.Tensor, norm_type: str,
                   eps: float = 1e-8) -> torch.Tensor:
    """(B, 8, H, W) raw guidance -> (B, 9, H, W) float32 gates: channel 0
    the centre gate 1 - sum_k gate_k, channels 1..8 the normalized gates
    in NEIGHBOR_OFFSETS order (the JAX package's `_prenorm_gates9`,
    channels first). Differentiable by torch autograd, which takes
    d|g|/dg = sign(g) = 0 at g = 0, as the adjoint kernels do."""
    if guidance.is_cuda:
        prenorm_gates9.cuda_calls += 1
    gates, center = normalize_affinity(guidance.float(), norm_type, eps,
                                       dim=1)
    return torch.cat([center, gates], dim=1)


prenorm_gates9.cuda_calls = 0


def prenorm_gates9_bwd_plain(guidance: torch.Tensor, d_gates9: torch.Tensor,
                             norm_type: str) -> torch.Tensor:
    """The normalization's adjoint, `cspn_gates9_bwd`'s plain version:
    torch autograd of `prenorm_gates9` at guidance (B, 8, H, W) for the
    cotangent d_gates9 (B, 9, H, W) -> d_guidance (B, 8, H, W)."""
    with torch.enable_grad():
        g = guidance.detach().requires_grad_()
        (d_guid,) = torch.autograd.grad(prenorm_gates9(g, norm_type), g,
                                        d_gates9)
    return d_guid


def cspn_propagate_prenorm_ref(
    gates9: torch.Tensor,
    d0: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    num_iters: int,
) -> torch.Tensor:
    """Propagation with prenormalized gates9 (B, 9, H, W) and NO anchoring
    of d^0 (B, H, W) on entry: zero border, the anchor after every
    iteration (the JAX package's `cspn_propagate_prenorm_ref`)."""
    return _iterate(gates9[:, 0], gates9[:, 1:], d0, sparse_depth,
                    num_iters)


# The slab kernels of the spatially sharded CSPN (parallel/halo.py; the JAX
# package's `_cspn_prenorm_fwd_impl`, `_cspn_prenorm_stash_fwd` and
# `_cspn_prenorm_bwd_impl`: gates9 with the centre first, no anchor on
# entry, an anchor after every iteration; the adjoint returns d_gates9,
# lam^0 unmasked and sum_t m lam^{t+1}), applied to a slab of H/S + 2k rows
# for the r <= k iterations of one round. With anchor_d0, d^0 is anchored
# first (the slab route's first round), and the adjoint takes that anchor's
# gradients too: lam^0 masked and m lam^0 added to the sparse sum.


def cspn_prenorm_fwd_plain(gates9: torch.Tensor, d0: torch.Tensor,
                           sparse: torch.Tensor | None, *, num_iters: int,
                           anchor_d0: bool = False) -> torch.Tensor:
    """K7's plain version: `cspn_propagate_prenorm_ref`, from d^0 anchored
    first with anchor_d0."""
    if anchor_d0:
        d0 = anchor(d0, sparse)
    return cspn_propagate_prenorm_ref(gates9, d0, sparse,
                                      num_iters=num_iters)


def cspn_prenorm_fwd_stash_plain(
    gates9: torch.Tensor,
    d0: torch.Tensor,
    sparse: torch.Tensor | None,
    *,
    num_iters: int,
    anchor_d0: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's plain version: cspn_prenorm_fwd_plain's output and the stash
    (B, T, H, W), stash[:, t] = d^t, the plane iteration t starts from."""
    if anchor_d0:
        d0 = anchor(d0, sparse)
    stash: list[torch.Tensor] = []
    out = _iterate(gates9[:, 0], gates9[:, 1:], d0, sparse, num_iters, stash)
    return out, _stacked(stash, d0)


def cspn_prenorm_bwd_plain(
    gates9: torch.Tensor,
    sparse: torch.Tensor | None,
    stash: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    num_iters: int,
    anchor_d0: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9's plain version, the adjoint of cspn_prenorm_fwd_plain from the
    stash of cspn_prenorm_fwd_stash_plain: (d_gates9 (B, 9, H, W) = [G_0,
    G_1..8], lam0 = dL/dd^0 (B, H, W), d_sparse_acc = sum_t m lam^{t+1}
    (B, H, W), zero without a sparse map). No chain rule. With anchor_d0,
    lam0 is d^0's own gradient through its anchor, (1 - m) dL/dd^0, and the
    sparse sum takes m dL/dd^0."""
    lam_stash, lam0 = adjoint_sweep_plain(gates9, sparse, grad_out,
                                          num_iters=num_iters)
    d_gates9, d_sparse = cspn_bwd_sums_plain(sparse, stash, lam_stash,
                                             num_iters=num_iters)
    if anchor_d0:
        lam0, d_sparse = anchor_grad_plain(sparse, lam0, d_sparse)
    return d_gates9, lam0, d_sparse


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
