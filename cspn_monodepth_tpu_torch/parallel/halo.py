"""Spatially sharded CSPN propagation with a halo exchange (counterpart of
cspn_monodepth_tpu/parallel/halo.py).

Each rank of a spatial group holds H/S rows of the data group's images. The
3x3 stencil needs one row of halo per iteration, so instead of exchanging
every iteration the ranks exchange a k-row halo every k fused iterations
(halo_k): each rank iterates k times on an (H/S + 2k)-row slab; after
iteration j the outer j rows are stale, so after k iterations exactly the
halo rows are and the centre H/S rows equal the unsharded op's. The gates
and the sparse anchors do not change across iterations: their halos are
exchanged once. The first and last shard receive zero rows, which is the
op's zero border.

The normalization runs on each shard (it is pointwise) as the kernel pair
`cspn_gates9`/`cspn_gates9_bwd` (ops/cspn.py `cspn_normalize`), and d^0's
anchor in the first round's slab kernel, on load. The slab body of each
round is the slab forward K7, or K8/K9 under `PrenormCSPNFunction` when a
gradient is wanted (ops/cspn.py `cspn_propagate_prenorm`); `impl="torch"`
runs the plain normalization, anchor and loop under torch autograd instead
(JAX's "jnp"). The exchanges are collectives of the
spatial group (parallel/comm.py), differentiable: the backward sends each
halo's cotangent back and adds it into the sender's edge rows, as XLA
transposes ppermute.

`scatter_rows` and `gather_rows` reshard between the images layout's model
(whole images per rank) and this one, zero-padding H to a multiple of S on
the way in and cropping on the way out. On the rows layout the model
already holds these rows (parallel/rows.py) and calls
`cspn_propagate_spatial` on them directly, with no reshard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cspn_monodepth_tpu_torch.ops.cspn import (
    cspn_normalize,
    cspn_propagate_prenorm,
)
from cspn_monodepth_tpu_torch.parallel.comm import all_to_all


def exchange_halo(x: torch.Tensor, k: int, mesh
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows from the shard above, rows from the shard below) of x (..., H,
    W), the k rows next to this shard on each side; zeros on the first and
    last shard. "Above" is the previous shard, lower global rows."""
    exchange_halo.calls += 1
    n, s = mesh.spatial, mesh.s
    top, bottom = x[..., :k, :], x[..., -k:, :]
    zeros = torch.zeros_like(top)
    # Slot j goes to spatial rank j as [its from_above, its from_below].
    send = torch.stack([
        torch.stack([bottom if j == s + 1 else zeros,
                     top if j == s - 1 else zeros])
        for j in range(n)])
    recv = all_to_all(send, mesh.spatial_group)
    from_above = recv[s - 1, 0] if s > 0 else zeros
    from_below = recv[s + 1, 1] if s < n - 1 else zeros
    return from_above, from_below


exchange_halo.calls = 0


def cspn_propagate_spatial(
    guidance: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    mesh,
    num_iters: int = 24,
    norm_type: str = "8sum",
    halo_k: int = 4,
    impl: str = "auto",
) -> torch.Tensor:
    """CSPN propagation of this rank's H shard: guidance (B, 8, h, W) raw,
    blur and sparse (B, h, W), the rows [s h, (s + 1) h) of the data
    group's images -> the refined depth of those rows (B, h, W). Equals the
    unsharded op's rows (`cspn_propagate_ref`).

    impl: "auto" (the normalization's kernels and the slab kernels K7-K9,
    their plain versions on a CPU tensor) or "torch" (the plain loop under
    autograd).
    """
    # Normalization is pointwise, so it is the same on a shard.
    gates9 = cspn_normalize(guidance, norm_type=norm_type, impl=impl)
    if num_iters == 0:
        return cspn_propagate_prenorm(gates9, blur_depth, sparse_depth,
                                      num_iters=0, impl=impl, anchor_d0=True)
    d = blur_depth
    h_loc = d.shape[-2]
    k = min(halo_k, num_iters)
    if h_loc < k:
        raise ValueError(f"halo_k={k} exceeds the local shard height "
                         f"{h_loc}; halos only reach the next shard")
    # Whole rounds of k, then the remainder (more iterations would change
    # the result).
    rounds = [k] * (num_iters // k) + ([num_iters % k] if num_iters % k
                                      else [])
    # The anchor mask is pointwise (sparse > 0): the zero halo at the
    # global border gives mask 0 there, as in the unsharded op.
    gates_slab = _with_halo(gates9, k, mesh)
    sp_slab = (None if sparse_depth is None
               else _with_halo(sparse_depth, k, mesh))
    for i, r in enumerate(rounds):
        # The first round anchors d^0 on load: the anchor is pointwise, so
        # anchoring the slab anchors the shard and its halos.
        slab = cspn_propagate_prenorm(gates_slab, _with_halo(d, k, mesh),
                                      sp_slab, num_iters=r, impl=impl,
                                      anchor_d0=i == 0)
        d = slab[:, k:k + h_loc]
    return d


def _with_halo(x: torch.Tensor, k: int, mesh) -> torch.Tensor:
    above, below = exchange_halo(x, k, mesh)
    return torch.cat([above, x, below], dim=-2)


def scatter_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's whole images x (b, C, H, W) -> the spatial group's
    S b images (in rank order, the data group's global order), rows
    [s h, (s + 1) h) of H zero-padded to S h: (S b, C, h, W)."""
    n = mesh.spatial
    b, c, height, w = x.shape
    h = -(-height // n)
    x = F.pad(x, (0, 0, 0, n * h - height))
    slots = x.reshape(b, c, n, h, w).permute(2, 0, 1, 3, 4)
    return all_to_all(slots, mesh.spatial_group).reshape(n * b, c, h, w)


def gather_rows(y: torch.Tensor, mesh, height: int) -> torch.Tensor:
    """The inverse of scatter_rows: (S b, C, h, W) row shards -> this
    rank's whole images (b, C, height, W), the padding cropped."""
    n = mesh.spatial
    nb, c, h, w = y.shape
    slots = all_to_all(y.reshape(n, nb // n, c, h, w), mesh.spatial_group)
    whole = slots.permute(1, 2, 0, 3, 4).reshape(nb // n, c, n * h, w)
    return whole[:, :, :height]
