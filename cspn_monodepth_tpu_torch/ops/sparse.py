"""Sparse depth sampling on the device (PyTorch).

Counterpart of cspn_monodepth_tpu/ops/sparse.py: the reference samples the
sparse input in its data workers (`dense_to_sparse.py: UniformSampling`),
exactly `num_samples` pixels uniformly among those with ground truth > 0.
Here, as in the JAX package, it runs on the device inside the step: draw
an i.i.d. uniform score for every pixel, give invalid pixels -1, and keep
the n highest. Every valid subset of size n is equally likely.

The scores come from a `torch.Generator` (Philox on a CUDA device), the
JAX package's from threefry: the same seed gives other samples. The
selection, `_top_k_mask`, is the same function in both, which the tests
show by feeding both the same numpy scores.
"""

from __future__ import annotations

import torch


def _top_k_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """keep[b, i] = scores[b, i] >= (k-th largest of scores[b]): the k
    highest of each row and every score tied with the k-th (the JAX
    package's selection, which thresholds at the k-th largest). -0.0 and
    +0.0 compare equal. scores: (B, N) float32, 0 < k <= N."""
    kth = torch.topk(scores, k, dim=1, sorted=False).values.min(
        dim=1, keepdim=True).values
    return scores >= kth


def uniform_sparse_sample(
    dense_depth: torch.Tensor,
    num_samples: int,
    max_depth: float | None = None,
    generator: torch.Generator | None = None,
    batch_offset: int = 0,
    global_batch: int | None = None,
) -> torch.Tensor:
    """Simulate a sparse depth input from dense ground truth.

    dense_depth: (B, H, W) or (B, H, W, 1), invalid = 0. Keeps exactly
    `num_samples` valid pixels per image (all of them where an image has
    fewer); `max_depth` also invalidates depths above it. `generator`
    (on dense_depth's device) draws the scores. Returns the dense values
    at the kept pixels, 0 elsewhere, in dense_depth's shape.

    With `global_batch`, dense_depth holds images batch_offset ..
    batch_offset + B of a batch of that many (one rank's share on a mesh):
    the scores of the whole batch are drawn and those images' kept, so
    that the samples do not depend on how the batch is split.
    """
    squeeze = dense_depth.dim() == 4
    d = dense_depth[..., 0] if squeeze else dense_depth
    b, h, w = d.shape
    valid = d > 0
    if max_depth is not None:
        valid &= d <= max_depth
    scores = torch.rand((global_batch or b, h, w), generator=generator,
                        device=d.device, dtype=torch.float32)
    scores = scores[batch_offset:batch_offset + b]
    # Invalid pixels score -1, below every valid score, so the top k
    # prefers valid pixels; the final mask re-ands with `valid` for an
    # image with fewer than k of them.
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    k = min(num_samples, h * w)
    keep = _top_k_mask(scores.reshape(b, h * w), k).reshape(b, h, w) & valid
    out = torch.where(keep, d, torch.zeros_like(d))
    return out[..., None] if squeeze else out

