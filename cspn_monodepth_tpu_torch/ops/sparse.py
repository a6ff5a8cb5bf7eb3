"""Sparse depth sampling on the device (PyTorch).

Counterpart of cspn_monodepth_tpu/ops/sparse.py: the reference samples the
sparse input in its data workers (`dense_to_sparse.py: UniformSampling`),
exactly `num_samples` pixels uniformly among those with ground truth > 0.
Here, as in the JAX package, it runs on the device inside the step: draw
an i.i.d. uniform score for every pixel, give invalid pixels -1, and keep
the n highest. Every valid subset of size n is equally likely.

Simulated stereo (`dense_to_sparse.py: SimulatedStereo`) keeps the n valid
pixels of highest image gradient instead (`stereo_scores`), with a small
random tiebreak: stereo matching finds depth at edges and texture.

The scores come from a `torch.Generator` (Philox on a CUDA device), the
JAX package's from threefry: the same seed gives other samples. The
selection, `_top_k_mask`, is the same function in both, which the tests
show by feeding both the same numpy scores. With `global_batch` a rank
draws the scores of the whole batch and keeps its own images', so that on
a mesh the samples do not depend on how the batch is split.
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


def _draw(shape, generator, device, batch_offset: int,
          global_batch: int | None) -> torch.Tensor:
    """U(0, 1) scores of images batch_offset .. batch_offset + B of a
    batch of global_batch (B when None) images of shape[1:]."""
    b, h, w = shape
    u = torch.rand((global_batch or b, h, w), generator=generator,
                   device=device, dtype=torch.float32)
    return u[batch_offset:batch_offset + b]


def _valid(d: torch.Tensor, max_depth: float | None) -> torch.Tensor:
    valid = d > 0
    if max_depth is not None:
        valid &= d <= max_depth
    return valid


def keep_top(d: torch.Tensor, valid: torch.Tensor, scores: torch.Tensor,
             num_samples: int) -> torch.Tensor:
    """d at the num_samples valid pixels of highest score in each image
    (every valid pixel where an image has fewer), 0 elsewhere. d, valid
    and scores: (B, H, W). Invalid pixels score -1, below every valid
    score, so the top k prefers valid pixels; the final mask re-ands with
    `valid` for an image with fewer than k of them."""
    b, h, w = d.shape
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    k = min(num_samples, h * w)
    keep = _top_k_mask(scores.reshape(b, h * w), k).reshape(b, h, w) & valid
    return torch.where(keep, d, torch.zeros_like(d))


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
    scores = _draw(d.shape, generator, d.device, batch_offset, global_batch)
    out = keep_top(d, _valid(d, max_depth), scores, num_samples)
    return out[..., None] if squeeze else out


def stereo_scores(rgb: torch.Tensor) -> torch.Tensor:
    """The simulated-stereo score of every pixel without its tiebreak:
    |gray[y+1, x] - gray[y, x]| + |gray[y, x+1] - gray[y, x]| of the
    channel-mean gray image, the last row and column repeated (their
    differences read 0). rgb: (B, H, W, 3) in [0, 1] -> (B, H, W) f32."""
    gray = rgb.float().mean(dim=-1)
    gy = torch.diff(gray, dim=1, append=gray[:, -1:, :]).abs()
    gx = torch.diff(gray, dim=2, append=gray[:, :, -1:]).abs()
    return gy + gx


def stereo_sparse_sample(
    dense_depth: torch.Tensor,
    rgb: torch.Tensor,
    num_samples: int,
    max_depth: float | None = None,
    generator: torch.Generator | None = None,
    batch_offset: int = 0,
    global_batch: int | None = None,
) -> torch.Tensor:
    """Simulated-stereo sampling: the `num_samples` valid pixels of
    highest `stereo_scores` (plus a U(0, 1e-4) tiebreak drawn from
    `generator`) in each image. dense_depth and the other arguments as in
    uniform_sparse_sample; rgb (B, H, W, 3) in [0, 1] holds the same
    images as dense_depth (this rank's share with `global_batch`)."""
    squeeze = dense_depth.dim() == 4
    d = dense_depth[..., 0] if squeeze else dense_depth
    tiebreak = 1e-4 * _draw(d.shape, generator, d.device, batch_offset,
                            global_batch)
    out = keep_top(d, _valid(d, max_depth), stereo_scores(rgb) + tiebreak,
                   num_samples)
    return out[..., None] if squeeze else out

