"""The port's simulated-stereo sampler (ops/sparse.py:stereo_sparse_sample)
against the JAX package's, on the CPU.

The tiebreak is random: threefry in JAX, a torch.Generator (Philox on the
card) in the port, a difference by design. So the parity test draws JAX's
tiebreak with JAX's own call on the same key, adds it to the port's
`stereo_scores` and selects with the port's `keep_top`: the kept pixels
and their depths must equal JAX's `stereo_sparse_sample` exactly.
`stereo_scores` is also held to a numpy transcription of the gradient
(float32 sums of two or three terms, rtol 1e-6). The rest are the port's
counterparts of tests/test_sparse.py's stereo tests, the depth cap, a
batch split over ranks, and the Trainer's sampler option.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_monodepth_tpu.ops import stereo_sparse_sample as jax_stereo
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.ops.sparse import (
    keep_top,
    stereo_scores,
    stereo_sparse_sample,
)
from cspn_monodepth_tpu_torch.train import Trainer


def problem(seed, b, h, w, invalid=0.3, far=0.0):
    """Depth in 0.5..9.5 m with a share of holes (and of depths past 9.5
    m), rgb with smooth structure and noise, as numpy float32."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 9.5, (b, h, w)).astype(np.float32)
    depth[rng.random((b, h, w)) < invalid] = 0.0
    depth[rng.random((b, h, w)) < far] = 12.0
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = np.stack([np.sin(6 * yy), np.cos(5 * xx), yy * xx], -1)
    rgb = np.clip(0.5 + 0.4 * base + rng.normal(0, 0.05, (b, h, w, 3)),
                  0, 1).astype(np.float32)
    return depth, rgb


@pytest.mark.parametrize("b,h,w,n,cap,far", [
    (2, 20, 30, 50, None, 0.0),
    (3, 17, 23, 40, 9.0, 0.1),        # odd sizes, a cap below some depths
    (1, 8, 8, 64, None, 0.0),         # n = H*W: every valid pixel
])
def test_stereo_sample_matches_jax_with_its_tiebreak(b, h, w, n, cap, far):
    depth, rgb = problem(b * h + n, b, h, w, far=far)
    key = jax.random.PRNGKey(n)
    want = np.asarray(jax_stereo(key, jnp.asarray(depth), jnp.asarray(rgb),
                                 n, max_depth=cap))
    tiebreak = np.array(jax.random.uniform(key, (b, h, w), maxval=1e-4))
    d = torch.from_numpy(depth)
    valid = (d > 0) & (d <= (cap if cap is not None else np.inf))
    got = keep_top(d, valid, stereo_scores(torch.from_numpy(rgb))
                   + torch.from_numpy(tiebreak), n).numpy()
    np.testing.assert_array_equal(got, want)
    kept = (got > 0).sum((1, 2))
    assert (kept == np.minimum(n, valid.sum((1, 2)).numpy())).all()


def test_stereo_scores_are_the_gradient_with_zero_at_the_far_edges():
    _, rgb = problem(1, 2, 9, 13)
    gray = rgb.mean(-1)
    want = np.zeros_like(gray)
    want[:, :-1, :] += np.abs(gray[:, 1:] - gray[:, :-1])
    want[:, :, :-1] += np.abs(gray[:, :, 1:] - gray[:, :, :-1])
    got = stereo_scores(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    flat = np.broadcast_to(rgb[:, :1, :1], rgb.shape).copy()
    assert (stereo_scores(torch.from_numpy(flat)) == 0).all()


def test_stereo_sampler_prefers_edges():
    """tests/test_sparse.py's case: a vertical edge at column 12."""
    dense = torch.full((1, 24, 24), 5.0)
    rgb = torch.zeros((1, 24, 24, 3))
    rgb[0, :, 12:] = 1.0
    out = stereo_sparse_sample(dense, rgb, 20,
                               generator=torch.Generator().manual_seed(0))
    assert int((out > 0).sum()) == 20
    _, xs = np.nonzero(out[0].numpy())
    assert (np.abs(xs - 11) <= 1).mean() > 0.9


def test_stereo_sampler_respects_validity_counts_and_the_cap():
    dense = torch.full((2, 16, 16, 1), 5.0)
    dense[0, :8] = 0.0                   # image 0: 128 valid pixels
    dense[1, :, :15] = 20.0              # image 1: 16 under the 10 m cap
    rgb = torch.rand((2, 16, 16, 3), generator=torch.Generator()
                     .manual_seed(1))
    out = stereo_sparse_sample(dense, rgb, 30, max_depth=10.0,
                               generator=torch.Generator().manual_seed(2))
    assert out.shape == dense.shape
    assert (out[0, :8] == 0).all() and int((out[0] > 0).sum()) == 30
    assert int((out[1] > 0).sum()) == 16 and (out[1] <= 10.0).all()


def test_stereo_shares_of_a_batch_equal_the_whole_batch():
    """On a mesh each rank draws the whole batch's tiebreak and keeps its
    own images': the samples do not depend on the split."""
    depth, rgb = problem(3, 4, 12, 18)
    d, c = torch.from_numpy(depth), torch.from_numpy(rgb)
    whole = stereo_sparse_sample(d, c, 25,
                                 generator=torch.Generator().manual_seed(4))
    for rank in range(2):
        part = slice(2 * rank, 2 * rank + 2)
        got = stereo_sparse_sample(
            d[part], c[part], 25, generator=torch.Generator().manual_seed(4),
            batch_offset=2 * rank, global_batch=4)
        torch.testing.assert_close(got, whole[part], rtol=0, atol=0)


def test_trainer_samples_stereo_and_trains(tmp_path):
    cfg = get_config("synthetic_tiny").override(**{
        "data.sampler": "stereo", "data.num_workers": 2,
        "train.steps_per_epoch": 2, "train.checkpoint_dir": str(tmp_path)})
    trainer = Trainer(cfg, device="cpu")
    batch = trainer._unpack(trainer._to_device(
        {k: np.stack([trainer.train_ds.get(i)[k] for i in range(2)])
         for k in ("rgb", "depth")}))
    gen = trainer._rng(0, 0)
    got = trainer._sample_sparse(gen, batch["depth"], batch["rgb"])
    want = stereo_sparse_sample(batch["depth"], batch["rgb"],
                                cfg.data.num_samples, max_depth=10.0,
                                generator=trainer._rng(0, 0))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ((got > 0).sum((1, 2)) == cfg.data.num_samples).all()
    state, metrics = trainer.train_epoch(trainer.init_state(), 0,
                                         log=lambda *a: None)
    assert state.step == 2 and np.isfinite(metrics["loss"])
