"""The port's DepthPredictor against the JAX package's, on the same weights.

Both are built with `from_variables` from one randomized JAX variable tree
of the synthetic_tiny configuration in float32 (64x96, T=4), and answer
the same numpy requests; the port runs on the CPU (`device="cpu"`).

Tolerance: rtol 2e-3, atol 2e-4 * max|want|, as for the model
(tests/test_torch_model.py): the same f32 network behind the same padding
and cropping.
"""

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu.configs import get_config as jax_get_config
from cspn_monodepth_tpu.serving import DepthPredictor as JaxDepthPredictor
from cspn_monodepth_tpu_torch import CSPNDepthNet, DepthPredictor, get_config
from tests.test_torch_model import (
    assert_close,
    jax_model_variables,
    make_input,
)

H, W = 64, 96


def model_kw(cfg):
    m = cfg.model
    return dict(num_iters=m.num_iters, norm_type=m.norm_type, arch=None,
                encoder_stages=m.encoder_stages,
                encoder_width=m.encoder_width,
                decoder_channels=m.decoder_channels,
                decoder_out=m.decoder_out)


@pytest.fixture(scope="module", params=["rgbd", "rgb"])
def predictors(request):
    """(port, jax) predictors of synthetic_tiny in float32 with one set of
    randomized weights."""
    over = {"model.dtype": "float32", "model.modality": request.param}
    jax_cfg = jax_get_config("synthetic_tiny").override(**over)
    cfg = get_config("synthetic_tiny").override(**over)
    assert (cfg.data.height, cfg.data.width) == (H, W)
    _, variables = jax_model_variables(request.param, H, W, seed=5,
                                       **model_kw(jax_cfg))
    return (DepthPredictor.from_variables(cfg, variables, device="cpu"),
            JaxDepthPredictor.from_variables(jax_cfg, variables))


def requests(seed, b, h, w):
    """rgb (B, h, w, 3) and sparse depth (B, h, w) with 40 anchors each."""
    x = make_input(seed, "rgbd", b, h, w)
    return x[..., :3], x[..., 3]


def test_predict_batch(predictors):
    port, ref = predictors
    rgb, sparse = requests(0, 3, H, W)
    got = port.predict_batch(rgb, sparse)
    want = ref.predict_batch(rgb, sparse)
    assert got.shape == want.shape == (3, H, W)
    assert got.dtype == np.float32
    assert_close(got, want)
    if port.model.modality == "rgbd":
        m = sparse > 0
        np.testing.assert_array_equal(got[m], sparse[m])


def test_predict_single(predictors):
    port, ref = predictors
    rgb, sparse = requests(1, 1, H, W)
    got = port.predict(rgb[0], sparse[0])
    assert got.shape == (H, W)
    assert_close(got, ref.predict(rgb[0], sparse[0]))


def test_uint8_and_smaller_input_are_padded_and_cropped(predictors):
    port, ref = predictors
    rgb8 = np.random.default_rng(2).integers(0, 256, (2, 50, 70, 3),
                                             np.uint8)
    _, sparse = requests(3, 2, 50, 70)
    got = port.predict_batch(rgb8, sparse)
    assert got.shape == (2, 50, 70)
    assert_close(got, ref.predict_batch(rgb8, sparse))
    # uint8 is scaled by 1/255, so it answers like the float image
    assert_close(got, port.predict_batch(rgb8.astype(np.float32) / 255.0,
                                         sparse))


def test_without_sparse_depth(predictors):
    """rgbd without anchors runs on an all-zero sparse channel."""
    port, ref = predictors
    rgb, _ = requests(4, 2, H, W)
    got = port.predict_batch(rgb)
    assert np.isfinite(got).all()
    assert_close(got, ref.predict_batch(rgb))


def test_input_larger_than_configured_raises(predictors):
    port, _ = predictors
    with pytest.raises(ValueError, match="exceeds"):
        port.predict(np.zeros((H + 1, W, 3), np.float32))


def test_cuda_is_the_default_device():
    """Entry points run on the card unless the caller asks for the CPU;
    without a card, asking for it fails instead of falling back."""
    cfg = get_config("synthetic_tiny")
    model = CSPNDepthNet.from_config(cfg.model)
    if torch.cuda.is_available():
        predictor = DepthPredictor(model, cfg.data.height, cfg.data.width)
        assert predictor.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        DepthPredictor(model, cfg.data.height, cfg.data.width)
