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


# ------------------------------------------- the model's input, on the device
@pytest.fixture(scope="module")
def port_only():
    """modality -> the port's predictor of synthetic_tiny in float32 on the
    CPU, with its initial weights."""
    made = {}
    for modality in ("rgbd", "rgb", "d"):
        cfg = get_config("synthetic_tiny").override(
            **{"model.dtype": "float32", "model.modality": modality})
        model = CSPNDepthNet.from_config(
            cfg.model, generator=torch.Generator().manual_seed(7))
        made[modality] = DepthPredictor(model, H, W, device="cpu")
    return made


def host_input(modality, rgb, sparse):
    """The model's input as the host built it in numpy: uint8 scaled by
    1/255, zero padding to (H, W), an all-zero sparse map where none is
    given, the channels the modality reads."""
    rgb = np.asarray(rgb)
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float32) / 255.0
    rgb = rgb.astype(np.float32)
    b, h, w, _ = rgb.shape
    ph, pw = H - h, W - w
    rgb_p = np.pad(rgb, ((0, 0), (0, ph), (0, pw), (0, 0)))
    if modality == "rgb":
        return rgb_p
    if sparse is None:
        sp = np.zeros((b, H, W), np.float32)
    else:
        sp = np.pad(np.asarray(sparse, np.float32), ((0, 0), (0, ph), (0, pw)))
    if modality == "d":
        return sp[..., None]
    return np.concatenate([rgb_p, sp[..., None]], axis=-1)


def captured_input(predictor, rgb, sparse):
    """The model's input of one predict_batch call."""
    seen = []
    hook = predictor.model.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].clone()))
    try:
        predictor.predict_batch(rgb, sparse)
    finally:
        hook.remove()
    assert len(seen) == 1
    return seen[0].numpy()


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("modality", ["rgbd", "rgb", "d"])
@pytest.mark.parametrize("hw", [(H, W), (50, 70)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_input_built_on_the_device_matches_host_construction(
        port_only, dtype, hw, modality, with_sparse):
    """predict_batch builds the model's input on its device from the
    request's arrays as they are; it matches the host's numpy build exactly
    on the padding and the sparse channel, and on rgb to the rounding of a
    division by 255 (CUDA multiplies by the reciprocal)."""
    h, w = hw
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    if dtype == np.float32:
        rgb = rng.random((2, h, w, 3), dtype=np.float32)
    _, sparse = requests(9, 2, h, w)
    sparse = sparse if with_sparse else None
    got = captured_input(port_only[modality], rgb, sparse)
    want = host_input(modality, rgb, sparse)
    assert got.dtype == np.float32 and got.shape == want.shape
    inside = np.zeros(want.shape[:3], bool)
    inside[:, :h, :w] = True
    np.testing.assert_array_equal(got[~inside], want[~inside])
    if modality != "rgb":
        np.testing.assert_array_equal(got[..., -1], want[..., -1])
    if modality != "d":
        np.testing.assert_allclose(got[inside][:, :3], want[inside][:, :3],
                                   rtol=3e-7, atol=0)


@pytest.mark.parametrize("modality", ["rgbd", "d"])
@pytest.mark.parametrize("bad", ["larger", "sparse_shape"])
def test_bad_request_raises_before_any_upload(port_only, modality, bad,
                                              monkeypatch):
    rgb = np.zeros((2, H, W, 3), np.uint8)
    sparse = np.zeros((2, H, W), np.float32)
    if bad == "larger":
        rgb = np.zeros((2, H + 1, W, 3), np.uint8)
        sparse = np.zeros((2, H + 1, W), np.float32)
    else:
        sparse = sparse[:1]
    uploads = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy",
                        lambda a: uploads.append(a) or real(a))
    with pytest.raises(ValueError, match="exceeds|does not match"):
        port_only[modality].predict_batch(rgb, sparse)
    assert uploads == []
