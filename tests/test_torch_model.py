"""The port's model (cspn_monodepth_tpu_torch.models) against the JAX package.

The JAX `CSPNDepthNet` is initialized, its weights are randomized as
tests/test_full_model_parity.py does (non-zero heads, non-trivial BN
statistics), and `load_jax_variables` copies them into the port's model.
Both run the same numpy input in float32 on the CPU.

Tolerance: rtol 2e-3, atol 2e-4 * max|want|, as the full-model parity test
uses: some fifty f32 convolutions summed in another order by XLA and by
PyTorch, then the CSPN iterations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cspn_monodepth_tpu.models import CSPNDepthNet as JaxCSPNDepthNet
from cspn_monodepth_tpu_torch.models import (
    CSPNDepthNet,
    jax_variables,
    load_jax_variables,
)

# The synthetic_tiny architecture: bottleneck blocks, one per stage, width 16.
TINY = dict(arch=None, encoder_stages=(1, 1, 1, 1), encoder_width=16,
            decoder_channels=(32, 24, 16, 16), decoder_out=16)
CHANNELS = {"rgbd": 4, "rgb": 3, "d": 1}
RTOL, ATOL_SCALE = 2e-3, 2e-4


def randomize(variables, seed=0):
    """Give every parity-relevant leaf a non-trivial value: the heads are
    zero at init (identity CSPN) and BN statistics trivial."""
    rng = np.random.default_rng(seed)

    def leafmap(path, x):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        x = np.asarray(x)
        if name.endswith("head_kernel"):
            return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
        if name.endswith("depth_head_bias"):
            return np.full(x.shape, 0.5, np.float32)
        if name.endswith("guidance_head_bias"):
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name.endswith("scale"):
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        if name.endswith("bias"):
            return rng.uniform(-0.1, 0.1, x.shape).astype(np.float32)
        if name.endswith("mean"):
            return rng.uniform(-0.3, 0.3, x.shape).astype(np.float32)
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leafmap, variables)


def make_input(seed, modality, b, h, w, n_sparse=40):
    """Random rgb in [0, 1) and n_sparse anchors in [0.5, 9.5) per image,
    laid out as the modality's (B, H, W, C) input."""
    rng = np.random.default_rng(seed)
    rgb = rng.random((b, h, w, 3), dtype=np.float32)
    sparse = np.zeros((b, h * w), np.float32)
    for i in range(b):
        sparse[i, rng.choice(h * w, n_sparse, replace=False)] = rng.uniform(
            0.5, 9.5, n_sparse)
    sparse = sparse.reshape(b, h, w, 1)
    return {"rgbd": np.concatenate([rgb, sparse], -1), "rgb": rgb,
            "d": sparse}[modality]


def jax_model_variables(modality, h, w, seed=0, **kw):
    """A float32 JAX model and its randomized variables (numpy leaves)."""
    model = JaxCSPNDepthNet(modality=modality, dtype=jnp.float32, **kw)
    x = jnp.zeros((1, h, w, CHANNELS[modality]), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), x, train=False)
    return model, randomize(jax.tree.map(np.asarray, variables), seed)


def port_model(modality, variables, **kw):
    model = CSPNDepthNet(modality=modality, dtype="float32", **kw)
    return load_jax_variables(model, variables).eval()


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SCALE * np.abs(want).max())


@pytest.mark.parametrize("cspn_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("modality", ["rgbd", "rgb", "d"])
@pytest.mark.parametrize("hw", [(64, 96), (57, 76)])
def test_forward_matches_jax(hw, modality, cspn_impl):
    """64x96 divides by 32 (and takes the JAX package's packed tail and
    stem); 57x76 does not, and exercises the decoder's crop after the
    up-convolutions. "pallas" runs the JAX kernel in interpret mode."""
    kw = dict(num_iters=6, norm_type="8sum_clamp", **TINY)
    model, variables = jax_model_variables(modality, *hw, cspn_impl=cspn_impl,
                                           **kw)
    x = make_input(1, modality, 2, *hw)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_model(modality, variables, **kw)(torch.from_numpy(x))
    assert got.shape == want.shape == (2, *hw, 1)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want)
    assert np.abs(want).max() > 0.05      # heads and CSPN are not trivial


@pytest.mark.slow
def test_resnet50_forward_matches_jax_at_nyu_size():
    """The served configuration: ResNet-50, rgbd, 228x304, T=24."""
    kw = dict(num_iters=24, norm_type="8sum_clamp", arch="resnet50")
    model, variables = jax_model_variables("rgbd", 228, 304, cspn_impl="jnp",
                                           **kw)
    x = make_input(2, "rgbd", 1, 228, 304, n_sparse=500)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_model("rgbd", variables, **kw)(torch.from_numpy(x))
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("modality", ["rgbd", "d"])
def test_anchors_are_exact(modality):
    kw = dict(num_iters=8, norm_type="8sum", **TINY)
    _, variables = jax_model_variables(modality, 57, 76, **kw)
    x = make_input(3, modality, 2, 57, 76)
    with torch.no_grad():
        got = port_model(modality, variables, **kw)(torch.from_numpy(x))
    sparse = x[..., -1:]
    m = sparse > 0
    np.testing.assert_array_equal(got.numpy()[m], sparse[m])


def test_jax_variables_round_trip_has_the_jax_tree():
    """jax_variables writes the JAX package's tree (every leaf, its shape)
    and load_jax_variables reads it back unchanged."""
    _, want = jax_model_variables("rgbd", 64, 96, **TINY)
    model = port_model("rgbd", want, **TINY)
    got = jax_variables(model)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for path, leaf in flat_want.items():
        np.testing.assert_array_equal(flat_got[path], leaf)


def test_load_jax_variables_is_strict():
    _, variables = jax_model_variables("rgbd", 64, 96, **TINY)
    extra = jax.tree.map(lambda a: a, variables)
    extra["params"]["unused_kernel"] = np.zeros((3, 3, 1, 1), np.float32)
    with pytest.raises(ValueError, match="unused_kernel"):
        port_model("rgbd", extra, **TINY)
    missing = jax.tree.map(lambda a: a, variables)
    del missing["batch_stats"]["encoder"]["bn1"]
    with pytest.raises(KeyError, match="bn1"):
        port_model("rgbd", missing, **TINY)
    with pytest.raises(ValueError, match="shape"):     # rgb weights, rgbd net
        port_model("rgb", variables, **TINY)


def test_fresh_model_head_is_zero_so_clamped_cspn_is_identity():
    """As in the JAX package: zero heads and 8sum_clamp make the CSPN the
    identity, so the output is the zero blur depth with anchors pasted."""
    model = CSPNDepthNet(modality="rgbd", num_iters=4, dtype="float32",
                         **TINY).eval()
    x = make_input(4, "rgbd", 1, 32, 48)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x[..., 3:])


@pytest.mark.parametrize("kw,error", [
    (dict(encoder_block="wide"), ValueError),
    (dict(decoder_block="deconv"), ValueError),
    (dict(modality="rgbdd"), ValueError),
])
def test_unported_or_unknown_architecture_raises(kw, error):
    with pytest.raises(error):
        CSPNDepthNet(**{**TINY, **kw})


def test_forward_rejects_wrong_channel_count():
    model = CSPNDepthNet(modality="rgb", dtype="float32", **TINY)
    with pytest.raises(ValueError, match="expects"):
        model(torch.zeros(1, 32, 48, 4))
