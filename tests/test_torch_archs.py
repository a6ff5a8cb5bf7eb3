"""The port's ResNet-18/34 basic-block encoder and upconv decoder against
the JAX package, on the CPU.

The JAX modules are initialized, their weights randomized as
tests/test_torch_model.py does (non-zero heads, non-trivial BN
statistics), and `load_jax_variables` copies them into the port's.
* Encoder pyramids: the full-width ResNet-18 encoder and a width-8
  ResNet-34 (its (3, 4, 6, 3) basic stages) at 32x48, every level within
  rtol 2e-3, atol 2e-4 * max|want| (test_torch_model.py's forward
  tolerance: f32 convolutions summed in another order).
* The whole network with basic blocks and upconv blocks at 57x76, which
  does not divide by 32 (the decoder's crops), same tolerance.
* `jax_variables` writes the JAX tree for both blocks, leaf for leaf.
* `DepthPredictor.from_variables` serves such a model at 57x76 requests
  padded to its 64x96 as JAX's does, same tolerance.
* One train step of synthetic_tiny with basic blocks and upconv blocks
  against the JAX Trainer, float32, plain stem, the same weights, batch and
  injected sparse map: the loss within 1e-5 relative and every leaf of the
  state within max|a - b| <= 1e-4 max|b| (tests/test_torch_train.py's
  tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from cspn_monodepth_tpu.configs import get_config as jax_get_config
from cspn_monodepth_tpu.models.resnet import ResNetEncoder as JaxEncoder
from cspn_monodepth_tpu.serving import DepthPredictor as JaxDepthPredictor
from cspn_monodepth_tpu.train.loop import Trainer as JaxTrainer
from cspn_monodepth_tpu.train.train_state import create_train_state
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import (
    CSPNDepthNet,
    ResNetEncoder,
    jax_variables,
    load_jax_variables,
)
from cspn_monodepth_tpu_torch.serving import DepthPredictor
from cspn_monodepth_tpu_torch.train import Trainer
from test_torch_model import (
    assert_close,
    jax_model_variables,
    make_input,
    port_model,
    randomize,
)

LOSS_TOL = 1e-5
STATE_TOL = 1e-4
# A tiny network of each new block: basic encoder blocks, upconv decoder.
BASIC_UPCONV = dict(arch=None, encoder_stages=(1, 1, 1, 1), encoder_width=16,
                    encoder_block="basic", decoder_channels=(32, 24, 16, 16),
                    decoder_out=16, decoder_block="upconv")


class _EncoderOnly(nn.Module):
    """The port encoder beside a 1-channel head, so that load_jax_variables
    (which maps a whole network) fills it from a JAX encoder's tree."""

    def __init__(self, encoder):
        super().__init__()
        self.encoder = encoder
        self.head = nn.Conv2d(1, 9, 3, padding=1)


def head_leaves(rng):
    return {"depth_head_kernel": rng.random((3, 3, 1, 1), np.float32),
            "guidance_head_kernel": rng.random((3, 3, 1, 8), np.float32),
            "depth_head_bias": np.zeros(1, np.float32),
            "guidance_head_bias": np.zeros(8, np.float32)}


@pytest.mark.parametrize("stages,width", [
    ((2, 2, 2, 2), 64),                 # resnet18 at full width
    ((3, 4, 6, 3), 8),                  # resnet34's stages, narrow
])
def test_basic_encoder_pyramid_matches_jax(stages, width):
    jax_enc = JaxEncoder(stage_sizes=stages, width=width, block="basic",
                         dtype=jnp.float32, packed_stem=False)
    x = make_input(0, "rgbd", 2, 32, 48)
    variables = jax_enc.init(jax.random.PRNGKey(0), jnp.zeros_like(x))
    variables = randomize(jax.tree.map(np.asarray, variables), 1)
    want = jax_enc.apply(variables, jnp.asarray(x), train=False)

    enc = ResNetEncoder(4, stages, width, "basic")
    tree = {"params": {"encoder": variables["params"],
                       **head_leaves(np.random.default_rng(0))},
            "batch_stats": {"encoder": variables["batch_stats"]}}
    load_jax_variables(_EncoderOnly(enc), tree)
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert enc.skip_channels == tuple(w.shape[-1] for w in want)
    assert enc.skip_channels == (width,) + tuple(width * 2 ** i
                                                 for i in range(4))
    # layer1_block0 keeps its identity shortcut (64 -> 64, stride 1).
    assert enc.layer1_block0.conv_proj is None
    assert enc.layer2_block0.conv_proj is not None
    for g, w in zip(got, want):
        assert_close(g.permute(0, 2, 3, 1).numpy(), np.asarray(w))


@pytest.mark.parametrize("modality", ["rgbd", "d"])
def test_basic_upconv_network_matches_jax_at_an_odd_size(modality):
    """57x76: every upconv block crops its conv of the unpooled map."""
    kw = dict(num_iters=6, norm_type="8sum", **BASIC_UPCONV)
    model, variables = jax_model_variables(modality, 57, 76,
                                           cspn_impl="jnp", **kw)
    x = make_input(2, modality, 2, 57, 76)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_model(modality, variables, **kw)(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 57, 76, 1)
    assert_close(got.numpy(), want)
    assert np.abs(want).max() > 0.05


@pytest.mark.parametrize("encoder_block", ["basic", "bottleneck"])
def test_jax_variables_round_trip_for_the_new_blocks(encoder_block):
    """JAX's upconv blocks hold `conv_up` as a bare parameter and
    `conv_skip/kernel`; the port's concat conv splits back into both."""
    kw = {**BASIC_UPCONV, "encoder_block": encoder_block}
    _, want = jax_model_variables("rgbd", 64, 96, **kw)
    got = jax_variables(port_model("rgbd", want, **kw))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for path, leaf in flat_want.items():
        np.testing.assert_array_equal(flat_got[path], leaf)
    assert "conv_up" in want["params"]["decoder"]["upproj1"]
    assert "kernel" in want["params"]["decoder"]["upproj1"]["conv_skip"]


def test_resnet_presets_build_the_jax_skip_widths():
    for arch, skips in (("resnet18", (64, 64, 128, 256, 512)),
                        ("resnet34", (64, 64, 128, 256, 512)),
                        ("resnet50", (64, 256, 512, 1024, 2048))):
        model = CSPNDepthNet(arch=arch, decoder_block="upconv")
        assert model.encoder.skip_channels == skips, arch
        blocks = [n for n, _ in model.encoder.named_children()
                  if n.startswith("layer")]
        assert len(blocks) == {"resnet18": 8}.get(arch, 16), arch


def test_predictor_serves_basic_upconv_models_as_jax_does():
    over = {"model.dtype": "float32", "model.arch": "",
            "model.encoder_block": "basic", "model.decoder_block": "upconv"}
    jax_cfg = jax_get_config("synthetic_tiny").override(**over)
    cfg = get_config("synthetic_tiny").override(**over)
    m = jax_cfg.model
    _, variables = jax_model_variables(
        "rgbd", 64, 96, seed=6, num_iters=m.num_iters,
        norm_type=m.norm_type, **BASIC_UPCONV)
    x = make_input(4, "rgbd", 2, 57, 76)
    want = JaxDepthPredictor.from_variables(jax_cfg, variables).predict_batch(
        x[..., :3], x[..., 3])
    got = DepthPredictor.from_variables(cfg, variables, device="cpu"
                                        ).predict_batch(x[..., :3], x[..., 3])
    assert got.shape == want.shape == (2, 57, 76)
    assert_close(got, np.asarray(want))


# ------------------------------------------------------------ train step
TRAIN = {"model.dtype": "float32", "data.num_workers": 2,
         "model.arch": "", "model.encoder_block": "basic",
         "model.decoder_block": "upconv"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One train step of the JAX Trainer and of the port's on the same
    randomized weights, batch and sparse map."""
    work = str(tmp_path_factory.mktemp("jax_basic_upconv"))
    cfg = jax_get_config("synthetic_tiny").override(**{
        **TRAIN, "model.packed_stem": False, "train.checkpoint_dir": work})
    trainer = JaxTrainer(cfg)
    init = trainer.init_state()
    variables = randomize(jax.device_get(
        {"params": init.params, "batch_stats": init.batch_stats}), 3)
    recs = [trainer.train_ds.get(i) for i in range(cfg.train.batch_size)]
    batch = {k: np.stack([r[k] for r in recs]) for k in ("rgb", "depth")}
    sparse = np.where(np.random.default_rng(3).random(batch["depth"].shape)
                      < 0.01, batch["depth"], 0.0).astype(np.float32)
    trainer._sample_sparse = lambda key, depth, rgb: jnp.asarray(sparse)
    state = create_train_state(variables, trainer.tx)
    state, loss, _ = trainer.train_step(state, batch, jax.random.PRNGKey(0))
    want = dict(loss=float(loss), state=jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))

    port = Trainer(get_config("synthetic_tiny").override(**TRAIN),
                   device="cpu")
    port._sample_sparse = lambda gen, depth, rgb: torch.from_numpy(sparse)
    pstate = port.init_state(variables)
    pstate, ploss, _ = port.train_step(pstate, batch)
    got = dict(loss=float(ploss), state=jax_variables(pstate.model))
    return dict(want=want, got=got, init=variables)


def test_basic_upconv_train_step_loss_matches_jax(runs):
    assert runs["got"]["loss"] == pytest.approx(runs["want"]["loss"],
                                                rel=LOSS_TOL)


def test_basic_upconv_train_step_state_matches_jax(runs):
    want = dict(jax.tree_util.tree_leaves_with_path(runs["want"]["state"]))
    got = dict(jax.tree_util.tree_leaves_with_path(runs["got"]["state"]))
    init = dict(jax.tree_util.tree_leaves_with_path(runs["init"]))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        err = (np.abs(np.asarray(got[path], np.float64) - leaf).max()
               / max(np.abs(leaf).max(), 1e-30))
        assert err <= STATE_TOL, jax.tree_util.keystr(path)
    # The step moved the upconv blocks' weights: the check is not vacuous.
    moved = [p for p in want if "conv_up" in jax.tree_util.keystr(p)]
    assert moved and all(np.abs(want[p] - init[p]).max() > 0 for p in moved)
