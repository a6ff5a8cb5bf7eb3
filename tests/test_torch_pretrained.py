"""The port's torchvision encoder loader (models/torch_weights.py) and
`model.pretrained` in `Trainer.init_state`, against the JAX package's
`convert_torch_resnet` / `load_pretrained_encoder`, on the CPU.

The torchvision-layout state dicts are built here from seeded numpy
weights, with torchvision's names (`layerL.B.convN`, `downsample.{0,1}`,
`fc.*`, `num_batches_tracked`): no torchvision and no ImageNet file is
needed. Loading copies tensors (and averages conv1's RGB filters for the
4th or only channel, in float32 in both packages), so everything is held
bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from cspn_monodepth_tpu.models.torch_weights import (
    convert_torch_resnet as jax_convert,
    load_pretrained_encoder as jax_load_pretrained,
)
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import (
    CSPNDepthNet,
    ResNetEncoder,
    jax_variables,
    load_pretrained_encoder,
)
from cspn_monodepth_tpu_torch.models.resnet import ARCHS
from cspn_monodepth_tpu_torch.train import Trainer

# flax leaf -> torch tensor name of a conv or BN module
LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
        "mean": "running_mean", "var": "running_var"}


def torchvision_state_dict(arch: str, seed: int = 0,
                           batches_tracked: bool = True) -> dict:
    """Seeded weights of a torchvision ResNet (resnet18/34/50) in its own
    layout and names, fc included."""
    stages, block = ARCHS[arch]
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.standard_normal((cout, cin, k, k), np.float32))

    def bn(name, c):
        sd[f"{name}.weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, c)
                                                .astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(rng.uniform(-0.2, 0.2, c)
                                              .astype(np.float32))
        sd[f"{name}.running_mean"] = torch.from_numpy(
            rng.uniform(-0.3, 0.3, c).astype(np.float32))
        sd[f"{name}.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        if batches_tracked:
            sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for layer, n in enumerate(stages, start=1):
        ch = 64 * 2 ** (layer - 1)
        for b in range(n):
            p = f"layer{layer}.{b}"
            if block == "basic":
                out = ch
                conv(f"{p}.conv1", ch, cin, 3)
                bn(f"{p}.bn1", ch)
                conv(f"{p}.conv2", ch, ch, 3)
                bn(f"{p}.bn2", ch)
            else:
                out = 4 * ch
                conv(f"{p}.conv1", ch, cin, 1)
                bn(f"{p}.bn1", ch)
                conv(f"{p}.conv2", ch, ch, 3)
                bn(f"{p}.bn2", ch)
                conv(f"{p}.conv3", out, ch, 1)
                bn(f"{p}.bn3", out)
            if b == 0 and (layer > 1 or cin != out):
                conv(f"{p}.downsample.0", out, cin, 1)
                bn(f"{p}.downsample.1", out)
            cin = out
    sd["fc.weight"] = torch.from_numpy(
        rng.standard_normal((1000, cin), np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def flax_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flax_leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def as_port_state(params, stats) -> dict:
    """The JAX converter's (params, batch_stats) as torch tensor names and
    layouts."""
    out = {}
    for tree in (params, stats):
        for path, a in flax_leaves(tree):
            if path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1)
            out[".".join(path[:-1] + (LEAF[path[-1]],))] = a
    return out


@pytest.mark.parametrize("in_channels", [1, 3, 4])
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_loader_matches_jax_convert(arch, in_channels):
    sd = torchvision_state_dict(arch, seed=in_channels)
    stages, block = ARCHS[arch]
    enc = ResNetEncoder(in_channels, stages, 64, block)
    load_pretrained_encoder(enc, sd)
    want = as_port_state(*jax_convert(sd, in_channels, arch=arch))
    got = {k: v.numpy() for k, v in enc.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    rgb = sd["conv1.weight"].numpy()
    w1 = got["conv1.weight"]
    if in_channels == 4:
        np.testing.assert_array_equal(w1[:, :3], rgb)
        np.testing.assert_array_equal(w1[:, 3:], rgb.mean(1, keepdims=True))
    # torchvision's counters are copied where the file has them.
    assert int(enc.bn1.num_batches_tracked) == 7


@pytest.mark.parametrize("fault", ["unknown", "missing", "shape"])
def test_loader_is_strict(fault):
    sd = torchvision_state_dict("resnet18")
    if fault == "unknown":
        sd["layer5.0.conv1.weight"] = torch.zeros(1)
    elif fault == "missing":
        del sd["layer2.0.downsample.1.running_var"]
    else:
        sd["layer3.1.conv2.weight"] = torch.zeros(256, 128, 3, 3)
    enc = ResNetEncoder(4, ARCHS["resnet18"][0], 64, "basic")
    match = {"unknown": "layer5_block0", "missing": "bn_proj.running_var",
             "shape": "layer3_block1.conv2"}[fault]
    with pytest.raises(ValueError, match=match):
        load_pretrained_encoder(enc, sd)


def test_loader_ignores_fc_and_takes_files_without_counters(tmp_path):
    """A .pth saved before torch 0.4.1 has no num_batches_tracked; fc.* is
    never used. The file is read with weights_only=True."""
    sd = torchvision_state_dict("resnet18", batches_tracked=False)
    path = tmp_path / "resnet18.pth"
    torch.save(sd, path)
    enc = ResNetEncoder(3, ARCHS["resnet18"][0], 64, "basic")
    load_pretrained_encoder(enc, str(path))
    np.testing.assert_array_equal(enc.layer4_block1.bn2.running_var.numpy(),
                                  sd["layer4.1.bn2.running_var"].numpy())
    assert int(enc.bn1.num_batches_tracked) == 0


def ref_config(tmp_path, path):
    """nyu_completion_500_ref with resnet18 at 32x48 and a narrow decoder
    (the recipe's norm, encoder lr and pretrained encoder)."""
    return get_config("nyu_completion_500_ref").override(**{
        "data.dataset": "synthetic", "data.height": 32, "data.width": 48,
        "data.num_workers": 2, "model.arch": "resnet18",
        "model.decoder_channels": (32, 24, 16, 16), "model.decoder_out": 16,
        "model.dtype": "float32", "model.pretrained": str(path),
        "train.checkpoint_dir": str(tmp_path)})


def test_init_state_grafts_the_pretrained_encoder_as_jax_does(tmp_path):
    """Trainer.init_state from the same variables with model.pretrained
    equals JAX's load_pretrained_encoder of those variables and the file,
    leaf for leaf: the encoder is the file's, the decoder and the head
    the variables'."""
    path = tmp_path / "resnet18.pth"
    torch.save(torchvision_state_dict("resnet18", seed=5), path)
    cfg = ref_config(tmp_path, path)
    assert cfg.model.require_pretrained and cfg.model.norm_type == "8sum"
    fresh = CSPNDepthNet.from_config(
        cfg.model, generator=torch.Generator().manual_seed(9))
    variables = jax_variables(fresh)
    state = Trainer(cfg, device="cpu").init_state(variables)
    want = jax_load_pretrained(variables, str(path), in_channels=4,
                               arch="resnet18")
    got = jax_variables(state.model)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_got.keys() == flat_want.keys()
    for p, leaf in flat_want.items():
        np.testing.assert_array_equal(flat_got[p], leaf,
                                      err_msg=jax.tree_util.keystr(p))
    # Not vacuous: the encoder changed, the decoder did not.
    enc0 = variables["params"]["encoder"]["layer1_block0"]["conv1"]["kernel"]
    assert not np.array_equal(
        got["params"]["encoder"]["layer1_block0"]["conv1"]["kernel"], enc0)
    with pytest.raises(ValueError, match="pretrained"):
        Trainer(ref_config(tmp_path, ""), device="cpu").init_state()


def test_encoder_takes_a_tenth_of_the_update_for_identical_gradients(
        tmp_path):
    """nyu_completion_500_ref's encoder_lr_mult 0.1: with weight decay and
    the clip off, every parameter given the same gradient moves by lr *
    g in the decoder and the head and by 0.1 * lr * g in the encoder."""
    path = tmp_path / "resnet18.pth"
    torch.save(torchvision_state_dict("resnet18"), path)
    cfg = ref_config(tmp_path, path).override(**{
        "train.weight_decay": 0.0, "train.clip_norm": 0.0})
    state = Trainer(cfg, device="cpu").init_state()
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    for p in state.model.parameters():
        p.grad = torch.full_like(p, 0.25)
    state.apply_gradients(lambda step: cfg.train.lr)
    # A float32 update rounds once at the weight: within one ulp of it.
    for n, p in state.model.named_parameters():
        mult = 0.1 if n.startswith("encoder.") else 1.0
        delta = (before[n] - p.detach()).numpy()
        ulp = np.spacing(np.abs(before[n].numpy()))
        assert (np.abs(delta - mult * cfg.train.lr * 0.25)
                <= ulp + 1e-9).all(), n


def test_cli_trains_the_ref_recipe_from_a_pth(tmp_path, capsys):
    """`--config nyu_completion_500_ref --set model.pretrained=<file>`
    trains; without the file it refuses, as the JAX CLI does."""
    from cspn_monodepth_tpu_torch.main import main as cli_main

    path = tmp_path / "resnet18.pth"
    torch.save(torchvision_state_dict("resnet18"), path)
    args = ["--config", "nyu_completion_500_ref", "--device", "cpu",
            "--workdir", str(tmp_path / "run")]
    for k, v in {"data.dataset": "synthetic", "data.height": 32,
                 "data.width": 48, "data.num_workers": 2,
                 "model.arch": "resnet18", "model.decoder_channels":
                 "32,24,16,16", "model.decoder_out": 16,
                 "model.num_iters": 4, "train.batch_size": 2,
                 "train.steps_per_epoch": 2, "train.epochs": 1}.items():
        args += ["--set", f"{k}={v}"]
    with pytest.raises(ValueError, match="pretrained"):
        cli_main(args)
    assert cli_main(args + ["--set", f"model.pretrained={path}"]) == 0
    assert "eval rmse" in capsys.readouterr().out
