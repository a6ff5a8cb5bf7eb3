"""CSPN++'s context-aware CSPN in the port, on the CPU at small sizes,
against the benchmark's plain reference (benchmark/reference/cspnpp.py,
plain float32 torch that imports nothing of the port).

* The k x k op (k = 5, 7; `cspn_propagate` on k^2 - 1 guidance planes,
  whose wrappers run ops/cspn_ref.py's plain loop and hand-written
  adjoint on a CPU tensor) against the reference's shifted-add loop under
  torch autograd: the output and the gradients of guidance, blur and
  sparse.
* `CSPNDepthNet` at synthetic_tiny's widths with basic blocks, stencils
  (3, 5, 7) and checkpoints (2, 4) of T = 4 against the reference's
  forward, and one `Trainer.train_step`'s loss and gradients, on the
  benchmark's seeded weights.
* The defaults leave the plain CSPN as it was; `DepthPredictor` serves a
  CA-CSPN model; the spans and the counter; what raises.

Tolerances. The op: the reference and the port's plain loop compute the
same float32 expressions in the same order, the port in segments whose
re-anchoring and renormalization are exact, so the output is held to
1e-6 max-relative; the gradients, a hand-written adjoint against torch
autograd (two orders of float32 sums), to 1e-5. The model, all float32
on both sides (the port's model.dtype, the reference's Precision
"float32"; under bf16 autocast the two backward passes round the
convolutions' gradients in another order, 6e-3 of a leaf's norm at this
size): 1e-5 on the output and the loss, 1e-4 on each gradient leaf's
norm. A bf16 head, CSPN and mix (the benchmark's control, checked below)
misses them by two orders.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.reference import cspnpp  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference.steps import leaf_norms  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402
from cspn_monodepth_tpu_torch import (  # noqa: E402
    CSPNDepthNet,
    DepthPredictor,
    get_config,
)
from cspn_monodepth_tpu_torch.models.cspn_net import (  # noqa: E402
    cspnpp_plan,
)
from cspn_monodepth_tpu_torch.ops import cspn_cuda, cspn_propagate  # noqa: E402
from cspn_monodepth_tpu_torch.train import Trainer  # noqa: E402
from cspn_monodepth_tpu_torch.utils import profiling  # noqa: E402

OP_TOL = 1e-6
OP_GRAD_TOL = 1e-5
MODEL_TOL = 1e-5
STEP_TOL = 1e-4
F32 = ref_model.Precision("float32", "float32", "float32")
H, W, B = 32, 48, 2
SIZES, MARKS = (3, 5, 7), (2, 4)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def max_rel(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


# ------------------------------------------------------------ the op

def op_problem(k, with_sparse, seed=0):
    g = torch.Generator().manual_seed(seed)
    guid = 0.5 + torch.rand((B, k * k - 1, 23, 31), generator=g)
    blur = 10 * torch.rand((B, 23, 31), generator=g)
    sparse = torch.where(torch.rand((B, 23, 31), generator=g) < 0.1,
                         1 + 79 * torch.rand((B, 23, 31), generator=g),
                         torch.zeros(()))
    return guid, blur, sparse if with_sparse else None


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("k", [5, 7])
def test_kxk_op_matches_the_reference(k, with_sparse):
    guid, blur, sparse = op_problem(k, with_sparse)
    grad = torch.randn((B, 23, 31), generator=torch.Generator().manual_seed(9))
    ins = [t.clone().requires_grad_() for t in (guid, blur)]
    sp = None if sparse is None else sparse.clone().requires_grad_()
    before = cspn_cuda.cspn_kxk_bwd.launches
    out = cspn_propagate(ins[0], ins[1], sp, num_iters=6,
                         norm_type="8sum_clamp", guidance_layout="NCHW")
    out.backward(grad)
    assert cspn_cuda.cspn_kxk_bwd.launches == before   # the CPU: plain
    refs = [t.clone().requires_grad_() for t in (guid, blur)]
    ref_sp = (torch.zeros_like(blur) if sparse is None
              else sparse.clone()).requires_grad_()
    (want,) = cspnpp.propagate(refs[0], refs[1], ref_sp, k, 6, (6,))
    want.backward(grad)
    assert max_rel(out, want) <= OP_TOL
    assert max_rel(ins[0].grad, refs[0].grad) <= OP_GRAD_TOL
    assert max_rel(ins[1].grad, refs[1].grad) <= OP_GRAD_TOL
    if sparse is not None:
        assert max_rel(sp.grad, ref_sp.grad) <= OP_GRAD_TOL


def test_kernel_size_must_match_the_guidance():
    """k is read from the guidance's planes: a count that no kernel size
    takes (k^2 - 1 for k in 3, 5, 7) raises."""
    guid, blur, sparse = op_problem(5, True)
    with pytest.raises(ValueError, match="guidance with 10 planes"):
        cspn_propagate(guid[:, :10], blur, sparse, num_iters=2,
                       norm_type="8sum", guidance_layout="NCHW")


# ------------------------------------------------------------ the model

def tiny_conf() -> dict:
    """A CSPN++ configuration at synthetic_tiny's widths, as a benchmark
    configuration file states one."""
    return {"name": "tiny_cspnpp",
            "model": {"arch": "", "in_channels": 4, "stages": [1, 1, 1, 1],
                      "encoder_block": "basic", "width": 16,
                      "decoder_channels": [32, 24, 16, 16],
                      "decoder_out": 16, "num_iters": 4,
                      "kernel_sizes": list(SIZES), "checkpoints": list(MARKS)},
            "data": {"height": H, "width": W, "num_samples": 50,
                     "max_depth": 10.0},
            "train": {"optimizer": "sgd", "lr": 0.01, "momentum": 0.9,
                      "weight_decay": 0.0001, "clip_norm": 1.0,
                      "loss": "masked_mse"}}


def tiny_cfg(**over):
    return get_config("synthetic_tiny").override(**{
        "model.encoder_block": "basic", "model.cspn_kernel_sizes": SIZES,
        "model.cspn_checkpoints": MARKS, "data.height": H, "data.width": W,
        "train.batch_size": B, "model.dtype": "float32", **over})


def seeded(seed=5):
    conf = tiny_conf()
    return conf, make_weights(cspnpp.shapes(cspnpp.Spec.from_config(conf)),
                              seed, "cpu")


def inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((B, H, W, 4), generator=g)
    x[..., 3] = torch.where(torch.rand((B, H, W), generator=g) < 0.03,
                            0.5 + 9 * torch.rand((B, H, W), generator=g),
                            torch.zeros(()))
    return x


def test_model_forward_matches_the_reference():
    conf, weights = seeded()
    model = CSPNDepthNet.from_config(tiny_cfg().model)
    assert model.head.out_channels == 1 + 8 + 24 + 48 + 3 + 6
    harness.load_weights(model, weights)
    x = inputs()
    got = model(x)[..., 0]
    spec = cspnpp.Spec.from_config(conf)
    want = cspnpp.forward(weights, x, spec, train=True, precision=F32)
    assert max_rel(got, want) <= MODEL_TOL
    # The benchmark's control, a bf16 head, CSPN and mix, misses it.
    low = ref_model.Precision("bfloat16", "bfloat16", "bfloat16")
    assert max_rel(cspnpp.forward(weights, x, spec, train=True, precision=low),
                   want) > 100 * MODEL_TOL


def test_train_step_matches_the_reference():
    conf, weights = seeded()
    trainer = Trainer(tiny_cfg(), device="cpu")
    state = trainer.init_state()
    harness.load_weights(state.model, weights)
    g = torch.Generator().manual_seed(1)
    rgb = torch.rand((B, H, W, 3), generator=g)
    depth = torch.where(torch.rand((B, H, W), generator=g) < 0.5,
                        0.5 + 9 * torch.rand((B, H, W), generator=g),
                        torch.zeros(()))
    params = dict(state.model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    _, loss, _ = trainer.train_step(state, {"rgb": rgb, "depth": depth})
    wd = conf["train"]["weight_decay"]
    opt = state.optimizer
    got = leaf_norms({k: opt.state[p]["momentum_buffer"] - wd * start[k]
                      for k, p in params.items()})
    want = cspnpp.train_steps(weights, [(rgb, depth)], conf,
                              tiny_cfg().train.seed, F32)
    assert abs(float(loss) / want["losses"][0] - 1) <= MODEL_TOL
    assert set(got) == set(want["first_grad"])
    scale = max(want["first_grad"].values())
    worst = max(abs(got[k] - v) / max(v, 1e-3 * scale)
                for k, v in want["first_grad"].items())
    assert worst <= STEP_TOL
    # The CA-CSPN's own leaf, the head, carries a gradient.
    assert got["head.weight"] > 0


# ------------------------------------------------------------ defaults

def test_defaults_are_the_plain_cspn():
    """A default model is today's: its tensors, and its output bit for bit
    equal to the 9-channel head and one 3x3 CSPN call."""
    cfg = get_config("synthetic_tiny")
    assert cspnpp_plan(cfg.model.cspn_kernel_sizes,
                       cfg.model.cspn_checkpoints, 4) is None
    model = CSPNDepthNet.from_config(cfg.model)
    assert model.cspnpp is None and model.head.out_channels == 9
    with torch.no_grad():
        model.head.weight.normal_(0, 0.05,
                                  generator=torch.Generator().manual_seed(2))
        model.head.bias.fill_(0.5)
    named = CSPNDepthNet.from_config(get_config("nyu_completion_500").model)
    assert [k for k in named.state_dict() if k.startswith("head")] == [
        "head.weight", "head.bias"]
    assert tuple(named.head.weight.shape) == (9, 64, 3, 3)
    x = inputs()
    with torch.no_grad():
        got = model(x)
        xc = x.permute(0, 3, 1, 2).float().contiguous()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            feat = model.decoder(model.encoder(xc), (H, W))
        heads = model.head(feat.float())
        want = cspn_propagate(heads[:, 1:], heads[:, 0], xc[:, 3],
                              num_iters=4, norm_type="8sum_clamp",
                              guidance_layout="NCHW")[..., None]
    assert torch.equal(got, want)


@pytest.mark.parametrize("sizes,marks,match", [
    ((3, 4), (4,), "cspn_kernel_sizes"),
    ((5, 3), (4,), "cspn_kernel_sizes"),
    ((3, 9), (4,), "cspn_kernel_sizes"),
    ((3, 5), (2, 3), "cspn_checkpoints"),
    ((3, 5), (2, 2, 4), "cspn_checkpoints"),
    ((3, 5), (0, 4), "cspn_checkpoints"),
])
def test_bad_plans_raise(sizes, marks, match):
    with pytest.raises(ValueError, match=match):
        CSPNDepthNet.from_config(tiny_cfg(**{
            "model.cspn_kernel_sizes": sizes,
            "model.cspn_checkpoints": marks}).model)


def test_named_config_is_resnet34_cspnpp():
    cfg = get_config("kitti_1216_cspnpp")
    model = CSPNDepthNet.from_config(cfg.model)
    assert model.head.out_channels == 96
    assert type(model.encoder.layer3_block5).__name__ == "BasicBlock"
    assert (cfg.data.height, cfg.data.width, cfg.train.batch_size) == (
        352, 1216, 8)
    assert (cfg.mesh.data, cfg.mesh.spatial) == (1, 1)


# ------------------------------------------------------------ entries

def test_predictor_serves_a_cspnpp_model():
    conf, weights = seeded()
    model = CSPNDepthNet.from_config(tiny_cfg().model)
    harness.load_weights(model, weights)
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    sparse = np.where(rng.random((B, H, W)) < 0.02,
                      rng.uniform(0.5, 9.5, (B, H, W)), 0.0).astype(np.float32)
    got = DepthPredictor(model, H, W, "cpu").predict_batch(rgb, sparse)
    x = torch.cat([torch.from_numpy(rgb.astype(np.float32) / 255.0),
                   torch.from_numpy(sparse)[..., None]], -1)
    want = cspnpp.forward(weights, x, cspnpp.Spec.from_config(conf),
                          train=False, precision=F32)
    assert got.shape == (B, H, W) and np.isfinite(got).all()
    assert max_rel(torch.from_numpy(got), want) <= MODEL_TOL
    m = sparse > 0
    np.testing.assert_allclose(got[m], sparse[m], rtol=1e-6)


def test_spans_and_counter_under_a_profiler():
    trainer = Trainer(tiny_cfg(), device="cpu")
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.random((B, H, W, 3), np.float32),
             "depth": rng.uniform(0.5, 9.5, (B, H, W)).astype(np.float32)}
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(state, batch)
    got = profiling.collected()
    parents = {}
    for s in got["spans"]:
        parents.setdefault(s["name"], []).append(s["parent"])
    assert parents["cspnpp.forward"] == ["train.forward"]
    assert parents["cspnpp.mix"] == ["cspnpp.forward"]
    assert parents["cspn.forward"] == ["cspnpp.forward"] * 6
    assert len(parents["cspn.backward"]) == 6
    # One a k x k forward: 2 sizes x 2 segments.
    assert got["counters"] == {"cspn.kxk_calls": 4}
    # The plain CSPN takes no k x k route.
    plain = Trainer(tiny_cfg(**{"model.cspn_kernel_sizes": (3,),
                                "model.cspn_checkpoints": ()}), device="cpu")
    plain_state = plain.init_state()
    with profile(activities=[ProfilerActivity.CPU]):
        plain.train_step(plain_state, batch)
    got = profiling.collected()
    assert {s["name"] for s in got["spans"]} >= {"cspn.forward"}
    assert "cspn.kxk_calls" not in got["counters"]


def test_spatial_mesh_and_export_raise(tmp_path):
    with pytest.raises(ValueError, match="spatial mesh"):
        CSPNDepthNet.from_config(tiny_cfg().model, mesh=SimpleNamespace(
            spatial=2, world_group=None))
    model = CSPNDepthNet.from_config(tiny_cfg().model)
    predictor = DepthPredictor(model, H, W, "cpu")
    with pytest.raises(NotImplementedError, match="cannot be exported"):
        predictor.export_program(str(tmp_path / "p.pt2"))


def test_device_profile_skips_span_annotations():
    """utils/profiling.py:event_times on a fake profile: a span's copy on
    the device's timeline (a user annotation) is not device work."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def avg(key, dev, ms):
        return SimpleNamespace(key=key, device_type=dev,
                               self_device_time_total=ms * 1e3,
                               self_cpu_time_total=ms * 1e3)

    averages = [avg("cspn_kxk_step", cuda, 2.0), avg("serve.forward", cuda,
                                                     9.0),
                avg("aten::conv2d", cpu, 5.0), avg("gemm", cuda, 1.0)]
    events = [SimpleNamespace(name="serve.forward", is_user_annotation=True),
              SimpleNamespace(name="gemm", is_user_annotation=False)]
    assert profiling.event_times(averages, events, cuda=True) == [
        ("cspn_kxk_step", 2.0), ("gemm", 1.0)]
    assert profiling.event_times(averages, events, cuda=False) == [
        ("aten::conv2d", 5.0)]
