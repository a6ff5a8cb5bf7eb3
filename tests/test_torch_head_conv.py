"""The 3 x 3 CSPN's head conv (ops/head_conv.py) on the CPU, where its
wrappers run their plain versions.

* `head_conv` of a head of at most 16 planes runs `HeadConvFunction` (with
  a gradient) or the registered operator `head_conv3x3` (without): its
  output and the gradients of x, the weight and the bias against
  F.conv2d of the f32 map under torch autograd, f32 and bf16 x, H padded
  by 1 and by 0 (the rows layout's window); a head of more planes is
  cuDNN's float32 conv path, F.conv2d of the f32 map.
* The operator: opcheck (schema, fake, autograd registration) and its fake
  shape at both paddings.
* The model: one `head.conv_calls` and spans `head.forward` /
  `head.backward` a train step of a 9-plane model, none for
  kitti_1216_cspnpp's 96-plane head (the bypass); an exported serving
  program holds one `head_conv3x3` node.
* The rows layout's head (parallel/rows.py `conv2d_rows` with the model's
  window op) on a 2-rank spatial group of gloo ranks against the whole
  image's head, forward and every gradient, as tests/test_torch_rows.py
  checks the other convs.

The card's kernels are held to F.conv2d in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from cspn_monodepth_tpu_torch import CSPNDepthNet, DepthPredictor, get_config
from cspn_monodepth_tpu_torch.configs import MeshConfig
from cspn_monodepth_tpu_torch.models.cspn_net import Head, _head_window
from cspn_monodepth_tpu_torch.ops import head_conv as hc
from cspn_monodepth_tpu_torch.parallel import make_mesh, spawn_ranks
from cspn_monodepth_tpu_torch.parallel.rows import Rows, conv2d_rows, \
    row_range
from cspn_monodepth_tpu_torch.train import Trainer
from cspn_monodepth_tpu_torch.utils import profiling

OPS = torch.ops.cspn_monodepth_tpu_torch
TOL = 1e-6
SPATIAL = 2
DEADLINE_S = 300


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def head_problem(seed, cout, cin=16, b=2, h=11, w=13, pad_h=1,
                 dtype=torch.float32):
    """A Head with N(0, 1) parameters, x (B, Cin, H, W) in `dtype` and the
    cotangent of the output."""
    rng = np.random.default_rng(seed)
    head = Head(cin, cout, 3, padding=1, bias=True)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w))
                         .astype(np.float32)).to(dtype)
    cot = torch.from_numpy(rng.standard_normal(
        (b, cout, h + 2 * pad_h - 2, w)).astype(np.float32))
    return head, x, cot


def grads(fn, head, x, cot):
    """fn(x)'s value and the gradients of x, the weight and the bias."""
    x = x.clone().requires_grad_()
    head.zero_grad()
    y = fn(x)
    (y * cot).sum().backward()
    return y.detach(), x.grad, head.weight.grad.clone(), \
        head.bias.grad.clone()


def max_rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("cout", [9, 12, 96])
@pytest.mark.parametrize("pad_h", [1, 0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_head_conv_matches_conv2d_of_the_f32_map(cout, pad_h, dtype):
    head, x, cot = head_problem(cout + pad_h, cout, pad_h=pad_h,
                                dtype=dtype)
    got = grads(lambda t: head(t, pad_h=pad_h), head, x, cot)
    want = grads(lambda t: F.conv2d(t.float(), head.weight, head.bias,
                                    padding=(pad_h, 1)), head, x, cot)
    assert got[0].dtype == torch.float32
    assert got[1].dtype == dtype
    for g, r in zip(got, want):
        assert g.shape == r.shape
        assert max_rel(g, r) <= TOL


def test_the_hand_path_runs_the_function_or_the_operator(monkeypatch):
    """With a gradient the autograd Function, without one the operator (the
    plain forward, the operator's CPU body); a head of more than MAX_OUT
    planes neither."""
    calls = []
    real = hc.head_conv3x3_fwd_plain
    monkeypatch.setattr(hc, "head_conv3x3_fwd_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    head, x, _ = head_problem(0, 9)
    assert type(head(x).grad_fn).__name__ == "HeadConvFunctionBackward"
    monkeypatch.setattr(hc.HeadConvFunction, "apply", None)
    with torch.no_grad():
        assert head(x).grad_fn is None
    assert len(calls) == 2
    wide, x, _ = head_problem(0, hc.MAX_OUT + 1)
    assert type(wide(x).grad_fn).__name__ == "ConvolutionBackward0"
    assert len(calls) == 2


def test_a_head_that_is_not_3x3_stride_1_is_refused():
    conv = Head(4, 9, 3, stride=2, padding=1)
    with pytest.raises(ValueError, match="3x3, stride 1"):
        conv(torch.zeros(1, 4, 8, 8))


def test_the_wrappers_take_no_other_device():
    x = torch.empty((1, 4, 8, 8), device="meta")
    w = torch.empty((9, 4, 3, 3), device="meta")
    with pytest.raises(ValueError, match="no head conv kernel"):
        hc.head_conv3x3_fwd(x, w, torch.empty(9, device="meta"), pad_h=1)


@pytest.mark.parametrize("pad_h", [1, 0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_opcheck_head_conv3x3(pad_h, dtype):
    head, x, _ = head_problem(7, 9, pad_h=pad_h, dtype=dtype)
    args = (x, head.weight.detach(), head.bias.detach(), pad_h)
    torch.library.opcheck(OPS.head_conv3x3.default, args)
    out = OPS.head_conv3x3(*args)
    torch.testing.assert_close(out, F.conv2d(
        x.float(), args[1], args[2], padding=(pad_h, 1)), rtol=0, atol=0)


@pytest.mark.parametrize("pad_h", [1, 0])
def test_the_fake_gives_the_output_shape(pad_h):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty((2, 64, 20, 30), dtype=torch.bfloat16)
        out = OPS.head_conv3x3(x, torch.empty((9, 64, 3, 3)),
                               torch.empty(9), pad_h)
    assert tuple(out.shape) == (2, 9, 20 + 2 * pad_h - 2, 30)
    assert out.dtype == torch.float32


def tiny_train_batch(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.random((b, h, w, 3), np.float32),
            "depth": rng.uniform(0.5, 9.5, (b, h, w)).astype(np.float32)}


def test_one_count_and_both_spans_a_train_step_of_a_9_plane_model():
    cfg = get_config("synthetic_tiny")
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    batch = tiny_train_batch(2, cfg.data.height, cfg.data.width)
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(state, batch)
    got = profiling.collected()
    assert got["counters"]["head.conv_calls"] == 1
    parents = {}
    for s in got["spans"]:
        parents.setdefault(s["name"], []).append(s["parent"])
    assert parents["head.forward"] == ["train.forward"]
    assert parents["head.backward"] == ["train.backward"]


def test_the_96_plane_head_of_kitti_1216_cspnpp_is_bypassed():
    """CSPN++'s head takes cuDNN's float32 path: no count, no span, and its
    output is F.conv2d of the f32 map."""
    model = CSPNDepthNet.from_config(get_config("kitti_1216_cspnpp").model)
    assert model.head.out_channels == 96 > hc.MAX_OUT
    x = torch.rand(1, 32, 64, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            model(x)
    got = profiling.collected()
    assert "head.conv_calls" not in got["counters"]
    assert not {"head.forward", "head.backward"} & {
        s["name"] for s in got["spans"]}
    feat = torch.randn(1, 64, 6, 7, dtype=torch.bfloat16)
    torch.testing.assert_close(
        model.head(feat), F.conv2d(feat.float(), model.head.weight,
                                   model.head.bias, padding=1),
        rtol=0, atol=0)


def test_an_exported_program_holds_one_head_node(tmp_path):
    """One head_conv3x3 node (in the graph of the model's autocast-off
    region, where the head runs) beside the one K1 node, and no other
    convolution with 9 outputs."""
    cfg = get_config("synthetic_tiny")
    torch.manual_seed(0)
    predictor = DepthPredictor(CSPNDepthNet.from_config(cfg.model),
                               cfg.data.height, cfg.data.width, "cpu")
    program = predictor.export_program(str(tmp_path / "p.pt2"), batch=1)
    nodes = [n for m in program.graph_module.modules()
             if isinstance(getattr(m, "graph", None), torch.fx.Graph)
             for n in m.graph.nodes if n.op == "call_function"]
    heads = [n for n in nodes if n.target == OPS.head_conv3x3.default]
    assert len(heads) == 1
    assert [n.target for n in nodes].count(OPS.cspn_fwd.default) == 1
    assert heads[0].args[3] == 1
    assert tuple(heads[0].meta["val"].shape) == (
        1, 9, cfg.data.height, cfg.data.width)
    assert not [n for n in nodes if n.target == torch.ops.aten.conv2d.default
                and n.meta["val"].shape[1] == 9]


# The rows layout: a level of H rows split over SPATIAL ranks.
ROWS_CASES = [(11, torch.float32), (16, torch.float32)]


def rows_problem(h):
    head, x, cot = head_problem(100 + h, 9, cin=8, b=2, h=h, w=10)
    return head, x, cot


def _rank_rows(rank):
    mesh = make_mesh(MeshConfig(data=1, spatial=SPATIAL), device="cpu")
    out = {}
    for h, _ in ROWS_CASES:
        head, x, cot = rows_problem(h)
        rows = Rows(mesh, h)
        lo, hi = rows.range
        mine = x[..., lo:hi, :].clone().requires_grad_()
        y = conv2d_rows(mine, head, rows, window_op=_head_window)
        (y * cot[..., slice(*row_range(h, SPATIAL, mesh.s)), :]).sum() \
            .backward()
        out[h] = dict(y=y.detach().numpy(), dx=mine.grad.numpy(),
                      dw=head.weight.grad.numpy(), db=head.bias.grad.numpy())
    return out


@pytest.fixture(scope="module")
def rows_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("head_rows")
    return spawn_ranks(_rank_rows, SPATIAL, timeout=DEADLINE_S,
                       init_file=str(work / "rendezvous"))


@pytest.mark.parametrize("h", [h for h, _ in ROWS_CASES])
def test_the_rows_head_matches_the_whole_image_head(rows_ranks, h):
    head, x, cot = rows_problem(h)
    y, dx, dw, db = grads(head, head, x, cot)
    got = [r[h] for r in rows_ranks]
    assert max_rel(torch.from_numpy(np.concatenate(
        [g["y"] for g in got], axis=-2)), y) <= TOL
    assert max_rel(torch.from_numpy(np.concatenate(
        [g["dx"] for g in got], axis=-2)), dx) <= TOL
    assert max_rel(torch.from_numpy(sum(g["dw"] for g in got)), dw) <= TOL
    assert max_rel(torch.from_numpy(sum(g["db"] for g in got)), db) <= TOL
