"""Train-mode BatchNorm (ops/batch_norm.py) on the CPU: the plain version
through `BatchNormTrainFunction`, which models/resnet.py:BatchNorm2d runs in
train mode on the card, against the module's own path on the CPU, torch's
`F.batch_norm` on a copy of `running_var` whose unbiased update is folded
back to flax's biased one; the launch plan; the counter `bn.train_calls`;
which path the module takes.

Shapes: synthetic_tiny's BatchNorm sites, and small analogues of the
cells': 64 channels at a large H x W (the decoder's full-resolution
block), 2048 at a small one (layer4), each also as the cropped view with
rows further apart than W that models/unet.py:_up_convs hands over.

Tolerances (max |a - b| / max |b|): float32 outputs and running
statistics 1e-5 (f32 arithmetic in another order); bfloat16 outputs 2**-7,
one bf16 rounding step (both sides compute in f32 and round once, so a
value near a rounding boundary may land one step apart). dweight and dbias
are sums over N H W: 1e-5 of the sum of the terms' magnitudes in f32; in
bf16 11 * 2**-8 of it, since the plain version sums as ATen's CUDA kernel
does (`aten_sums`), where ATen's CPU kernel sums in float32: each product
dy (x - mean) and each of the 10 steps of the block's reduction tree
rounds to bf16, and a rounding moves its operand by at most 2**-8 of
itself. For a bf16
cropped view the module is given a contiguous copy of the same values:
ATen's CPU backward of a non-contiguous bf16 input sums dbias in bf16
(0.087 off on 836 values of magnitude 1).
"""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from cspn_monodepth_tpu_torch import get_config
from cspn_monodepth_tpu_torch.models import CSPNDepthNet, resnet
from cspn_monodepth_tpu_torch.models.resnet import BatchNorm2d, batch_norm
from cspn_monodepth_tpu_torch.ops import batch_norm as bn
from cspn_monodepth_tpu_torch.utils import profiling

MOMENTUM, EPS = 0.1, 1e-5
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
STAT_TOL = 1e-5
SUM_TOL = {torch.float32: 1e-5, torch.bfloat16: 11 * 2.0 ** -8}


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def module_path(x, weight, bias, running_mean, running_var):
    """BatchNorm2d's train-mode forward on the CPU with these parameters
    and statistics: (y, the module)."""
    m = batch_norm(x.shape[1])
    with torch.no_grad():
        for t, v in ((m.weight, weight), (m.bias, bias),
                     (m.running_mean, running_mean),
                     (m.running_var, running_var)):
            t.copy_(v)
    return m(x), m


def batch_norm_sites(name: str, batch: int) -> list:
    """(shape, strides) of every train-mode BatchNorm input of config
    `name`'s network at its data size, in call order (the network on the
    meta device, so no memory and no arithmetic)."""
    cfg = get_config(name)
    with torch.device("meta"):
        model = CSPNDepthNet.from_config(cfg.model)
    model.eval()
    sites = []
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(
                lambda _, args: sites.append((tuple(args[0].shape),
                                              args[0].stride())))
    h, w = cfg.data.height, cfg.data.width
    x = torch.empty((batch, 4 if cfg.model.modality == "rgbd" else 3, h, w),
                    device="meta")
    with torch.no_grad():
        model.decoder(model.encoder(x), (h, w))
    return sites


# Three of synthetic_tiny's sites at batch 2 (its full-resolution decoder
# block, a /8 stage, layer4), and small analogues of the cells' extremes:
# 64 channels at a large plane (the decoder's last block), 2048 at a small
# one (layer4).
TINY_SITES = [(2, 16, 64, 96), (2, 64, 8, 12), (2, 512, 2, 3)]
CELL_LIKE = [(2, 64, 48, 160), (2, 2048, 3, 5)]
SHAPES = TINY_SITES + CELL_LIKE
DTYPES = [torch.float32, torch.bfloat16]


def make_input(shape, dtype, cropped: bool, seed: int):
    """x of `shape`: contiguous, or the top-left of a map one row and one
    column larger (rows W + 1 apart), as _up_convs crops."""
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    grow = int(cropped)
    full = torch.randn((n, c, h + grow, w + grow), generator=g) * 3 + 1.5
    return full.to(dtype)[:, :, :h, :w]


def params(c, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(c, generator=g), torch.randn(c, generator=g),
            torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.5)


def max_rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def sum_err(got, want, terms) -> float:
    """max |got - want| over channels, as a share of the channel's sum of
    |terms| (the f32 summation's own scale)."""
    scale = terms.double().abs().sum((0, 2, 3))
    return float(((got.double() - want.double()).abs() / scale).max())


@pytest.mark.parametrize("cropped", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_function_matches_the_modules_cpu_path(shape, dtype, cropped):
    """y, dx, dweight and dbias of each of three steps, and the running
    statistics after the first and the third."""
    c = shape[1]
    w0, b0, rm0, rv0 = params(c, 1)
    ours = [w0.clone().requires_grad_(), b0.clone().requires_grad_(),
            rm0.clone(), rv0.clone()]
    ref = None
    tol = TOL[dtype]
    for step in range(3):
        x = make_input(shape, dtype, cropped, 10 + step)
        dy = torch.randn(shape, generator=torch.Generator().manual_seed(
            20 + step)).to(dtype)
        xa = x.detach().requires_grad_()
        xb = (x.contiguous() if cropped and dtype == torch.bfloat16
              else x).detach().requires_grad_()
        ours[0].grad = ours[1].grad = None
        y = bn.batch_norm_train(xa, *ours, momentum=MOMENTUM, eps=EPS)
        if ref is None:
            want, ref = module_path(xb, w0, b0, rm0, rv0)
        else:
            ref.zero_grad()
            want = ref(xb)
        assert y.dtype == dtype and y.shape == shape
        assert max_rel(y.detach(), want.detach()) <= tol
        y.backward(dy)
        want.backward(dy)
        assert max_rel(xa.grad, xb.grad) <= tol
        xhat = (xb.detach().double() - xb.detach().double().mean(
            (0, 2, 3))[:, None, None])
        assert sum_err(ours[1].grad, ref.bias.grad, dy) <= SUM_TOL[dtype]
        assert sum_err(ours[0].grad, ref.weight.grad,
                       dy.double() * xhat
                       / xhat.square().mean((0, 2, 3)).sqrt()[:, None, None]
                       ) <= SUM_TOL[dtype]
        if step in (0, 2):
            assert max_rel(ours[2], ref.running_mean) <= STAT_TOL
            assert max_rel(ours[3], ref.running_var) <= STAT_TOL


def test_the_tiny_sites_are_synthetic_tinys():
    sites = batch_norm_sites("synthetic_tiny", 2)
    assert len(sites) == 33
    assert set(TINY_SITES) <= {shape for shape, _ in sites}


def test_backward_is_the_forwards_gradient():
    """gradcheck of the plain forward and backward in float64."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((3, 4, 5, 6), generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(4, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(4, generator=g, dtype=torch.float64, requires_grad=True)
    stats = torch.zeros(4, dtype=torch.float64), torch.ones(
        4, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda x, w, b: bn.batch_norm_train(x, w, b, *stats,
                                            momentum=MOMENTUM, eps=EPS),
        (x, w, b))


def test_running_statistics_take_the_biased_variance():
    x = make_input((2, 3, 4, 5), torch.float32, False, 4)
    rm, rv = torch.zeros(3), torch.ones(3)
    bn.batch_norm_train(x, torch.ones(3), torch.zeros(3), rm, rv,
                        momentum=MOMENTUM, eps=EPS)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(rm, MOMENTUM * mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(rv, (1 - MOMENTUM) + MOMENTUM * var,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("c, per_channel, want", [
    (64, 8 * 352 * 1216, 16),     # the decoder's last block at KITTI
    (64, 32 * 228 * 304, 16),     # and at NYU's batch 32
    (256, 8 * 88 * 304, 4),       # layer1 at KITTI
    (512, 8 * 22 * 76, 1),        # a slice would read under SLICE_MIN
    (2048, 8 * 11 * 38, 1),       # layer4: the channels fill the card
    (3, 100, 1),
])
def test_slices_come_from_the_shape(c, per_channel, want):
    assert bn.slices(c, per_channel) == want


@pytest.mark.parametrize("case, want", [
    ("contiguous_bf16", (True, 8)),
    ("contiguous_f32", (True, 4)),
    ("rows_w_apart", (True, 4)),      # a cropped height: planes merge
    ("rows_wider", (False, 1)),       # a cropped width of 19
    ("rows_wider_even", (False, 4)),  # width 24 in rows of 32
    ("one_row", (True, 2)),
    ("offset", (False, 2)),           # a base 4 bytes off 16
])
def test_plan_takes_the_widest_aligned_load(case, want):
    def tensors():
        if case == "contiguous_bf16":
            return torch.empty((2, 3, 8, 16), dtype=torch.bfloat16)
        if case == "contiguous_f32":
            return torch.empty((2, 3, 8, 16))
        if case == "rows_w_apart":
            return torch.empty((2, 3, 58, 76),
                               dtype=torch.bfloat16)[:, :, :57]
        if case == "rows_wider":
            return torch.empty((2, 3, 16, 20),
                               dtype=torch.bfloat16)[:, :, :15, :19]
        if case == "rows_wider_even":
            return torch.empty((2, 3, 9, 32))[:, :, :7, :24]
        if case == "one_row":
            return torch.empty((2, 3, 1, 50), dtype=torch.bfloat16)
        return torch.empty((2, 3, 5, 14), dtype=torch.bfloat16)[..., 2:]

    x = tensors()
    y = torch.empty(x.shape, dtype=x.dtype)
    base = x.data_ptr() - x.storage_offset() * x.element_size()
    assert base % 16 == 0
    assert bn.plan((x, y), tuple(x.shape)) == want


def test_the_wrapper_takes_no_other_device():
    x = torch.empty((2, 3, 4, 5), device="meta")
    c = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="no BatchNorm kernel"):
        bn.batch_norm_train_fwd(x, c, c, c, c, momentum=MOMENTUM, eps=EPS)


def counted(fn) -> dict:
    """The counters of fn() under a profiler, but the counter "stretch" that
    opens a fresh collection."""
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("stretch", 1)
        fn()
    got = profiling.collected()["counters"]
    assert got.pop("stretch") == 1
    return got


def test_each_call_counts_once():
    w, b, rm, rv = params(4, 2)
    x = torch.randn((2, 4, 3, 5))
    assert counted(lambda: [bn.batch_norm_train(
        x, w, b, rm, rv, momentum=MOMENTUM, eps=EPS) for _ in range(2)]) \
        == {"bn.train_calls": 2}


def test_the_module_takes_the_kernels_on_the_card_only(monkeypatch):
    """Train mode off the CPU calls batch_norm_train (here on a meta
    tensor, with a stand-in); on the CPU and in eval mode the module keeps
    torch's path and counts nothing."""
    got = []
    monkeypatch.setattr(resnet, "batch_norm_train",
                        lambda *a, **kw: got.append((a, kw)) or a[0])
    m = batch_norm(4)
    x = torch.empty((2, 4, 3, 5), device="meta")
    assert m(x) is x
    assert len(got) == 1 and got[0][1] == {"momentum": MOMENTUM, "eps": EPS}
    assert got[0][0][1:] == (m.weight, m.bias, m.running_mean,
                             m.running_var)
    cpu = torch.randn((2, 4, 3, 5))
    assert counted(lambda: m(cpu)) == {}
    m.eval()
    assert counted(lambda: m(cpu)) == {}
    assert len(got) == 1


def test_the_group_path_neither_counts_nor_takes_the_kernels(monkeypatch):
    """A module with a process group takes the global statistics' path
    (here over a group of one: the all-reduce is the identity)."""
    monkeypatch.setattr(resnet, "all_reduce", lambda t, group: t)
    m = batch_norm(4)
    m.group = object()
    x = torch.randn((2, 4, 3, 5))
    before = bn.batch_norm_train_fwd.launches
    got = {}
    assert counted(lambda: got.setdefault("y", m(x))) == {}
    w, b, rm, rv = (m.weight, m.bias, torch.zeros(4), torch.ones(4))
    torch.testing.assert_close(got["y"], bn.batch_norm_train(
        x, w, b, rm, rv, momentum=MOMENTUM, eps=EPS), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m.running_var, rv, rtol=1e-5, atol=1e-6)
    assert bn.batch_norm_train_fwd.launches == before


@pytest.mark.parametrize("case", ["dtype", "shape", "rows", "vector"])
def test_the_checks_name_what_the_kernels_do_not_take(case):
    """The wrapper's checks of a card's call, run on meta tensors (the
    device check needs a card: tests/test_torch_cuda.py)."""
    x = torch.empty((2, 3, 4, 5), device="meta")
    maps = {"x": x, "dy": torch.empty((2, 3, 4, 5), device="meta")}
    vectors = {"weight": torch.empty(3, device="meta")}
    bad = {"dtype": ("dy", maps["dy"].to(torch.bfloat16), "dy is"),
           "shape": ("weight", torch.empty(4, device="meta"), "weight is"),
           "rows": ("dy", torch.empty((2, 3, 5, 4), device="meta")
                    .transpose(2, 3), "rows must be contiguous"),
           "vector": ("weight", torch.empty(6, device="meta")[::2],
                      "must be contiguous")}[case]
    bn._check(x, maps, vectors)
    (maps if bad[0] in maps else vectors)[bad[0]] = bad[1]
    with pytest.raises(ValueError, match=bad[2]):
        bn._check(x, maps, vectors)


def aten_reduce_loops(terms: torch.Tensor, dtype) -> list:
    """ATen's batch_norm_backward_kernel reduction written out thread by
    thread: virtual thread (tx, ty) of a bdx x 512 / bdx block sums the
    elements at hw = tx (mod bdx) of the images n = ty (mod 512 / bdx);
    then WarpReduce over each warp and over the warps' sums, each step
    adding lane l + off's value rounded to `dtype` to lane l's."""
    n, c, h, w = terms.shape
    hw = h * w
    bdx = bn.aten_threads(hw)
    bdy = 512 // bdx
    t = terms.double().reshape(n, c, hw)

    def rounded(v):
        return float(torch.tensor(v).to(dtype).float())

    def warp(vals):
        vals = list(vals)
        for off in (16, 8, 4, 2, 1):
            vals = [vals[i] + rounded(vals[i + off]) if i < off else vals[i]
                    for i in range(32)]
            vals = [float(torch.tensor(v).float()) for v in vals]
        return vals[0]

    out = []
    for ch in range(c):
        threads = []
        for tid in range(512):
            tx, ty = tid % bdx, tid // bdx
            s = sum(float(t[b, ch, x]) for b in range(ty, n, bdy)
                    for x in range(tx, hw, bdx))
            threads.append(float(torch.tensor(s).float()))
        sums = [warp(threads[32 * k:32 * k + 32]) for k in range(16)]
        out.append(warp(sums + [0.0] * 16))
    return out


@pytest.mark.parametrize("shape", [(3, 2, 4, 10), (5, 2, 20, 30)],
                         ids=["bdx64", "bdx512"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_aten_sums_is_atens_reduction(shape, dtype):
    terms = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    got = bn.aten_sums(terms.to(dtype).float(), dtype)
    want = aten_reduce_loops(terms.to(dtype).float(), dtype)
    assert got.tolist() == pytest.approx(want, rel=1e-6, abs=1e-6)
