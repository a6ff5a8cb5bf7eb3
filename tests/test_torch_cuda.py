"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU (the hand-written kernel has no CPU mode)
and skip without one. They import no JAX, so they also run on a machine
that has PyTorch and CUDA only; there, run them without the JAX-side
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: max-relative error max|a - b| / max|b| <= 1e-5 for each kernel
(K1 forward, K2 stash forward, K3 adjoint, at every size: at JAX's
H-tiled cases too, where the kernel table calls them K4-K6; K7-K9, the
prenormalized
gates9 contract on the spatial path's halo'd slabs, d^0 as given or
anchored on load; the normalization's pair cspn_gates9 / cspn_gates9_bwd;
the adjoints' stage kernels against their plain stages) and each output;
two runs of K3 and K9 agree bit for bit, and so do the forward
kernels under every tile geometry of their launch plan
(ops/cspn_cuda.py:fwd_plan). The
kernels contract to FMA and sum in their own order; random signed gates
are expansive (T=24 outputs reach ~1e9), so an absolute tolerance is
meaningless and `8sum_abs` is the absolute-scale control. Gradients
through the autograd Function against torch autograd of the plain loop:
<= 1e-4, the reverse-mode sums of two different programs. The head conv's
kernels (ops/head_conv.py) against F.conv2d in float64: HEAD_TOL, dx in
bf16 within one bf16 ulp (see HEAD_TOL's note); two runs bit for bit.
"""

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu_torch import DepthPredictor, get_config
from cspn_monodepth_tpu_torch.models import CSPNDepthNet
from cspn_monodepth_tpu_torch.ops import cspn_cuda, cspn_propagate
from cspn_monodepth_tpu_torch.ops.cspn_ref import anchor, prenorm_gates9

TOL = 1e-5
GRAD_TOL = 1e-4
# A small f32 network on the card vs the CPU with TF32 off: convolutions
# sum in another order, then T=4 CSPN iterations.
MODEL_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def max_rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def problem(seed, b, h, w, with_sparse=True):
    """Plane-major guidance (B, 8, H, W) N(0, 1), blur U(0.1, 10) and ~5%
    anchors, on the CPU."""
    rng = np.random.default_rng(seed)
    guid = rng.standard_normal((b, 8, h, w)).astype(np.float32)
    blur = rng.uniform(0.1, 10.0, (b, h, w)).astype(np.float32)
    sparse = None
    if with_sparse:
        dense = rng.uniform(0.1, 10.0, (b, h, w)).astype(np.float32)
        sparse = torch.from_numpy(np.where(
            rng.random((b, h, w)) < 0.05, dense, 0.0).astype(np.float32))
    return torch.from_numpy(guid), torch.from_numpy(blur), sparse


def to(args, device):
    return [None if a is None else a.to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("num_iters,hw,norm,with_sparse", [
    (1, (228, 304), "8sum_clamp", True),
    (24, (228, 304), "8sum", True),
    (24, (228, 304), "8sum_clamp", False),
    (24, (57, 76), "8sum_abs", False),
    (5, (13, 17), "8sum_clamp", True),
    (0, (33, 65), "8sum", True),
])
def test_kernel_matches_plain(cuda, num_iters, hw, norm, with_sparse):
    args = problem(7, 2, *hw, with_sparse)
    kw = dict(num_iters=num_iters, norm_type=norm)
    want = cspn_cuda.cspn_fwd_plain(*args, **kw)
    before = cspn_cuda.cspn_fwd.launches
    got = cspn_cuda.cspn_fwd(*to(args, cuda), **kw)
    torch.cuda.synchronize()
    assert cspn_cuda.cspn_fwd.launches == before + 1
    assert got.shape == want.shape and got.device.type == "cuda"
    assert max_rel(got, want) <= TOL
    if with_sparse:
        m = args[2] > 0
        assert torch.equal(got.cpu()[m], args[2][m])


@pytest.mark.cuda
def test_head_slices_take_no_copy_and_match(cuda):
    """guidance and blur as channel slices of one (B, 9, H, W) tensor, as
    the model passes them, give the result of contiguous copies."""
    gen = torch.Generator().manual_seed(1)
    heads = torch.randn(3, 9, 40, 70, generator=gen).to(cuda)
    kw = dict(num_iters=9, norm_type="8sum")
    got = cspn_cuda.cspn_fwd(heads[:, 1:], heads[:, 0], None, **kw)
    want = cspn_cuda.cspn_fwd(heads[:, 1:].contiguous(),
                              heads[:, 0].contiguous(), None, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "shape", "planes", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    guid, blur, sparse = to(problem(3, 2, 16, 24), cuda)
    if bad == "dtype":
        blur = blur.double()
    elif bad == "shape":
        blur = blur[:, :-1]
    elif bad == "planes":
        guid = guid.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        sparse = sparse.cpu()
    before = cspn_cuda.cspn_fwd.launches
    with pytest.raises(ValueError):
        cspn_cuda.cspn_fwd(guid, blur, sparse, num_iters=2, norm_type="8sum")
    assert cspn_cuda.cspn_fwd.launches == before


@pytest.mark.cuda
def test_dispatcher_sends_cuda_tensors_to_the_kernel(cuda):
    guid, blur, sparse = problem(4, 1, 20, 30)
    kw = dict(num_iters=6, norm_type="8sum_clamp", guidance_layout="NCHW")
    want = cspn_propagate(guid, blur, sparse, impl="torch", **kw)
    before = cspn_cuda.cspn_fwd.launches
    got = cspn_propagate(*to((guid, blur, sparse), cuda), **kw)
    assert cspn_cuda.cspn_fwd.launches == before + 1
    assert max_rel(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("request_kind", ["float32_full", "uint8_padded"])
def test_small_model_on_card_matches_cpu(cuda, request_kind):
    """The serving path of a small f32 model: the kernel on the card, the
    plain loop on the CPU, the same weights and requests. A float32 request
    of the configured size, and a uint8 one smaller than it, whose scale
    and padding are built on the card."""
    cfg = get_config("synthetic_tiny").override(**{"model.dtype": "float32"})
    model = CSPNDepthNet.from_config(
        cfg.model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():                 # non-zero heads: CSPN not identity
        model.head.weight.normal_(0.0, 0.05,
                                  generator=torch.Generator().manual_seed(1))
        model.head.bias.fill_(0.5)
    h, w = cfg.data.height, cfg.data.width
    rng = np.random.default_rng(0)
    if request_kind == "float32_full":
        rgb = rng.random((2, h, w, 3), dtype=np.float32)
    else:
        h, w = h - 14, w - 26
        rgb = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    sparse = np.where(rng.random((2, h, w)) < 0.01,
                      rng.uniform(0.5, 9.5, (2, h, w)), 0.0).astype(np.float32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = cspn_cuda.cspn_fwd.launches
        got = DepthPredictor(model, cfg.data.height, cfg.data.width,
                             device=cuda).predict_batch(rgb, sparse)
        assert cspn_cuda.cspn_fwd.launches == before + 1
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want = DepthPredictor(model, cfg.data.height, cfg.data.width,
                          device="cpu").predict_batch(rgb, sparse)
    assert got.shape == (2, h, w) and np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() <= MODEL_TOL
    m = sparse > 0
    np.testing.assert_array_equal(got[m], sparse[m])


# The stash is stored by each thread: W % 4 != 0 (57x75, 13x17, 33x65)
# and narrower than a tile (13x16, 13x17) among the shapes.
GRAD_CASES = [
    (1, (228, 304), "8sum_clamp", True),
    (24, (228, 304), "8sum", True),
    (24, (57, 76), "8sum_abs", True),
    (24, (57, 76), "8sum_clamp", False),
    (5, (13, 17), "8sum", False),
    (0, (33, 65), "8sum_clamp", True),
    (24, (57, 75), "8sum_clamp", True),
    (5, (13, 16), "8sum", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("num_iters,hw,norm,with_sparse", GRAD_CASES)
def test_stash_forward_and_adjoint_match_plain(cuda, num_iters, hw, norm,
                                               with_sparse):
    """K2 (out and every stash plane) and K3 (d_guid, d_blur, d_sparse)
    against cspn_fwd_stash_plain and cspn_bwd_plain; K2's out is K1's."""
    guid, blur, sparse = problem(11, 2, *hw, with_sparse)
    cot = torch.from_numpy(np.random.default_rng(12).standard_normal(
        blur.shape).astype(np.float32))
    kw = dict(num_iters=num_iters, norm_type=norm)
    want_out, want_stash = cspn_cuda.cspn_fwd_stash_plain(guid, blur, sparse,
                                                          **kw)
    want_grads = cspn_cuda.cspn_bwd_plain(guid, sparse, want_stash, cot, **kw)
    g, b, s, c = to((guid, blur, sparse, cot), cuda)
    before = (cspn_cuda.cspn_fwd_stash.launches, cspn_cuda.cspn_bwd.launches)
    out, stash = cspn_cuda.cspn_fwd_stash(g, b, s, **kw)
    grads = cspn_cuda.cspn_bwd(g, s, stash, c, **kw)
    torch.cuda.synchronize()
    assert (cspn_cuda.cspn_fwd_stash.launches,
            cspn_cuda.cspn_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert stash.shape == (2, num_iters, *hw)
    assert max_rel(out, want_out) <= TOL
    torch.testing.assert_close(out, cspn_cuda.cspn_fwd(g, b, s, **kw),
                               rtol=0, atol=0)
    for t in range(num_iters):
        assert max_rel(stash[:, t], want_stash[:, t]) <= TOL, t
    for got, want in zip(grads, want_grads):
        assert got.shape == want.shape
        if want.abs().max() == 0:       # d_sparse without a sparse map
            assert got.abs().max() == 0
        else:
            assert max_rel(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["8sum", "8sum_abs", "8sum_clamp"])
def test_adjoint_of_zero_guidance_matches_plain(cuda, norm):
    """A fresh model's head is zero: every gate 0, s = 0 below the floor."""
    _, blur, sparse = problem(13, 1, 40, 50)
    guid = torch.zeros(1, 8, 40, 50)
    cot = torch.ones_like(blur)
    kw = dict(num_iters=6, norm_type=norm)
    _, want_stash = cspn_cuda.cspn_fwd_stash_plain(guid, blur, sparse, **kw)
    want = cspn_cuda.cspn_bwd_plain(guid, sparse, want_stash, cot, **kw)
    g, b, s, c = to((guid, blur, sparse, cot), cuda)
    _, stash = cspn_cuda.cspn_fwd_stash(g, b, s, **kw)
    got = cspn_cuda.cspn_bwd(g, s, stash, c, **kw)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        if w.abs().max() == 0:
            assert a.abs().max() == 0
        else:
            assert max_rel(a, w) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("with_sparse", [True, False])
def test_autograd_function_matches_torch_autograd(cuda, with_sparse):
    """Gradients of every input through the kernels (K2 forward, K3
    backward) against torch autograd of the plain loop, with guidance and
    blur as strided slices of one head tensor, as the model passes them."""
    gen = torch.Generator().manual_seed(5)
    heads = torch.randn(2, 9, 45, 70, generator=gen)
    heads[:, 0] = 0.5 + 9 * torch.rand(2, 45, 70, generator=gen)
    _, _, sparse = problem(6, 2, 45, 70, with_sparse)
    cot = torch.randn(2, 45, 70, generator=gen)
    kw = dict(num_iters=24, norm_type="8sum_clamp", guidance_layout="NCHW")

    def grads(device, impl):
        h = heads.to(device).requires_grad_()
        sp = None if sparse is None else sparse.to(device).requires_grad_()
        out = cspn_propagate(h[:, 1:], h[:, 0], sp, impl=impl, **kw)
        inputs = [h] + ([sp] if sp is not None else [])
        return torch.autograd.grad((out * cot.to(device)).sum(), inputs)

    before = (cspn_cuda.cspn_fwd_stash.launches, cspn_cuda.cspn_bwd.launches)
    got = grads(cuda, "auto")
    assert (cspn_cuda.cspn_fwd_stash.launches,
            cspn_cuda.cspn_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = grads("cpu", "torch")
    for a, w in zip(got, want):
        assert max_rel(a, w) <= GRAD_TOL


@pytest.mark.cuda
def test_gradient_reaches_the_head_through_the_kernels(cuda):
    """A train-mode step of a small model on the card: the loss's gradient
    reaches head.weight through K2/K3 and equals the plain-CSPN model's."""
    cfg = get_config("synthetic_tiny").override(**{"model.dtype": "float32"})
    gen = torch.Generator().manual_seed(0)
    model = CSPNDepthNet.from_config(cfg.model, generator=gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.05, generator=gen)
        model.head.bias.fill_(0.5)
    h, w = cfg.data.height, cfg.data.width
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random((2, h, w, 3), dtype=np.float32),
                        np.where(rng.random((2, h, w, 1)) < 0.01, 3.0,
                                 0.0).astype(np.float32)], -1)
    target = torch.from_numpy(rng.uniform(1, 5, (2, h, w, 1)).astype(
        np.float32))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        grads = {}
        for impl in ("auto", "torch"):
            model.cspn_impl = impl
            m = model.to(cuda).train()
            m.zero_grad()
            before = cspn_cuda.cspn_bwd.launches
            pred = m(torch.from_numpy(x).to(cuda))
            ((pred - target.to(cuda)) ** 2).mean().backward()
            torch.cuda.synchronize()
            assert cspn_cuda.cspn_bwd.launches == before + (impl == "auto")
            grads[impl] = m.head.weight.grad.clone()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert grads["auto"].abs().max() > 0
    assert max_rel(grads["auto"], grads["torch"]) <= MODEL_TOL


TILED_CASES = [
    (1, (37, 48), "8sum", True),
    (10, (50, 40), "8sum_clamp", True),      # a remainder round (4, 4, 2)
    (24, (13, 17), "8sum_abs", False),
    (24, (97, 130), "8sum", True),
    (0, (33, 65), "8sum_clamp", True),
    (24, (57, 75), "8sum_clamp", True),      # W % 4 != 0
    (5, (13, 16), "8sum", True),             # narrower than a tile
]


def raw_launches():
    return (cspn_cuda.cspn_fwd.launches, cspn_cuda.cspn_fwd_stash.launches,
            cspn_cuda.cspn_bwd.launches)


def plain_cuda_calls():
    return prenorm_gates9.cuda_calls, anchor.cuda_calls


@pytest.mark.cuda
@pytest.mark.parametrize("num_iters,hw,norm,with_sparse", TILED_CASES)
def test_tiled_kernels_match_plain(cuda, num_iters, hw, norm, with_sparse):
    """K1 (forward), K2 (out and every stash plane) and K3 (d_guidance,
    d_blur, d_sparse) at JAX's H-tiled cases, on the raw inputs against
    their plain versions; K2's out is K1's bit for bit, and so is the
    slab route's on cspn_gates9's planes with d^0 anchored on load (K7's
    entry); anchors exact."""
    guid, blur, sparse = problem(21, 2, *hw, with_sparse)
    cot = torch.from_numpy(np.random.default_rng(22).standard_normal(
        blur.shape).astype(np.float32))
    kw = dict(num_iters=num_iters, norm_type=norm)
    want = cspn_cuda.cspn_fwd_plain(guid, blur, sparse, **kw)
    want_out, want_stash = cspn_cuda.cspn_fwd_stash_plain(
        guid, blur, sparse, **kw)
    want_grads = cspn_cuda.cspn_bwd_plain(guid, sparse, want_stash, cot,
                                          **kw)
    g, d, s, c = to((guid, blur, sparse, cot), cuda)
    before = raw_launches()
    got = cspn_cuda.cspn_fwd(g, d, s, **kw)
    out, stash = cspn_cuda.cspn_fwd_stash(g, d, s, **kw)
    grads = cspn_cuda.cspn_bwd(g, s, stash, c, **kw)
    on_gates9 = cspn_cuda.cspn_prenorm_fwd(
        cspn_cuda.cspn_gates9(g, norm_type=norm), d, s, num_iters=num_iters,
        anchor_d0=True)
    torch.cuda.synchronize()
    assert raw_launches() == tuple(n + 1 for n in before)
    assert max_rel(got, want) <= TOL
    torch.testing.assert_close(out, got, rtol=0, atol=0)
    torch.testing.assert_close(on_gates9, got, rtol=0, atol=0)
    assert stash.shape == (2, num_iters, *hw)
    for t in range(num_iters):
        assert max_rel(stash[:, t], want_stash[:, t]) <= TOL, t
    for a, w in zip(grads, want_grads):
        assert a.shape == w.shape
        if w.abs().max() == 0:          # the sparse sums without anchors
            assert a.abs().max() == 0
        else:
            assert max_rel(a, w) <= TOL
    if with_sparse:
        m = sparse > 0
        assert torch.equal(got.cpu()[m], sparse[m])


@pytest.mark.cuda
@pytest.mark.parametrize("with_sparse", [True, False])
def test_tiled_function_matches_torch_autograd(cuda, with_sparse):
    """Gradients of every input through CSPNFunction (K2, K3; the
    normalization, the anchor and their gradients inside), against torch
    autograd of the plain loop, guidance and blur as head slices; no plain
    normalization or anchor on the card."""
    gen = torch.Generator().manual_seed(7)
    heads = torch.randn(2, 9, 45, 70, generator=gen)
    heads[:, 0] = 0.5 + 9 * torch.rand(2, 45, 70, generator=gen)
    _, _, sparse = problem(8, 2, 45, 70, with_sparse)
    cot = torch.randn(2, 45, 70, generator=gen)
    kw = dict(num_iters=10, norm_type="8sum_clamp", guidance_layout="NCHW")

    def grads(device, impl):
        h = heads.to(device).requires_grad_()
        sp = None if sparse is None else sparse.to(device).requires_grad_()
        out = cspn_propagate(h[:, 1:], h[:, 0], sp, impl=impl, **kw)
        inputs = [h] + ([sp] if sp is not None else [])
        return torch.autograd.grad((out * cot.to(device)).sum(), inputs)

    before, plain = raw_launches(), plain_cuda_calls()
    got = grads(cuda, "auto")
    assert raw_launches() == (before[0], before[1] + 1, before[2] + 1)
    assert plain_cuda_calls() == plain
    want = grads("cpu", "torch")
    for a, w in zip(got, want):
        assert max_rel(a, w) <= GRAD_TOL


@pytest.mark.cuda
def test_auto_sends_kitti_images_to_k1(cuda):
    guid, blur, sparse = to(problem(9, 1, 352, 1216), cuda)
    before = raw_launches()
    cspn_propagate(guid, blur, sparse, num_iters=2, norm_type="8sum_clamp",
                   guidance_layout="NCHW")
    assert raw_launches() == (before[0] + 1, before[1], before[2])


def prenorm_launches():
    return (cspn_cuda.cspn_prenorm_fwd.launches,
            cspn_cuda.cspn_prenorm_fwd_stash.launches,
            cspn_cuda.cspn_prenorm_bwd.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,num_iters,with_sparse,anchor_d0", [
    (4, (96, 1216), 4, True, False),  # KITTI 2x4: an 88-row shard + 2 x 4
    (16, (122, 304), 4, True, False),  # NYU multihost 16x2: 114 + 2 x 4
    (4, (96, 1216), 2, False, False),  # a remainder round
    (1, (40, 70), 3, True, False),
    (4, (96, 1216), 4, True, True),    # d^0 anchored on load
    (1, (40, 70), 3, False, True),
])
def test_slab_kernels_match_plain(cuda, b, hw, num_iters, with_sparse,
                                  anchor_d0):
    """K7, K8 and K9 against their plain versions on a halo'd slab, d^0 as
    given or anchored on load; K8's output is K7's bit for bit."""
    guid, blur, sparse = problem(31, b, *hw, with_sparse)
    gates9 = prenorm_gates9(guid, "8sum_clamp")
    cot = torch.randn(b, *hw, generator=torch.Generator().manual_seed(3))
    kw = dict(num_iters=num_iters, anchor_d0=anchor_d0)
    want = cspn_cuda.cspn_prenorm_fwd_plain(gates9, blur, sparse, **kw)
    _, want_stash = cspn_cuda.cspn_prenorm_fwd_stash_plain(gates9, blur,
                                                           sparse, **kw)
    want_grads = cspn_cuda.cspn_prenorm_bwd_plain(gates9, sparse, want_stash,
                                                  cot, **kw)
    g, d, s, c = to((gates9, blur, sparse, cot), cuda)
    before = prenorm_launches()
    got = cspn_cuda.cspn_prenorm_fwd(g, d, s, **kw)
    out, stash = cspn_cuda.cspn_prenorm_fwd_stash(g, d, s, **kw)
    grads = cspn_cuda.cspn_prenorm_bwd(g, s, stash, c, **kw)
    torch.cuda.synchronize()
    assert prenorm_launches() == tuple(n + 1 for n in before)
    assert max_rel(got, want) <= TOL
    torch.testing.assert_close(out, got, rtol=0, atol=0)
    assert max_rel(stash, want_stash) <= TOL
    for a, w in zip(grads, want_grads):
        if w.abs().max() == 0:          # the sparse sums without anchors
            assert a.abs().max() == 0
        else:
            assert max_rel(a, w) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("anchor_d0", [False, True])
def test_prenorm_function_matches_torch_autograd(cuda, anchor_d0):
    """Gradients of gates9, d0 and sparse through PrenormCSPNFunction (K8,
    K9), d^0 as given or anchored on load, against torch autograd of the
    plain loop."""
    from cspn_monodepth_tpu_torch.ops.cspn import cspn_propagate_prenorm

    guid, blur, sparse = problem(32, 2, 40, 70)
    gates9 = prenorm_gates9(guid, "8sum")
    cot = torch.randn(2, 40, 70, generator=torch.Generator().manual_seed(4))

    def grads(device, impl):
        inputs = [x.to(device).requires_grad_() for x in (gates9, blur,
                                                          sparse)]
        out = cspn_propagate_prenorm(*inputs, num_iters=4, impl=impl,
                                     anchor_d0=anchor_d0)
        return torch.autograd.grad((out * cot.to(device)).sum(), inputs)

    before = prenorm_launches()
    got = grads(cuda, "auto")
    assert prenorm_launches() == (before[0], before[1] + 1, before[2] + 1)
    for a, w in zip(got, grads("cpu", "torch")):
        assert max_rel(a, w) <= GRAD_TOL


def stage_launches():
    return (cspn_cuda.cspn_bwd_sweep.launches,
            cspn_cuda.cspn_bwd_sums.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("num_iters,hw,norm,with_sparse", [
    (24, (228, 304), "8sum_clamp", True),
    (10, (50, 40), "8sum", True),           # a remainder round (4, 4, 2)
    (5, (13, 17), "8sum_abs", False),
    (0, (33, 65), "8sum_clamp", True),
])
def test_adjoint_stages_match_plain_stages(cuda, num_iters, hw, norm,
                                           with_sparse):
    """Each stage kernel of csrc/cspn_bwd.cu against its plain stage on
    the same inputs: cspn_gates9 (K3's stage 0), the sweep (every plane of
    the adjoint stash and lam^0), both forms of the sums (fed the plain
    sweep's lam stash)."""
    from cspn_monodepth_tpu_torch.ops.cspn_ref import (
        adjoint_sweep_plain,
        cspn_bwd_sums_plain,
    )

    guid, blur, sparse = problem(41, 2, *hw, with_sparse)
    gates9 = prenorm_gates9(guid, norm)
    cot = torch.from_numpy(np.random.default_rng(42).standard_normal(
        blur.shape).astype(np.float32))
    kw = dict(num_iters=num_iters)
    _, stash = cspn_cuda.cspn_fwd_stash_plain(guid, blur, sparse,
                                              norm_type=norm, **kw)
    want_stash, want_lam0 = adjoint_sweep_plain(gates9, sparse, cot, **kw)
    raw = dict(guidance=guid, lam0=want_lam0, norm_type=norm)
    want = (cspn_bwd_sums_plain(sparse, stash, want_stash, **kw),
            cspn_bwd_sums_plain(sparse, stash, want_stash, **kw, **raw))
    g, g9, s, c, st, ls = to((guid, gates9, sparse, cot, stash, want_stash),
                             cuda)
    before = stage_launches() + (cspn_cuda.cspn_gates9.launches,)
    got_g9 = cspn_cuda.cspn_gates9(g, norm_type=norm)
    lam_stash, lam0 = cspn_cuda.cspn_bwd_sweep(g9, s, c, **kw)
    got = (cspn_cuda.cspn_bwd_sums(s, st, ls, **kw),
           cspn_cuda.cspn_bwd_sums(s, st, ls, **kw, **to_cuda(raw, cuda)))
    torch.cuda.synchronize()
    assert stage_launches() + (cspn_cuda.cspn_gates9.launches,) == (
        before[0] + 1, before[1] + 2, before[2] + 1)
    assert max_rel(got_g9, gates9) <= TOL
    assert lam_stash.shape == (2, num_iters, *hw)
    for t in range(num_iters):
        assert max_rel(lam_stash[:, t], want_stash[:, t]) <= TOL, t
    assert max_rel(lam0, want_lam0) <= TOL
    for outs, wants in zip(got, want):
        for a, w in zip(outs, wants):
            if w.abs().max() == 0:      # no sums at T = 0 or without anchors
                assert a.abs().max() == 0
            else:
                assert max_rel(a, w) <= TOL


def to_cuda(kw: dict, device) -> dict:
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()}


@pytest.mark.cuda
def test_adjoints_are_deterministic(cuda):
    """No atomics: two runs of K3 and of K9 on the same inputs agree bit for
    bit."""
    guid, blur, sparse = to(problem(43, 2, 100, 150), cuda)
    cot = torch.randn(blur.shape, generator=torch.Generator().manual_seed(
        44)).to(cuda)
    kw = dict(num_iters=24)
    _, stash = cspn_cuda.cspn_fwd_stash(guid, blur, sparse,
                                        norm_type="8sum", **kw)
    gates9 = prenorm_gates9(guid, "8sum")
    _, pstash = cspn_cuda.cspn_prenorm_fwd_stash(gates9, blur, sparse,
                                                 anchor_d0=True, **kw)
    for run in (lambda: cspn_cuda.cspn_bwd(guid, sparse, stash, cot,
                                           norm_type="8sum", **kw),
                lambda: cspn_cuda.cspn_prenorm_bwd(gates9, sparse, pstash,
                                                   cot, anchor_d0=True,
                                                   **kw)):
        first, second = run(), run()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("contract", ["raw", "prenorm"])
@pytest.mark.parametrize("w", [53, 56])
def test_every_geometry_gives_the_same_bits(cuda, contract, w):
    """The forward round under every tile geometry of the launch plan
    (ops/cspn_cuda.py:fwd_plan), at a W that is not a multiple of 4 and
    one that is: the outputs bit for bit the same, the stash entries'
    outputs the plain entries', the stashes bit for bit the same and
    within TOL of the plain stash, and each output within TOL of the plain
    version."""
    guid, blur, sparse = to(problem(11, 5, 37, w), cuda)
    t = 17
    if contract == "raw":
        kw = dict(num_iters=t, norm_type="8sum_clamp")
        args = (guid, blur, sparse)
        fwd, stash = cspn_cuda.cspn_fwd, cspn_cuda.cspn_fwd_stash
        want, want_stash = cspn_cuda.cspn_fwd_stash_plain(*args, **kw)
    else:
        kw = dict(num_iters=t)
        args = (prenorm_gates9(guid, "8sum_clamp"), anchor(blur, sparse),
                sparse)
        fwd = cspn_cuda.cspn_prenorm_fwd
        stash = cspn_cuda.cspn_prenorm_fwd_stash
        want, want_stash = cspn_cuda.cspn_prenorm_fwd_stash_plain(*args,
                                                                  **kw)
    first = first_stash = None
    for geometry in range(len(cspn_cuda.FWD_GEOMETRIES)):
        got = fwd(*args, **kw, geometry=geometry)
        out, st = stash(*args, **kw, geometry=geometry)
        torch.cuda.synchronize()
        first = got if first is None else first
        first_stash = st if first_stash is None else first_stash
        assert torch.equal(got, first), geometry
        assert torch.equal(out, got), geometry
        assert torch.equal(st, first_stash), geometry
    assert max_rel(first, want) <= TOL
    for i in range(t):
        assert max_rel(first_stash[:, i], want_stash[:, i]) <= TOL, i
    m = sparse > 0
    assert torch.equal(first[m], sparse[m])


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [dict(geometry=-1), dict(geometry=99)])
def test_a_plan_the_kernel_cannot_run_raises(cuda, plan):
    guid, blur, sparse = to(problem(3, 3, 16, 24), cuda)
    before = cspn_cuda.cspn_fwd.launches
    with pytest.raises(ValueError):
        cspn_cuda.cspn_fwd(guid, blur, sparse, num_iters=9,
                           norm_type="8sum", **plan)
    assert cspn_cuda.cspn_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("with_sparse", [True, False])
def test_operators_launch_the_kernels_on_the_card(cuda, with_sparse):
    """The registered operators (ops/library.py) on CUDA tensors are the
    wrappers: K1 and the normalization launch once a call, bit for bit
    the wrapper's output;
    torch.library.opcheck holds the fake and the real alike."""
    ops = torch.ops.cspn_monodepth_tpu_torch
    guid, blur, sparse = to(problem(12, 2, 40, 56, with_sparse), cuda)
    before = cspn_cuda.cspn_fwd.launches
    got = ops.cspn_fwd(guid, blur, sparse, 7, "8sum_clamp")
    assert cspn_cuda.cspn_fwd.launches == before + 1
    assert torch.equal(got, cspn_cuda.cspn_fwd(
        guid, blur, sparse, num_iters=7, norm_type="8sum_clamp"))
    before = cspn_cuda.cspn_gates9.launches
    gates9 = ops.cspn_gates9(guid, "8sum_clamp")
    assert cspn_cuda.cspn_gates9.launches == before + 1
    assert torch.equal(gates9, cspn_cuda.cspn_gates9(guid,
                                                     norm_type="8sum_clamp"))
    torch.library.opcheck(ops.cspn_fwd.default,
                          (guid, blur, sparse, 3, "8sum"))
    torch.library.opcheck(ops.cspn_gates9.default, (guid, "8sum_abs"))


@pytest.mark.cuda
def test_program_exported_on_the_card_equals_predict_batch(cuda, tmp_path):
    """export_program on the card, then load_program: the same output as
    predict_batch, one K1 launch a call; the program refuses the CPU."""
    from cspn_monodepth_tpu_torch.ops.library import load_program

    cfg = get_config("synthetic_tiny")
    model = CSPNDepthNet.from_config(
        cfg.model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.05,
                                  generator=torch.Generator().manual_seed(1))
        model.head.bias.fill_(0.5)
    h, w = cfg.data.height, cfg.data.width
    predictor = DepthPredictor(model, h, w, device=cuda)
    path = tmp_path / "tiny.pt2"
    predictor.export_program(str(path), batch=2)
    rng = np.random.default_rng(3)
    rgb = rng.random((2, h, w, 3), dtype=np.float32)
    sparse = np.where(rng.random((2, h, w)) < 0.01,
                      rng.uniform(0.5, 9.5, (2, h, w)), 0.0).astype(np.float32)
    want = predictor.predict_batch(rgb, sparse)
    program = load_program(str(path), device="cuda")
    x = torch.from_numpy(np.concatenate([rgb, sparse[..., None]], -1))
    before = cspn_cuda.cspn_fwd.launches
    got = program(x.to(cuda)).cpu().numpy()[..., 0]
    assert cspn_cuda.cspn_fwd.launches == before + 1
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exported on cuda"):
        load_program(str(path), device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["8sum", "8sum_abs", "8sum_clamp"])
@pytest.mark.parametrize("zero", [False, True])
def test_gates9_pair_matches_plain(cuda, norm, zero):
    """cspn_gates9 and cspn_gates9_bwd against prenorm_gates9 and torch
    autograd of it, at 57x75 (W % 4 != 0) on head slices; at zero guidance
    the gradient is finite (0 under 8sum_abs: sign(0) = 0)."""
    gen = torch.Generator().manual_seed(51)
    heads = torch.randn(2, 9, 57, 75, generator=gen)
    if zero:
        heads.zero_()
    guid = heads[:, 1:]
    d_gates9 = torch.randn(2, 9, 57, 75, generator=gen)
    want = prenorm_gates9(guid, norm)
    want_grad = cspn_cuda.prenorm_gates9_bwd_plain(guid, d_gates9, norm)
    g, dg = heads.to(cuda)[:, 1:], d_gates9.to(cuda)
    before = (cspn_cuda.cspn_gates9.launches,
              cspn_cuda.cspn_gates9_bwd.launches)
    got = cspn_cuda.cspn_gates9(g, norm_type=norm)
    got_grad = cspn_cuda.cspn_gates9_bwd(g, dg, norm_type=norm)
    torch.cuda.synchronize()
    assert (cspn_cuda.cspn_gates9.launches,
            cspn_cuda.cspn_gates9_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert max_rel(got, want) <= TOL
    assert torch.isfinite(got_grad).all()
    if want_grad.abs().max() == 0:
        assert got_grad.abs().max() == 0
    else:
        assert max_rel(got_grad, want_grad) <= TOL
    if zero and norm == "8sum_abs":
        assert got_grad.abs().max() == 0


@pytest.mark.cuda
def test_gates9_function_matches_torch_autograd(cuda):
    """cspn_normalize with a gradient wanted runs Gates9Function
    (cspn_gates9, cspn_gates9_bwd) on the card, no plain normalization
    there; its gradient against torch autograd of prenorm_gates9 on the
    CPU."""
    from cspn_monodepth_tpu_torch.ops.cspn import cspn_normalize

    guid, _, _ = problem(52, 2, 40, 70)
    cot = torch.randn(2, 9, 40, 70, generator=torch.Generator().manual_seed(
        53))
    g = guid.to(cuda).requires_grad_()
    plain = plain_cuda_calls()
    out = cspn_normalize(g, norm_type="8sum_clamp")
    assert type(out.grad_fn).__name__ == "Gates9FunctionBackward"
    (got,) = torch.autograd.grad((out * cot.to(cuda)).sum(), g)
    assert plain_cuda_calls() == plain
    c = guid.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        (prenorm_gates9(c, "8sum_clamp") * cot).sum(), c)
    assert max_rel(got, want) <= TOL


def bench_setup(cuda):
    """The port bench's chain bodies on synthetic_tiny at the card: the
    trainer, its state and the bench's device batch (with valid_image)."""
    from cspn_monodepth_tpu_torch import bench
    from cspn_monodepth_tpu_torch.train import Trainer

    cfg = get_config("synthetic_tiny")
    trainer = Trainer(cfg, device=cuda)
    state = trainer.init_state()
    batch = bench.synthetic_batch(cfg.train.batch_size, cfg.data.height,
                                  cfg.data.width, cuda)
    batch["valid_image"] = torch.ones(cfg.train.batch_size, device=cuda)
    return bench, trainer, state, batch


@pytest.mark.cuda
def test_bench_chains_launch_each_kernel_once_a_step(cuda):
    """The bench's train chain launches K2 and K3 once a step and its eval
    chain K1 once a step; nothing else launches, and no plain CSPN,
    normalization or anchor runs on the card; its inputs reach the step
    without a copy."""
    bench, trainer, state, batch = bench_setup(cuda)
    train = {k: v for k, v in batch.items() if k != "valid_image"}
    # The device batch passes _to_device/_unpack without a copy.
    moved = trainer._unpack(trainer._to_device(train))
    assert all(moved[k].data_ptr() == train[k].data_ptr() for k in train)
    cspn_cuda.reset_launch_counts()
    plain = plain_cuda_calls()
    value = torch.zeros((), device=cuda)
    for i in range(3):
        value = bench.train_body(trainer, state, train, i)
    acc = torch.zeros((), device=cuda)
    for i in range(3):
        acc = bench.eval_body(trainer, state, batch, acc, i)
    torch.cuda.synchronize()
    launches = cspn_cuda.launch_counts()
    want = {k: 0 for k in launches}
    want.update(cspn_fwd_stash=3, cspn_bwd=3, cspn_fwd=3)
    assert launches == want
    assert plain_cuda_calls() == plain
    assert torch.isfinite(value) and torch.isfinite(acc)


@pytest.mark.cuda
def test_bench_steps_make_no_host_sync(cuda):
    """A train step and an eval step of the bench's chains make no
    host-device synchronization (torch.cuda.set_sync_debug_mode), so the
    chain's steps queue behind each other until the one read-back, its
    only sync."""
    from cspn_monodepth_tpu_torch.utils.profiling import count_syncs

    bench, trainer, state, batch = bench_setup(cuda)
    train = {k: v for k, v in batch.items() if k != "valid_image"}
    acc = torch.zeros((), device=cuda)
    bench.train_body(trainer, state, train, 0)          # warm
    bench.eval_body(trainer, state, batch, acc, 0)
    torch.cuda.synchronize()
    # The counter's control: a scalar read back is a sync.
    assert count_syncs(lambda: torch.ones(1, device=cuda).sum().item())
    assert count_syncs(lambda: bench.train_body(trainer, state, train,
                                                1)) == []
    assert count_syncs(lambda: bench.eval_body(trainer, state, batch, acc,
                                               1)) == []

    def chain():
        value = acc
        for i in range(3):
            value = bench.train_body(trainer, state, train, i)
        return float(value)

    # A chain syncs once: its read-back.
    assert len(count_syncs(chain)) == 1


# ------------------------------------------------------------ k x k (CSPN++)
# csrc/cspn_kxk.cu against ops/cspn_ref.py's plain k x k loop on the card.
# The kernels normalize by a reciprocal and sum in their own order; the
# gates are contractive (8sum_abs, or positive affinities under
# 8sum_clamp, as a trained or seeded head gives), so TOL holds as for
# K1-K3. Signed gates under 8sum and 8sum_clamp expand at T = 24 (row abs
# sums near 2); those cases run at T <= 5.
def kxk_problem(seed, k, b, h, w, norm, with_sparse):
    rng = np.random.default_rng(seed)
    n = k * k - 1
    if norm == "8sum_clamp":
        guid = rng.uniform(0.5, 1.5, (b, n, h, w))
    else:
        guid = rng.standard_normal((b, n, h, w))
    blur = rng.uniform(0.1, 10.0, (b, h, w))
    sparse = None
    if with_sparse:
        sparse = torch.from_numpy(np.where(
            rng.random((b, h, w)) < 0.05, rng.uniform(1.0, 80.0, (b, h, w)),
            0.0).astype(np.float32))
    return (torch.from_numpy(guid.astype(np.float32)),
            torch.from_numpy(blur.astype(np.float32)), sparse)


def kxk_check(cuda, k, b, hw, num_iters, norm, with_sparse):
    """The three k x k wrappers against the plain versions on the card; the
    largest max-relative error of out, stash and the three gradients."""
    from cspn_monodepth_tpu_torch.ops import cspn_ref

    g, blur, sp = to(kxk_problem(k, k, b, *hw, norm, with_sparse), cuda)
    kw = dict(num_iters=num_iters, norm_type=norm)
    want, want_stash = cspn_ref.cspn_kxk_fwd_stash_plain(g, blur, sp, **kw)
    got = cspn_cuda.cspn_kxk_fwd(g, blur, sp, **kw)
    got_s, stash = cspn_cuda.cspn_kxk_fwd_stash(g, blur, sp, **kw)
    grad = torch.randn(want.shape, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(k))
    want_g = cspn_ref.cspn_kxk_bwd_plain(g, sp, want_stash, grad, **kw)
    got_g = cspn_cuda.cspn_kxk_bwd(g, sp, stash, grad, **kw)
    errs = [max_rel(got, want), max_rel(got_s, want)]
    if num_iters:
        errs.append(max_rel(stash, want_stash))
    errs += [max_rel(a, b_) for a, b_ in zip(got_g[:2], want_g[:2])]
    if with_sparse:
        errs.append(max_rel(got_g[2], want_g[2]))
    else:
        assert not got_g[2].any()
    return max(errs)


KXK_CASES = [
    (5, 2, (37, 53), 24, "8sum_clamp", True),
    (7, 2, (37, 53), 24, "8sum_abs", True),
    (7, 1, (19, 33), 5, "8sum", True),
    (5, 3, (13, 17), 5, "8sum_clamp", False),
    (7, 2, (40, 64), 1, "8sum_clamp", True),
    (5, 1, (9, 70), 0, "8sum_abs", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,b,hw,num_iters,norm,with_sparse", KXK_CASES)
def test_kxk_kernels_match_plain(cuda, k, b, hw, num_iters, norm,
                                 with_sparse):
    kxk = (cspn_cuda.cspn_kxk_fwd, cspn_cuda.cspn_kxk_fwd_stash,
           cspn_cuda.cspn_kxk_bwd)
    before = [w.launches for w in kxk]
    assert kxk_check(cuda, k, b, hw, num_iters, norm, with_sparse) <= TOL
    assert [w.launches - n for w, n in zip(kxk, before)] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 7])
def test_kxk_kernels_match_plain_at_kitti_size(cuda, k):
    """B = 8 at 352x1216, T = 24, as CSPN++'s training step runs them."""
    assert kxk_check(cuda, k, 8, (352, 1216), 24, "8sum_clamp", True) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("with_sparse", [True, False])
def test_kxk_function_matches_torch_autograd(cuda, with_sparse):
    """cspn_propagate on k x k guidance under autograd: CSPNFunction with
    the k x k kernels on the card against torch autograd of the plain loop, with the
    guidance and blur as slices of one head output, as the model passes
    them."""
    from cspn_monodepth_tpu_torch.ops import cspn_ref

    g, blur, sp = kxk_problem(3, 7, 2, 30, 41, "8sum_clamp", with_sparse)
    heads = torch.cat([blur[:, None], g], 1).to(cuda)
    sp = None if sp is None else sp.to(cuda)
    grad = torch.randn((2, 30, 41), device=cuda)
    got_h = heads.clone().requires_grad_()
    before = cspn_cuda.cspn_kxk_bwd.launches
    out = cspn_propagate(got_h[:, 1:], got_h[:, 0], sp, num_iters=12,
                         norm_type="8sum_clamp", guidance_layout="NCHW")
    out.backward(grad)
    assert cspn_cuda.cspn_kxk_bwd.launches == before + 1
    want_h = heads.clone().requires_grad_()
    cspn_ref.cspn_kxk_fwd_plain(want_h[:, 1:], want_h[:, 0], sp,
                                num_iters=12,
                                norm_type="8sum_clamp").backward(grad)
    assert max_rel(got_h.grad, want_h.grad) <= GRAD_TOL


@pytest.mark.cuda
def test_cspnpp_model_on_card_matches_cpu(cuda):
    """A small f32 CA-CSPN model's train-mode forward and gradients: the
    kernels (K2/K3's 3x3 branch, the k x k ones) on the card, the plain
    loops on the CPU; no plain CSPN runs on the card."""
    cfg = get_config("synthetic_tiny").override(**{
        "model.dtype": "float32", "model.cspn_kernel_sizes": (3, 5, 7),
        "model.cspn_checkpoints": (2, 4), "model.cspn_impl": "auto"})
    model = CSPNDepthNet.from_config(
        cfg.model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.05,
                                  generator=torch.Generator().manual_seed(1))
        model.head.bias.fill_(1.0)
    rng = np.random.default_rng(0)
    x = rng.random((2, 32, 48, 4), dtype=np.float32)
    x[..., 3] = np.where(rng.random((2, 32, 48)) < 0.02, 5.0, 0.0)
    x = torch.from_numpy(x)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    plain = plain_cuda_calls()
    try:
        card = CSPNDepthNet.from_config(cfg.model).to(cuda)
        card.load_state_dict(model.state_dict())
        before = cspn_cuda.cspn_kxk_fwd_stash.launches
        got = card(x.to(cuda))
        got.square().mean().backward()
        assert cspn_cuda.cspn_kxk_fwd_stash.launches == before + 4
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert plain_cuda_calls() == plain
    want = model(x)
    want.square().mean().backward()
    assert max_rel(got.cpu(), want) <= MODEL_TOL
    assert max_rel(card.head.weight.grad.cpu(),
                   model.head.weight.grad) <= MODEL_TOL


# Train-mode BatchNorm (csrc/batch_norm.cu, ops/batch_norm.py) at every
# BatchNorm site of the three train cells' configurations, in bf16 as they
# run under autocast. bf16 outputs (y, dx) within 2**-7 of the largest: one
# bf16 rounding step, since each side computes in f32 and rounds once. f32
# statistics (mean, invstd, running statistics) within 1e-5 relative.
# dweight and dbias against the plain version within 2**-6 of their sums of
# |terms|: both reduce as ATen's CUDA kernel does, rounding to bf16 at each
# step of a tree, from per-thread sums in f32 (the kernels) or float64
# (the plain version), so a rounding may land one bf16 step apart (2**-7
# of its operand); against ATen's within 2**-7 of the largest, as outputs.
BN_CELLS = (("nyu_completion_500", 32), ("kitti_1216", 8),
            ("kitti_1216_cspnpp", 8))
BN_TOL = 2.0 ** -7
BN_STAT_TOL = 1e-5
BN_TREE_TOL = 2.0 ** -6


def bn_sites(name: str, batch: int) -> list:
    """(shape, strides) of every BatchNorm input of config `name`'s network
    at its data size, in call order (the network on the meta device)."""
    from cspn_monodepth_tpu_torch.models.resnet import BatchNorm2d

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


def bn_problem(shape, strides, dtype, device, seed):
    """x N(1.5, 3^2) with the site's strides (a cropped view where they
    are wider), parameters, running statistics and a cotangent N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    size = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    base = torch.randn(size, generator=g, device=device) * 3 + 1.5
    x = base.to(dtype).as_strided(shape, strides)
    c = shape[1]
    prm = [torch.randn(c, generator=g, device=device),
           torch.randn(c, generator=g, device=device),
           torch.randn(c, generator=g, device=device),
           torch.rand(c, generator=g, device=device) + 0.5]
    dy = torch.randn(shape, generator=g, device=device).to(dtype)
    return x, prm, dy


def bn_sum_err(got, want, terms) -> float:
    scale = terms.double().abs().sum((0, 2, 3))
    return float(((got.double() - want.double()).abs() / scale).max().cpu())


def bn_errors(x, prm, dy) -> dict:
    """The kernels against the plain version and against ATen's
    F.batch_norm (the module's path before these kernels, whose running
    variance is torch's unbiased one: folded back here)."""
    import torch.nn.functional as F

    from cspn_monodepth_tpu_torch.ops import batch_norm as bn

    w, b, rm, rv = prm
    kw = dict(momentum=0.1, eps=1e-5)
    stats = [rm.clone(), rv.clone()]
    y, mean, invstd = bn.batch_norm_train_fwd(x, w, b, *stats, **kw)
    dx, dw, db = bn.batch_norm_train_bwd(dy, x, w, mean, invstd)
    plain_stats = [rm.clone(), rv.clone()]
    py, pmean, pinv = bn.batch_norm_train_fwd_plain(x, w, b, *plain_stats,
                                                    **kw)
    pdx, pdw, pdb = bn.batch_norm_train_bwd_plain(dy, x, w, pmean, pinv)
    xa = x.detach().requires_grad_()
    wa, ba = w.clone().requires_grad_(), b.clone().requires_grad_()
    ra, va = rm.clone(), rv.clone()
    n = x.numel() // x.shape[1]
    ay = F.batch_norm(xa, ra, va, wa, ba, True, 0.1, 1e-5)
    ay.backward(dy)
    va = rv * 0.9 + (va - rv * 0.9) * ((n - 1) / n)
    xhat = (x.double() - pmean.double()[:, None, None]) \
        * pinv.double()[:, None, None]
    return {
        "plain": {"y": max_rel(y, py), "dx": max_rel(dx, pdx),
                  "mean": max_rel(mean, pmean),
                  "invstd": max_rel(invstd, pinv),
                  "running_mean": max_rel(stats[0], plain_stats[0]),
                  "running_var": max_rel(stats[1], plain_stats[1]),
                  "dweight": bn_sum_err(dw, pdw, dy.double() * xhat),
                  "dbias": bn_sum_err(db, pdb, dy)},
        "aten": {"y": max_rel(y, ay.detach()), "dx": max_rel(dx, xa.grad),
                 "running_mean": max_rel(stats[0], ra),
                 "running_var": max_rel(stats[1], va),
                 "dweight": max_rel(dw, wa.grad),
                 "dbias": max_rel(db, ba.grad)}}


def bn_tol(side: str, key: str) -> float:
    if key in ("y", "dx") or (side == "aten" and key in ("dweight",
                                                         "dbias")):
        return BN_TOL
    return BN_TREE_TOL if key in ("dweight", "dbias") else BN_STAT_TOL


def bn_within(errs: dict) -> bool:
    return all(v <= bn_tol(side, k) for side, got in errs.items()
               for k, v in got.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name, batch", BN_CELLS)
def test_batch_norm_kernels_at_every_site(cuda, name, batch):
    """Every distinct (shape, strides) BatchNorm site of the cell's network,
    bf16: the kernels against the plain version and ATen's F.batch_norm."""
    from cspn_monodepth_tpu_torch.ops import batch_norm as bn

    sites = sorted(set(bn_sites(name, batch)))
    before = (bn.batch_norm_train_fwd.launches,
              bn.batch_norm_train_bwd.launches)
    for i, (shape, strides) in enumerate(sites):
        x, prm, dy = bn_problem(shape, strides, torch.bfloat16, cuda, i)
        errs = bn_errors(x, prm, dy)
        assert bn_within(errs), (shape, strides, errs)
        del x, prm, dy
    assert (bn.batch_norm_train_fwd.launches,
            bn.batch_norm_train_bwd.launches) == (before[0] + len(sites),
                                                  before[1] + len(sites))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, strides", [
    ((4, 64, 57, 76), (554496, 4332, 76, 1)),
    ((4, 512, 15, 19), (163840, 320, 20, 1)),   # rows of 19, 20 apart
    ((2, 48, 9, 33), (14256, 297, 33, 1))])     # odd sizes: 4-byte loads
def test_batch_norm_kernels_in_f32(cuda, shape, strides):
    """f32 x: everything within BN_STAT_TOL; ATen's dweight and dbias are
    held in the bf16 cases only."""
    x, prm, dy = bn_problem(shape, strides, torch.float32, cuda, 7)
    errs = bn_errors(x, prm, dy)
    del errs["aten"]["dweight"], errs["aten"]["dbias"]
    assert all(v <= BN_STAT_TOL for side in errs.values()
               for v in side.values()), errs


@pytest.mark.cuda
def test_batch_norm_kernels_are_deterministic(cuda):
    """Two runs bit for bit: fixed slices, fixed merge orders, no atomics."""
    from cspn_monodepth_tpu_torch.ops import batch_norm as bn

    x, (w, b, rm, rv), dy = bn_problem((8, 64, 176, 608),
                                       (6848512, 107008, 608, 1),
                                       torch.bfloat16, cuda, 3)
    runs = []
    for _ in range(2):
        stats = [rm.clone(), rv.clone()]
        y, mean, invstd = bn.batch_norm_train_fwd(x, w, b, *stats,
                                                  momentum=0.1, eps=1e-5)
        runs.append((y, mean, invstd, *stats,
                     *bn.batch_norm_train_bwd(dy, x, w, mean, invstd)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_batch_norm_module_takes_the_kernels_in_train_mode_only(cuda):
    from cspn_monodepth_tpu_torch.models.resnet import batch_norm
    from cspn_monodepth_tpu_torch.ops import batch_norm as bn

    m = batch_norm(16).to(cuda)
    x = torch.randn((2, 16, 12, 20), device=cuda)
    before = bn.batch_norm_train_fwd.launches
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = m(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert m.weight.grad.dtype == torch.float32
    assert bn.batch_norm_train_fwd.launches == before + 1
    m.eval()
    m(x)
    assert bn.batch_norm_train_fwd.launches == before + 1


@pytest.mark.cuda
def test_batch_norm_wrapper_refuses_a_vector_off_the_card(cuda):
    from cspn_monodepth_tpu_torch.ops import batch_norm as bn

    x = torch.randn((2, 3, 4, 5), device=cuda)
    on = torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="weight is on cpu"):
        bn.batch_norm_train_fwd(x, torch.ones(3), on, on.clone(), on.clone(),
                                momentum=0.1, eps=1e-5)


@pytest.mark.cuda
def test_batch_norm_kernels_reproduce_atens_numbers(cuda):
    """kitti_1216's sites (all contiguous), bf16: y, mean and invstd equal
    ATen's (native_batch_norm, which F.batch_norm runs and the benchmark's
    reference with it) bit for bit; dx on the same mean and invstd differs
    from ATen's native_batch_norm_backward in at most a 1e-4 share of the
    elements: the kernels take ATen's threads' sums by parts, in another
    order, so a rounding of its reduction tree may land one step apart."""
    from cspn_monodepth_tpu_torch.ops import batch_norm as bn

    for i, (shape, strides) in enumerate(sorted(set(bn_sites("kitti_1216",
                                                             8)))):
        x, (w, b, rm, rv), dy = bn_problem(shape, strides, torch.bfloat16,
                                           cuda, 100 + i)
        y, mean, inv = bn.batch_norm_train_fwd(x, w, b, rm.clone(),
                                               rv.clone(), momentum=0.1,
                                               eps=1e-5)
        ay, am, ai = torch.ops.aten.native_batch_norm(
            x, w, b, rm.clone(), rv.clone(), True, 0.1, 1e-5)
        assert torch.equal(mean, am) and torch.equal(inv, ai), shape
        assert torch.equal(y, ay), shape
        dx, _, _ = bn.batch_norm_train_bwd(dy, x, w, mean, inv)
        adx, _, _ = torch.ops.aten.native_batch_norm_backward(
            dy, x, w, None, None, am, ai, True, 1e-5, [True, True, True])
        assert float((dx != adx).float().mean()) <= 1e-4, shape


# The 3 x 3 CSPN's head conv (ops/head_conv.py over csrc/head_conv.cu)
# against F.conv2d and its two input gradients in float64 (cuDNN's double
# kernels: the exact sums to f32's eyes): y, dw and db within HEAD_TOL of
# the largest reference value; dx in f32 too, and in bf16 within one bf16
# ulp of the reference's round-to-nearest-even cast where the reference is
# at least HEAD_ULP_FLOOR of its largest value, else within HEAD_TOL of
# that largest value (below it an f32 sum's own rounding, ~1e-6 of the
# largest, exceeds a bf16 ulp). cuDNN's float32 kernels with TF32 off, which
# the head ran before, are no such reference: their dw reads 1.5e-5 to
# 2.4e-4 from float64's at these shapes on an H100 (and the kernels' 2.8e-7
# to 1.1e-6).
HEAD_TOL = 1e-5
HEAD_ULP_FLOOR = 1e-3
HEAD_CASES = [
    ((8, 64, 352, 1216), 9, torch.bfloat16, 1),     # kitti1216 train, serve
    ((32, 64, 228, 304), 9, torch.bfloat16, 1),     # nyu500 train
    ((1, 64, 352, 1216), 9, torch.bfloat16, 1),     # one KITTI frame
    ((1, 64, 228, 304), 9, torch.float32, 1),       # a float32 model
    ((2, 64, 37, 203), 9, torch.bfloat16, 1),       # W not of the tile or 4
    ((2, 64, 37, 203), 9, torch.float32, 1),
    ((2, 16, 20, 50), 9, torch.float32, 1),         # synthetic_tiny's Cin
    ((3, 70, 19, 130), 12, torch.bfloat16, 1),      # Cin over 64, Cout 12
    ((2, 64, 35, 130), 9, torch.bfloat16, 0),       # a rows window
]


def head_case(shape, cout, dtype, pad_h, device, seed):
    """x (shape) N(0, 1) in dtype, weight N(0, 0.1), bias N(0, 1), dy
    N(0, 1) of the output's shape, on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, cin, h, w = shape
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    weight = 0.1 * torch.randn((cout, cin, 3, 3), generator=gen,
                               device=device)
    bias = torch.randn(cout, generator=gen, device=device)
    dy = torch.randn((b, cout, h + 2 * pad_h - 2, w), generator=gen,
                     device=device)
    return x, weight, bias, dy


def head_reference(x, weight, bias, dy, pad_h):
    """F.conv2d of x and its gradients in float64."""
    pad = (pad_h, 1)
    xd, wd, dyd = x.double(), weight.double(), dy.double()
    y = torch.nn.functional.conv2d(xd, wd, bias.double(), padding=pad)
    dx = torch.nn.grad.conv2d_input(x.shape, wd, dyd, padding=pad)
    dw = torch.nn.grad.conv2d_weight(xd, weight.shape, dyd, padding=pad)
    return y, dx, dw, dyd.sum((0, 2, 3))


def head_dx_ok(dx, ref) -> bool:
    if dx.dtype == torch.float32:
        return max_rel(dx, ref) <= HEAD_TOL
    big = ref.abs().max()
    want = ref.float().to(torch.bfloat16)
    ulps = (dx.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    near_zero = ref.abs() < HEAD_ULP_FLOOR * big
    far = (dx.double() - ref).abs() > HEAD_TOL * big
    return not bool(((ulps > 1) & ~near_zero).any()) and \
        not bool((far & near_zero).any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,dtype,pad_h", HEAD_CASES)
def test_head_conv_kernels_match_conv2d(cuda, shape, cout, dtype, pad_h):
    from cspn_monodepth_tpu_torch.ops import head_conv as hc

    x, weight, bias, dy = head_case(shape, cout, dtype, pad_h, cuda,
                                    sum(shape))
    before = [fn.launches for fn in hc.WRAPPERS]
    y = hc.head_conv3x3_fwd(x, weight, bias, pad_h=pad_h)
    dx, dw, db = hc.head_conv3x3_bwd(dy, x, weight, pad_h=pad_h)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(hc.WRAPPERS, before)] == [1, 1]
    ry, rdx, rdw, rdb = head_reference(x, weight, bias, dy, pad_h)
    assert (y.dtype, dx.dtype) == (torch.float32, dtype)
    errs = dict(y=max_rel(y, ry), dw=max_rel(dw, rdw), db=max_rel(db, rdb),
                dx=max_rel(dx, rdx))
    assert max(errs["y"], errs["dw"], errs["db"]) <= HEAD_TOL, errs
    assert head_dx_ok(dx, rdx), errs


@pytest.mark.cuda
def test_head_conv_kernels_are_deterministic(cuda):
    """Two runs bit for bit: every output one thread's sum, dw and db the
    walkers' partial sums added in walker order; no float atomics."""
    from cspn_monodepth_tpu_torch.ops import head_conv as hc

    x, weight, bias, dy = head_case((32, 64, 228, 304), 9, torch.bfloat16,
                                    1, cuda, 5)
    runs = [(hc.head_conv3x3_fwd(x, weight, bias, pad_h=1),
             *hc.head_conv3x3_bwd(dy, x, weight, pad_h=1))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_a_train_step_runs_the_head_kernels_and_no_cudnn_head(cuda):
    """A bf16 9-plane model's train step on the card: one launch of each
    head wrapper, one head.conv_calls, and no cuDNN convolution (forward or
    backward) with the head's weight among its inputs."""
    from torch.profiler import ProfilerActivity, profile

    from cspn_monodepth_tpu_torch.ops import head_conv as hc
    from cspn_monodepth_tpu_torch.train import Trainer
    from cspn_monodepth_tpu_torch.utils import profiling

    cfg = get_config("synthetic_tiny")
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state()
    head = list(state.model.head.weight.shape)
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.random((2, cfg.data.height, cfg.data.width, 3),
                               np.float32),
             "depth": rng.uniform(0.5, 9.5, (2, cfg.data.height,
                                             cfg.data.width))
             .astype(np.float32)}
    state, _, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    before = [fn.launches for fn in hc.WRAPPERS]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        state, loss, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(hc.WRAPPERS, before)] == [1, 1]
    assert profiling.collected()["counters"]["head.conv_calls"] == 1
    events = prof.events()
    assert any("head_conv3x3_fwd" in e.name for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA)
    convs = [e for e in events if e.name.startswith("aten::cudnn_conv")
             or e.name == "aten::convolution_backward"]
    assert convs
    assert not [e for e in convs if head in e.input_shapes], head
    assert np.isfinite(float(loss))
