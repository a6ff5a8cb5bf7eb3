"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU (the hand-written kernel has no CPU mode)
and skip without one. They import no JAX, so they also run on a machine
that has PyTorch and CUDA only; there, run them without the JAX-side
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: max-relative error max|a - b| / max|b| <= 1e-5 for each kernel
(K1 forward, K2 stash forward, K3 adjoint; K4-K6, the H-tiled route's,
the same functions through the same C entries; K7-K9, the prenormalized
gates9 contract on the spatial path's halo'd slabs, d^0 as given or
anchored on load; the normalization's pair cspn_gates9 / cspn_gates9_bwd;
the adjoints' stage kernels against their plain stages) and each output;
two runs of K3, K6 and K9 agree bit for bit, and so do the forward
kernels under every tile geometry of their launch plan
(ops/cspn_cuda.py:fwd_plan). The
kernels contract to FMA and sum in their own order; random signed gates
are expansive (T=24 outputs reach ~1e9), so an absolute tolerance is
meaningless and `8sum_abs` is the absolute-scale control. Gradients
through the autograd Function against torch autograd of the plain loop:
<= 1e-4, the reverse-mode sums of two different programs.
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
@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_dispatcher_sends_cuda_tensors_to_the_kernel(cuda, impl):
    guid, blur, sparse = problem(4, 1, 20, 30)
    kw = dict(num_iters=6, norm_type="8sum_clamp", guidance_layout="NCHW")
    want = cspn_propagate(guid, blur, sparse, impl="torch", **kw)
    before = cspn_cuda.cspn_fwd.launches
    got = cspn_propagate(*to((guid, blur, sparse), cuda), impl=impl, **kw)
    assert cspn_cuda.cspn_fwd.launches == before + 1
    assert max_rel(got, want) <= TOL


@pytest.mark.cuda
def test_small_model_on_card_matches_cpu(cuda):
    """The serving path of a small f32 model: the kernel on the card, the
    plain loop on the CPU, the same weights and requests."""
    cfg = get_config("synthetic_tiny").override(**{"model.dtype": "float32"})
    model = CSPNDepthNet.from_config(
        cfg.model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():                 # non-zero heads: CSPN not identity
        model.head.weight.normal_(0.0, 0.05,
                                  generator=torch.Generator().manual_seed(1))
        model.head.bias.fill_(0.5)
    h, w = cfg.data.height, cfg.data.width
    rng = np.random.default_rng(0)
    rgb = rng.random((2, h, w, 3), dtype=np.float32)
    sparse = np.where(rng.random((2, h, w)) < 0.01,
                      rng.uniform(0.5, 9.5, (2, h, w)), 0.0).astype(np.float32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = cspn_cuda.cspn_fwd.launches
        got = DepthPredictor(model, h, w, device=cuda).predict_batch(rgb,
                                                                     sparse)
        assert cspn_cuda.cspn_fwd.launches == before + 1
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want = DepthPredictor(model, h, w, device="cpu").predict_batch(rgb, sparse)
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


def tiled_launches():
    return (cspn_cuda.cspn_tiled_fwd.launches,
            cspn_cuda.cspn_tiled_fwd_stash.launches,
            cspn_cuda.cspn_tiled_bwd.launches)


def plain_cuda_calls():
    return prenorm_gates9.cuda_calls, anchor.cuda_calls


@pytest.mark.cuda
@pytest.mark.parametrize("num_iters,hw,norm,with_sparse", TILED_CASES)
def test_tiled_kernels_match_plain(cuda, num_iters, hw, norm, with_sparse):
    """K4 (forward), K5 (out and every stash plane) and K6 (d_guidance,
    d_blur, d_sparse) on the raw inputs against their plain versions; K5's
    out is K4's bit for bit, and so is the gates9 contract's on
    cspn_gates9's planes with d^0 anchored on load (K7's entry); anchors
    exact."""
    guid, blur, sparse = problem(21, 2, *hw, with_sparse)
    cot = torch.from_numpy(np.random.default_rng(22).standard_normal(
        blur.shape).astype(np.float32))
    kw = dict(num_iters=num_iters, norm_type=norm)
    want = cspn_cuda.cspn_tiled_fwd_plain(guid, blur, sparse, **kw)
    want_out, want_stash = cspn_cuda.cspn_tiled_fwd_stash_plain(
        guid, blur, sparse, **kw)
    want_grads = cspn_cuda.cspn_tiled_bwd_plain(guid, sparse, want_stash,
                                                cot, **kw)
    g, d, s, c = to((guid, blur, sparse, cot), cuda)
    before = tiled_launches()
    got = cspn_cuda.cspn_tiled_fwd(g, d, s, **kw)
    out, stash = cspn_cuda.cspn_tiled_fwd_stash(g, d, s, **kw)
    grads = cspn_cuda.cspn_tiled_bwd(g, s, stash, c, **kw)
    on_gates9 = cspn_cuda.cspn_prenorm_fwd(
        cspn_cuda.cspn_gates9(g, norm_type=norm), d, s, num_iters=num_iters,
        anchor_d0=True)
    torch.cuda.synchronize()
    assert tiled_launches() == tuple(n + 1 for n in before)
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
@pytest.mark.parametrize("norm", ["8sum", "8sum_abs", "8sum_clamp"])
def test_tiled_route_matches_whole_plane_route(cuda, norm):
    """The same function by two routes on the card: K4 against K1 on the
    raw guidance, one C entry, bit for bit."""
    guid, blur, sparse = to(problem(23, 2, 70, 90), cuda)
    kw = dict(num_iters=24, norm_type=norm, guidance_layout="NCHW")
    tiled = cspn_propagate(guid, blur, sparse, impl="cuda_tiled", **kw)
    whole = cspn_propagate(guid, blur, sparse, impl="cuda", **kw)
    assert max_rel(tiled, whole) <= TOL
    torch.testing.assert_close(tiled, whole, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_sparse", [True, False])
def test_tiled_function_matches_torch_autograd(cuda, with_sparse):
    """Gradients of every input through TiledCSPNFunction (K5, K6; the
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

    before, plain = tiled_launches(), plain_cuda_calls()
    got = grads(cuda, "cuda_tiled")
    assert tiled_launches() == (before[0], before[1] + 1, before[2] + 1)
    assert plain_cuda_calls() == plain
    want = grads("cpu", "torch")
    for a, w in zip(got, want):
        assert max_rel(a, w) <= GRAD_TOL


@pytest.mark.cuda
def test_auto_sends_kitti_images_to_the_tiled_kernels(cuda):
    guid, blur, sparse = to(problem(9, 1, 352, 1216), cuda)
    before = (cspn_cuda.cspn_fwd.launches, cspn_cuda.cspn_tiled_fwd.launches)
    cspn_propagate(guid, blur, sparse, num_iters=2, norm_type="8sum_clamp",
                   guidance_layout="NCHW")
    assert (cspn_cuda.cspn_fwd.launches,
            cspn_cuda.cspn_tiled_fwd.launches) == (before[0], before[1] + 1)


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
    return tuple(w.launches for w in cspn_cuda.STAGE_WRAPPERS)


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
    """No atomics: two runs of K3, of K6 and of K9 on the same inputs agree
    bit for bit."""
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
                lambda: cspn_cuda.cspn_tiled_bwd(guid, sparse, stash, cot,
                                                 norm_type="8sum", **kw),
                lambda: cspn_cuda.cspn_prenorm_bwd(gates9, sparse, pstash,
                                                   cot, anchor_d0=True,
                                                   **kw)):
        first, second = run(), run()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["raw", "prenorm", "tiled"])
@pytest.mark.parametrize("w", [53, 56])
def test_every_geometry_gives_the_same_bits(cuda, route, w):
    """The forward round under every tile geometry of the launch plan
    (ops/cspn_cuda.py:fwd_plan), at a W that is not a multiple of 4 and
    one that is: the outputs bit for bit the same, the stash entries'
    outputs the plain entries', the stashes bit for bit the same and
    within TOL of the plain stash, and each output within TOL of the plain
    version."""
    guid, blur, sparse = to(problem(11, 5, 37, w), cuda)
    t = 17
    if route == "raw":
        kw = dict(num_iters=t, norm_type="8sum_clamp")
        args = (guid, blur, sparse)
        fwd, stash = cspn_cuda.cspn_fwd, cspn_cuda.cspn_fwd_stash
        want, want_stash = cspn_cuda.cspn_fwd_stash_plain(*args, **kw)
    elif route == "tiled":
        kw = dict(num_iters=t, norm_type="8sum_clamp")
        args = (guid, blur, sparse)
        fwd, stash = cspn_cuda.cspn_tiled_fwd, cspn_cuda.cspn_tiled_fwd_stash
        want, want_stash = cspn_cuda.cspn_tiled_fwd_stash_plain(*args, **kw)
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
    wrappers: K1, K4, the normalization and the gates9 contract (K7's
    entry) launch once a call, bit for bit the wrapper's output;
    torch.library.opcheck holds the fake and the real alike."""
    ops = torch.ops.cspn_monodepth_tpu_torch
    guid, blur, sparse = to(problem(12, 2, 40, 56, with_sparse), cuda)
    before = cspn_cuda.cspn_fwd.launches
    got = ops.cspn_fwd(guid, blur, sparse, 7, "8sum_clamp")
    assert cspn_cuda.cspn_fwd.launches == before + 1
    assert torch.equal(got, cspn_cuda.cspn_fwd(
        guid, blur, sparse, num_iters=7, norm_type="8sum_clamp"))
    before = cspn_cuda.cspn_tiled_fwd.launches
    got = ops.cspn_tiled_fwd_raw(guid, blur, sparse, 7, "8sum_clamp")
    assert cspn_cuda.cspn_tiled_fwd.launches == before + 1
    assert torch.equal(got, cspn_cuda.cspn_tiled_fwd(
        guid, blur, sparse, num_iters=7, norm_type="8sum_clamp"))
    before = cspn_cuda.cspn_gates9.launches
    gates9 = ops.cspn_gates9(guid, "8sum_clamp")
    assert cspn_cuda.cspn_gates9.launches == before + 1
    assert torch.equal(gates9, cspn_cuda.cspn_gates9(guid,
                                                     norm_type="8sum_clamp"))
    d0 = anchor(blur, sparse)
    before = cspn_cuda.cspn_prenorm_fwd.launches
    got = ops.cspn_tiled_fwd(gates9, d0, sparse, 7)
    assert cspn_cuda.cspn_prenorm_fwd.launches == before + 1
    assert torch.equal(got, cspn_cuda.cspn_prenorm_fwd(gates9, d0, sparse,
                                                       num_iters=7))
    torch.library.opcheck(ops.cspn_fwd.default,
                          (guid, blur, sparse, 3, "8sum"))
    torch.library.opcheck(ops.cspn_tiled_fwd_raw.default,
                          (guid, blur, sparse, 3, "8sum"))
    torch.library.opcheck(ops.cspn_gates9.default, (guid, "8sum_abs"))
    torch.library.opcheck(ops.cspn_tiled_fwd.default, (gates9, d0, sparse, 3))


@pytest.mark.cuda
def test_program_exported_on_the_card_equals_predict_batch(cuda, tmp_path):
    """export_program on the card, then load_program: the same output as
    predict_batch (cuDNN's TF32 off in both), one K1 launch a call; the
    program refuses the CPU."""
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
