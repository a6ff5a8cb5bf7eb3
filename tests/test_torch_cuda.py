"""The port's CUDA kernel on the card, against its plain PyTorch version.

These tests need an NVIDIA GPU (the hand-written kernel has no CPU mode)
and skip without one. They import no JAX, so they also run on a machine
that has PyTorch and CUDA only; there, run them without the JAX-side
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: max-relative error max|a - b| / max|b| <= 1e-5 for the kernel.
The kernel contracts to FMA and sums in its own order; random signed gates
are expansive (T=24 outputs reach ~1e9), so an absolute tolerance is
meaningless and `8sum_abs` is the absolute-scale control.
"""

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu_torch import DepthPredictor, get_config
from cspn_monodepth_tpu_torch.models import CSPNDepthNet
from cspn_monodepth_tpu_torch.ops import cspn_cuda, cspn_propagate

TOL = 1e-5
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
