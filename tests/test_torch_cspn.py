"""The port's CSPN op (cspn_monodepth_tpu_torch.ops) against the JAX package.

Inputs are made with numpy from a seed and handed to both. The port's
plain loop is held to the JAX `cspn_propagate_ref` (lax.scan) and to the
JAX Pallas kernel `cspn_propagate_pallas`, which runs in interpret mode on
the CPU as tests/test_cspn_pallas.py runs it.

Tolerance: max-relative error max|a - b| / max|b| <= 1e-5. Both sides are
f32 loops of the same arithmetic and differ only in summation order;
random signed gates are expansive (T=24 outputs reach ~1e9), so an
absolute tolerance is meaningless and `8sum_abs` is the absolute-scale
control (ops/parity.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cspn_monodepth_tpu.ops.cspn_pallas import cspn_propagate_pallas
from cspn_monodepth_tpu.ops.cspn_ref import (
    cspn_propagate_ref as jax_cspn_ref,
    normalize_affinity as jax_normalize_affinity,
)
from cspn_monodepth_tpu_torch.ops import (
    NEIGHBOR_OFFSETS,
    cspn_propagate,
    cspn_propagate_ref,
    cspn_propagate_ref_nchw,
    normalize_affinity,
)
from cspn_monodepth_tpu_torch.ops import cspn_cuda

TOL = 1e-5
NORMS = ("8sum", "8sum_abs", "8sum_clamp")


def max_rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def problem(seed, b, h, w, with_sparse=True):
    """guidance (B, H, W, 8) N(0, 1), blur U(0.1, 10), ~5% anchors."""
    rng = np.random.default_rng(seed)
    guid = rng.standard_normal((b, h, w, 8)).astype(np.float32)
    blur = rng.uniform(0.1, 10.0, (b, h, w)).astype(np.float32)
    sparse = None
    if with_sparse:
        dense = rng.uniform(0.1, 10.0, (b, h, w)).astype(np.float32)
        sparse = np.where(rng.random((b, h, w)) < 0.05, dense,
                          0.0).astype(np.float32)
    return guid, blur, sparse


def port_ref(guid, blur, sparse, **kw):
    sp = None if sparse is None else torch.from_numpy(sparse)
    return cspn_propagate_ref(torch.from_numpy(guid), torch.from_numpy(blur),
                              sp, **kw).numpy()


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("hw", [(16, 24), (13, 17), (57, 76)])
@pytest.mark.parametrize("num_iters", [1, 5, 24])
def test_ref_matches_jax_ref(num_iters, hw, norm, with_sparse):
    guid, blur, sparse = problem(num_iters, 2, *hw, with_sparse)
    kw = dict(num_iters=num_iters, norm_type=norm)
    want = np.asarray(jax_cspn_ref(
        jnp.asarray(guid), jnp.asarray(blur),
        None if sparse is None else jnp.asarray(sparse), **kw))
    got = port_ref(guid, blur, sparse, **kw)
    assert max_rel(got, want) <= TOL
    if sparse is not None:       # anchors are exact, not just close
        m = sparse > 0
        np.testing.assert_array_equal(got[m], sparse[m])


@pytest.mark.parametrize("num_iters,hw,norm,with_sparse", [
    *[(t, (16, 24), n, s) for t in (1, 5, 24) for n in NORMS
      for s in (True, False)],
    (24, (13, 17), "8sum_clamp", True),
    (24, (57, 76), "8sum_clamp", True),
    (5, (57, 76), "8sum", False),
])
def test_ref_matches_jax_pallas_interpret(num_iters, hw, norm, with_sparse):
    guid, blur, sparse = problem(100 + num_iters, 1, *hw, with_sparse)
    kw = dict(num_iters=num_iters, norm_type=norm)
    want = np.asarray(cspn_propagate_pallas(
        jnp.asarray(guid), jnp.asarray(blur),
        None if sparse is None else jnp.asarray(sparse), interpret=True,
        **kw))
    got = port_ref(guid, blur, sparse, **kw)
    assert max_rel(got, want) <= TOL


@pytest.mark.parametrize("norm", NORMS)
def test_normalize_affinity_matches_jax(norm):
    guid, _, _ = problem(3, 2, 9, 11, with_sparse=False)
    guid[0, 0, 0] = 0.0          # the eps / clamp floor
    guid[0, 0, 1] *= 1e-3        # abs-sum below the clamp floor
    want_g, want_c = jax_normalize_affinity(jnp.asarray(guid), norm)
    got_g, got_c = normalize_affinity(torch.from_numpy(guid), norm)
    assert max_rel(got_g.numpy(), want_g) <= TOL
    assert max_rel(got_c.numpy(), want_c) <= TOL
    # plane-major layout, normalized over dim 1
    got_g1, got_c1 = normalize_affinity(
        torch.from_numpy(guid).permute(0, 3, 1, 2), norm, dim=1)
    np.testing.assert_array_equal(got_g1.permute(0, 2, 3, 1).numpy(),
                                  got_g.numpy())
    np.testing.assert_array_equal(got_c1[:, 0].numpy(), got_c[..., 0].numpy())


def test_normalize_affinity_rejects_unknown_norm():
    with pytest.raises(ValueError):
        normalize_affinity(torch.zeros(1, 8), "8max")


def test_neighbor_offsets_match_jax():
    from cspn_monodepth_tpu.ops.cspn_ref import NEIGHBOR_OFFSETS as jax_off
    assert NEIGHBOR_OFFSETS == jax_off


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_dispatcher_layouts_match_jax(layout, impl):
    guid, blur, sparse = problem(21, 2, 13, 17)
    kw = dict(num_iters=5, norm_type="8sum_clamp")
    want = np.asarray(jax_cspn_ref(jnp.asarray(guid), jnp.asarray(blur),
                                   jnp.asarray(sparse), **kw))
    g = torch.from_numpy(guid)
    if layout == "NCHW":
        g = g.permute(0, 3, 1, 2).contiguous()
    # (B, H, W, 1) depth maps come back with their channel dim
    got = cspn_propagate(g, torch.from_numpy(blur)[..., None],
                         torch.from_numpy(sparse)[..., None], impl=impl,
                         guidance_layout=layout, **kw)
    assert got.shape == (2, 13, 17, 1)
    assert max_rel(got[..., 0].numpy(), want) <= TOL


def test_head_slices_match_contiguous():
    """guidance and blur as channel slices of one (B, 9, H, W) head map
    (batch-strided planes, as the model passes them) give the result of
    contiguous copies."""
    rng = np.random.default_rng(5)
    heads = torch.from_numpy(
        rng.standard_normal((2, 9, 13, 17)).astype(np.float32))
    kw = dict(num_iters=5, norm_type="8sum", guidance_layout="NCHW")
    got = cspn_propagate(heads[:, 1:], heads[:, 0], None, **kw)
    want = cspn_propagate(heads[:, 1:].contiguous(),
                          heads[:, 0].contiguous(), None, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_zero_guidance_clamp_is_identity():
    """8sum_clamp at g-hat = 0 is the identity map (zero-init heads)."""
    _, blur, sparse = problem(8, 1, 13, 17)
    out = cspn_propagate_ref_nchw(
        torch.zeros(1, 8, 13, 17), torch.from_numpy(blur),
        torch.from_numpy(sparse), num_iters=24, norm_type="8sum_clamp")
    want = np.where(sparse > 0, sparse, blur)
    np.testing.assert_array_equal(out.numpy(), want)


def test_cuda_impl_on_cpu_tensor_raises():
    guid, blur, sparse = problem(1, 1, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cspn_propagate(torch.from_numpy(guid), torch.from_numpy(blur),
                       torch.from_numpy(sparse), impl="cuda")


@pytest.mark.parametrize("kw", [dict(impl="jnp"),
                                dict(guidance_layout="HWNC")])
def test_dispatcher_rejects_unknown_options(kw):
    guid, blur, _ = problem(1, 1, 8, 8, with_sparse=False)
    with pytest.raises(ValueError):
        cspn_propagate(torch.from_numpy(guid), torch.from_numpy(blur), **kw)


def test_wrapper_on_cpu_runs_plain_version_and_builds_nothing():
    """On a CPU tensor the kernel's wrapper takes its plain version: the
    kernel is neither built nor launched."""
    guid, blur, sparse = problem(2, 1, 13, 17)
    g = torch.from_numpy(guid).permute(0, 3, 1, 2).contiguous()
    before = cspn_cuda.cspn_fwd.launches
    got = cspn_cuda.cspn_fwd(g, torch.from_numpy(blur),
                             torch.from_numpy(sparse), num_iters=5,
                             norm_type="8sum")
    want = cspn_cuda.cspn_fwd_plain(g, torch.from_numpy(blur),
                                    torch.from_numpy(sparse), num_iters=5,
                                    norm_type="8sum")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cspn_cuda.cspn_fwd.launches == before
    assert not cspn_cuda._libs          # no kernel library was loaded
