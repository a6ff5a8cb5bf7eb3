"""The port's CSPN training path (stash forward, adjoint, autograd Function)
against the JAX package.

Inputs are made with numpy from a seed and handed to both sides:
* `cspn_fwd_stash_plain` against the JAX stash kernel
  `_cspn_pallas_stash_fwd` (K2) in interpret mode, its (hp, wp) padding
  cropped;
* `cspn_bwd_plain` against the JAX adjoint kernel `_cspn_pallas_bwd_impl`
  (K3) in interpret mode, on the JAX stash;
* the port's `CSPNFunction` (through `cspn_propagate`, CPU tensors, so its
  plain K2/K3 versions) against `jax.vjp` of the JAX reference
  `cspn_propagate_ref` and of `cspn_propagate_pallas` (interpret mode,
  which runs the JAX K2 and K3): all three gradients.

Tolerances, max-relative max|a - b| / max|b|: 1e-5 for the forward and the
stash (f32 loops of the same arithmetic in another order), 1e-4 for
gradients (the reverse-mode sums of two different programs, as the JAX
package's own adjoint tests use). Random signed gates are expansive, so
errors are judged relative to the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_monodepth_tpu.ops.cspn_pallas import (
    _cspn_pallas_bwd_impl,
    _cspn_pallas_stash_fwd,
    cspn_propagate_pallas,
)
from cspn_monodepth_tpu.ops.cspn_ref import cspn_propagate_ref as jax_ref
from cspn_monodepth_tpu_torch.ops import cspn_cuda, cspn_propagate
from cspn_monodepth_tpu_torch.ops.cspn import CSPNFunction
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    cspn_bwd_plain,
    cspn_fwd_stash_plain,
)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
NORMS = ("8sum", "8sum_abs", "8sum_clamp")


def max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def problem(seed, b, h, w, with_sparse=True, zero_guidance=False):
    """Plane-major guidance (B, 8, H, W) N(0, 1) (or zero), blur
    U(0.1, 10), ~10% anchors (zeros without), cotangent N(0, 1)."""
    rng = np.random.default_rng(seed)
    guid = rng.standard_normal((b, 8, h, w)).astype(np.float32)
    if zero_guidance:
        guid = np.zeros_like(guid)
    blur = rng.uniform(0.1, 10.0, (b, h, w)).astype(np.float32)
    sparse = np.zeros((b, h, w), np.float32)
    if with_sparse:
        sparse = np.where(rng.random((b, h, w)) < 0.1,
                          rng.uniform(0.1, 10.0, (b, h, w)),
                          0.0).astype(np.float32)
    cot = rng.standard_normal((b, h, w)).astype(np.float32)
    return guid, blur, sparse, cot


def t(a):
    return torch.from_numpy(a)


def port_grads(guid, blur, sparse, cot, with_sparse, **kw):
    """Gradients of <cspn_propagate(...), cot> through CSPNFunction (the
    CPU tensors take the kernels' plain versions)."""
    g, b = t(guid).requires_grad_(), t(blur).requires_grad_()
    s = t(sparse).requires_grad_() if with_sparse else None
    out = cspn_propagate(g, b, s, guidance_layout="NCHW", **kw)
    inputs = [g, b] + ([s] if with_sparse else [])
    grads = torch.autograd.grad((out * t(cot)).sum(), inputs)
    return [x.numpy() for x in grads]


def jax_grads(fn, guid, blur, sparse, cot, with_sparse, **kw):
    """jax.vjp of fn with NHWC guidance; guidance gradient back to NCHW."""
    g = jnp.moveaxis(jnp.asarray(guid), 1, -1)
    args = (g, jnp.asarray(blur)) + ((jnp.asarray(sparse),)
                                     if with_sparse else ())
    _, vjp = jax.vjp(lambda *a: fn(*a, **kw), *args)
    grads = vjp(jnp.asarray(cot))
    return [np.moveaxis(np.asarray(grads[0]), -1, 1)] + [
        np.asarray(x) for x in grads[1:]]


@pytest.mark.parametrize("hw,num_iters,norm,with_sparse", [
    ((13, 17), 5, "8sum", True),
    ((13, 17), 1, "8sum_abs", False),
    ((18, 22), 24, "8sum_clamp", True),
])
def test_stash_forward_matches_jax_stash_kernel(hw, num_iters, norm,
                                                with_sparse):
    guid, blur, sparse, _ = problem(1, 2, *hw, with_sparse)
    out_j, stash_j = _cspn_pallas_stash_fwd(
        jnp.asarray(guid), jnp.asarray(blur), jnp.asarray(sparse),
        num_iters, norm, with_sparse, True, True)
    out, stash = cspn_fwd_stash_plain(
        t(guid), t(blur), t(sparse) if with_sparse else None,
        num_iters=num_iters, norm_type=norm)
    stash_j = np.asarray(stash_j)[:, :, :hw[0], :hw[1]]
    assert stash.shape == stash_j.shape == (2, num_iters, *hw)
    assert max_rel(out, out_j) <= FWD_TOL
    for i in range(num_iters):
        assert max_rel(stash[:, i], stash_j[:, i]) <= FWD_TOL, i
    # d^0 is the anchored blur; the output is the plain forward's.
    np.testing.assert_array_equal(
        stash[:, 0].numpy(), np.where(sparse > 0, sparse, blur))
    np.testing.assert_array_equal(out.numpy(), cspn_cuda.cspn_fwd_plain(
        t(guid), t(blur), t(sparse) if with_sparse else None,
        num_iters=num_iters, norm_type=norm).numpy())


@pytest.mark.parametrize("hw,num_iters,norm,with_sparse,zero", [
    ((13, 17), 5, "8sum", True, False),
    ((13, 17), 5, "8sum_abs", True, False),
    ((18, 22), 24, "8sum_clamp", False, False),
    ((13, 17), 5, "8sum_clamp", True, True),
])
def test_adjoint_matches_jax_adjoint_kernel(hw, num_iters, norm, with_sparse,
                                            zero):
    """cspn_bwd_plain on the JAX kernel's own stash against the JAX K3."""
    guid, blur, sparse, cot = problem(2, 2, *hw, with_sparse, zero)
    _, stash_j = _cspn_pallas_stash_fwd(
        jnp.asarray(guid), jnp.asarray(blur), jnp.asarray(sparse),
        num_iters, norm, with_sparse, True, True)
    want = _cspn_pallas_bwd_impl(
        jnp.asarray(guid), jnp.asarray(sparse), stash_j, jnp.asarray(cot),
        num_iters, norm, with_sparse, True, True)
    stash = t(np.ascontiguousarray(
        np.asarray(stash_j)[:, :, :hw[0], :hw[1]]))
    got = cspn_bwd_plain(t(guid), t(sparse) if with_sparse else None, stash,
                         t(cot), num_iters=num_iters, norm_type=norm)
    for a, w in zip(got, want):
        a, w = a.numpy(), np.asarray(w)
        assert a.shape == w.shape and np.isfinite(a).all()
        if np.abs(w).max() == 0:        # d_sparse without anchors; zero
            assert np.abs(a).max() == 0     # guidance with 8sum_abs
        else:
            assert max_rel(a, w) <= GRAD_TOL


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("num_iters", [1, 5, 24])
@pytest.mark.parametrize("hw", [(13, 17), (18, 22)])
def test_function_gradients_match_jax_vjp_of_reference(hw, num_iters, norm,
                                                       with_sparse):
    guid, blur, sparse, cot = problem(3, 2, *hw, with_sparse)
    kw = dict(num_iters=num_iters, norm_type=norm)
    got = port_grads(guid, blur, sparse, cot, with_sparse, **kw)
    want = jax_grads(jax_ref, guid, blur, sparse, cot, with_sparse, **kw)
    assert len(got) == len(want) == 2 + with_sparse
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert max_rel(a, w) <= GRAD_TOL


@pytest.mark.parametrize("hw,num_iters,norm,with_sparse", [
    ((13, 17), 5, "8sum", True),
    ((13, 17), 9, "8sum_clamp", True),
    ((13, 17), 1, "8sum_abs", False),
])
def test_function_gradients_match_jax_pallas_vjp(hw, num_iters, norm,
                                                 with_sparse):
    """Against jax.vjp of the JAX custom-VJP op, which runs its stash
    forward and hand adjoint (K2, K3) in interpret mode."""
    guid, blur, sparse, cot = problem(4, 1, *hw, with_sparse)
    kw = dict(num_iters=num_iters, norm_type=norm, interpret=True)
    got = port_grads(guid, blur, sparse, cot, with_sparse,
                     num_iters=num_iters, norm_type=norm)
    want = jax_grads(cspn_propagate_pallas, guid, blur, sparse, cot,
                     with_sparse, **kw)
    for a, w in zip(got, want):
        assert max_rel(a, w) <= GRAD_TOL


@pytest.mark.parametrize("norm", NORMS)
def test_zero_guidance_gradients_are_finite_and_match(norm):
    """A fresh model's head is zero: all gates 0, s = 0 below the floor
    (inactive), sign(0) = 0. No NaN, and the gradients of the JAX training
    path (its K2 + K3). For 8sum_abs these are 0; jax.vjp of the JAX
    reference gives ~1e9 there instead, because jnp.abs's derivative at 0
    is +1 where the adjoint kernel takes sign(0) = 0: both are
    subgradients of |g| at 0, and the port follows the kernel."""
    guid, blur, sparse, cot = problem(5, 1, 9, 11, zero_guidance=True)
    kw = dict(num_iters=3, norm_type=norm)
    got = port_grads(guid, blur, sparse, cot, True, **kw)
    want = jax_grads(cspn_propagate_pallas, guid, blur, sparse, cot, True,
                     interpret=True, **kw)
    for a, w in zip(got, want):
        assert np.isfinite(a).all()
        if np.abs(w).max() == 0:
            assert np.abs(a).max() == 0
        else:
            assert max_rel(a, w) <= GRAD_TOL
    if norm != "8sum_abs":          # the reference agrees where |g| is smooth
        ref = jax_grads(jax_ref, guid, blur, sparse, cot, True, **kw)
        for a, w in zip(got, ref):
            assert max_rel(a, w) <= GRAD_TOL


def test_no_sparse_gives_no_sparse_gradient_and_zero_plane():
    guid, blur, _, cot = problem(6, 1, 9, 11, with_sparse=False)
    kw = dict(num_iters=3, norm_type="8sum")
    out, stash = cspn_fwd_stash_plain(t(guid), t(blur), None, **kw)
    assert stash.shape == (1, 3, 9, 11)
    d_sparse = cspn_bwd_plain(t(guid), None, stash, t(cot), **kw)[2]
    assert torch.equal(d_sparse, torch.zeros_like(d_sparse))
    g = t(guid).requires_grad_()
    out = CSPNFunction.apply(g, t(blur), None, 3, "8sum")
    out.sum().backward()
    assert g.grad is not None and g.grad.shape == g.shape


def test_zero_iterations():
    """T = 0: the output is the anchored blur; d_blur and d_sparse split
    the cotangent by the mask and the guidance gets none."""
    guid, blur, sparse, cot = problem(7, 1, 8, 10)
    kw = dict(num_iters=0, norm_type="8sum_clamp")
    out, stash = cspn_fwd_stash_plain(t(guid), t(blur), t(sparse), **kw)
    assert stash.shape == (1, 0, 8, 10)
    np.testing.assert_array_equal(out.numpy(),
                                  np.where(sparse > 0, sparse, blur))
    d_guid, d_blur, d_sparse = cspn_bwd_plain(t(guid), t(sparse), stash,
                                              t(cot), **kw)
    assert torch.equal(d_guid, torch.zeros_like(d_guid))
    np.testing.assert_array_equal(d_blur.numpy(),
                                  np.where(sparse > 0, 0.0, cot))
    np.testing.assert_array_equal(d_sparse.numpy(),
                                  np.where(sparse > 0, cot, 0.0))


def test_dispatcher_uses_the_function_only_when_a_gradient_is_wanted(
        monkeypatch):
    """No gradient wanted: K1 alone (no stash); wanted: K2 + K3."""
    calls = []
    for name in ("cspn_fwd", "cspn_fwd_stash", "cspn_bwd"):
        real = getattr(cspn_cuda, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(f"cspn_monodepth_tpu_torch.ops.cspn.{name}", spy)
    guid, blur, sparse, _ = problem(8, 1, 10, 12)
    kw = dict(num_iters=4, norm_type="8sum_clamp", guidance_layout="NCHW")
    g = t(guid).requires_grad_()
    with torch.no_grad():
        cspn_propagate(g, t(blur), t(sparse), **kw)
    cspn_propagate(t(guid), t(blur), t(sparse), **kw)
    assert calls == ["cspn_fwd", "cspn_fwd"]
    cspn_propagate(g, t(blur), t(sparse), **kw).sum().backward()
    assert calls[2:] == ["cspn_fwd_stash", "cspn_bwd"]
    calls.clear()
    cspn_propagate(g, t(blur), t(sparse), impl="torch", **kw).sum().backward()
    assert calls == []
