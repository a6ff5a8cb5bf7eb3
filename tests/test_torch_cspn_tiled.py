"""The port's CSPN op (`cspn_propagate(impl="auto")`: K1-K3 and
`CSPNFunction`, on JAX's contract: raw guidance, blur and sparse in, the
normalization and d^0's anchor inside the op) against the JAX package's
H-tiled op, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs its Pallas kernels in interpret mode, as tests/test_cspn_pallas.py
does, with small tiles and halos so that it really runs several tiles and
rounds; the port's CPU tensors take the kernels' plain versions.
* `prenorm_gates9` against `_prenorm_gates9` and its `jax.vjp` (random
  guidance, away from zeros): max-relative 1e-6, the same f32 formulas;
* `cspn_propagate_prenorm_ref` against JAX's: 1e-5;
* `cspn_propagate(..., impl="auto")` against
  `cspn_propagate_pallas_tiled(..., interpret=True)`: rtol 1e-5 relative to
  max|want| (tests/test_cspn_pallas.py:_assert_close); with a gradient
  wanted, `CSPNFunction`'s value and its three gradients for a random
  cotangent against JAX's tiled VJP (its stash forward and tiled adjoint,
  with `pick_tile_h_bwd` at 16 rows) under the three norms, with and
  without sparse, at T = 1, 10 and 24: 1e-5 and rtol 1e-4;
* the Function saves JAX's residuals (the guidance, sparse and the stash),
  no gates9, and sits right on the inputs: no plain op runs around it;
* zero guidance against the JAX whole-plane VJP (its K2 and K3): the JAX
  tiled VJP takes d|g|/dg = +1 at g = 0 under `8sum_abs` (`jax.vjp` of
  `_prenorm_gates9`), the JAX K3 and the port sign(0) = 0;
* the gates9 contract's plain adjoint (`cspn_prenorm_bwd_plain`, K9's)
  against `jax.vjp` of JAX's prenorm reference;
* every size, NYU's, KITTI's and others on both sides of JAX's VMEM
  budget, takes the one path: K1 without a gradient, K2 then K3 with one.
The port's round count (4 iterations per round) is its own: T = 10 leaves
a remainder round, and H = 50, 37, 13 are not tile multiples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cspn_monodepth_tpu.ops.cspn_pallas as jax_cp
from cspn_monodepth_tpu.ops.cspn_pallas import (
    _prenorm_gates9,
    cspn_propagate_pallas,
    cspn_propagate_pallas_tiled,
)
from cspn_monodepth_tpu.ops.cspn_ref import (
    cspn_propagate_prenorm_ref as jax_prenorm_ref,
)
from cspn_monodepth_tpu_torch.ops import cspn as port_cspn
from cspn_monodepth_tpu_torch.ops import cspn_cuda, cspn_propagate
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    anchor,
    cspn_prenorm_bwd_plain,
    cspn_prenorm_fwd_plain,
    cspn_prenorm_fwd_stash_plain,
    cspn_propagate_prenorm_ref,
    cspn_propagate_ref_nchw,
    prenorm_gates9,
)

PRENORM_TOL = 1e-6
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
NORMS = ("8sum", "8sum_abs", "8sum_clamp")


def max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_close(got, want, rtol):
    """tests/test_cspn_pallas.py:_assert_close: atol scaled to the field's
    magnitude (random signed gates are expansive)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


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


# ------------------------------------------------------------ prenorm
@pytest.mark.parametrize("norm", NORMS)
def test_prenorm_gates9_and_its_backward_match_jax(norm):
    guid, _, _, _ = problem(0, 2, 9, 11)
    cot = np.random.default_rng(1).standard_normal(
        (2, 9, 9, 11)).astype(np.float32)
    want, vjp = jax.vjp(lambda g: _prenorm_gates9(g, norm, True),
                        jnp.asarray(guid))
    (want_grad,) = vjp(jnp.asarray(cot))
    g = t(guid).requires_grad_()
    got = prenorm_gates9(g, norm)
    (got_grad,) = torch.autograd.grad((got * t(cot)).sum(), g)
    assert got.shape == (2, 9, 9, 11)
    assert max_rel(got.detach(), want) <= PRENORM_TOL
    assert max_rel(got_grad, want_grad) <= PRENORM_TOL
    # The centre gate is 1 - sum of the eight: each row of 9 sums to 1.
    np.testing.assert_allclose(got.detach().sum(1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("num_iters,with_sparse", [(1, True), (7, True),
                                                   (7, False)])
def test_prenorm_propagation_matches_jax(num_iters, with_sparse):
    guid, blur, sparse, _ = problem(2, 2, 13, 17, with_sparse)
    gates9 = np.array(_prenorm_gates9(jnp.asarray(guid), "8sum", True))
    sp = sparse if with_sparse else None
    want = jax_prenorm_ref(jnp.asarray(gates9), jnp.asarray(blur),
                           None if sp is None else jnp.asarray(sp),
                           num_iters=num_iters)
    got = cspn_propagate_prenorm_ref(t(gates9), t(blur),
                                     None if sp is None else t(sp),
                                     num_iters=num_iters)
    assert max_rel(got, want) <= FWD_TOL
    # d^0 is not anchored on entry: an unanchored d^0 changes iteration 1.
    if with_sparse:
        anchored = cspn_propagate_prenorm_ref(
            t(gates9), anchor(t(blur), t(sp)), t(sp), num_iters=num_iters)
        assert not torch.equal(got, anchored)


# ------------------------------------------------------------ tiled forward
def jax_tiled(guid, blur, sparse, with_sparse, **kw):
    return np.asarray(cspn_propagate_pallas_tiled(
        jnp.asarray(guid), jnp.asarray(blur),
        jnp.asarray(sparse) if with_sparse else None,
        interpret=True, guidance_layout="NCHW", **kw))


def port_tiled(guid, blur, sparse, with_sparse, **kw):
    return cspn_propagate(t(guid), t(blur),
                          t(sparse) if with_sparse else None,
                          impl="auto", guidance_layout="NCHW", **kw)


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("num_iters", [1, 5, 24])
def test_tiled_forward_matches_jax_tiled_kernel(num_iters, norm,
                                                with_sparse):
    """37x48 on the JAX side in 16-row tiles with a 4-deep halo: 3 tiles,
    up to 6 rounds."""
    guid, blur, sparse, _ = problem(3, 2, 37, 48, with_sparse)
    kw = dict(num_iters=num_iters, norm_type=norm)
    before = [w.launches for w in cspn_cuda.WRAPPERS]
    got = port_tiled(guid, blur, sparse, with_sparse, **kw)
    want = jax_tiled(guid, blur, sparse, with_sparse, halo_k=4, tile_h=16,
                     **kw)
    assert got.shape == want.shape == (2, 37, 48)
    assert_close(got, want, FWD_TOL)
    if with_sparse:
        m = sparse > 0
        np.testing.assert_array_equal(got.numpy()[m], sparse[m])
    assert [w.launches for w in cspn_cuda.WRAPPERS] == before
    assert not cspn_cuda._libs          # the CPU builds no kernel


@pytest.mark.parametrize("hw,tile_h,k", [((13, 17), 8, 4), ((50, 40), 16, 3)])
def test_tiled_forward_odd_sizes(hw, tile_h, k):
    guid, blur, sparse, _ = problem(4, 1, *hw)
    kw = dict(num_iters=10, norm_type="8sum_clamp")
    assert_close(port_tiled(guid, blur, sparse, True, **kw),
                 jax_tiled(guid, blur, sparse, True, halo_k=k,
                           tile_h=tile_h, **kw), FWD_TOL)


# ------------------------------------------------------------ gradients
def port_vjp(guid, blur, sparse, cot, with_sparse, impl, **kw):
    """The op's output and the gradients of all its inputs."""
    g, b = t(guid).requires_grad_(), t(blur).requires_grad_()
    s = t(sparse).requires_grad_() if with_sparse else None
    out = cspn_propagate(g, b, s, impl=impl, guidance_layout="NCHW", **kw)
    inputs = [g, b] + ([s] if with_sparse else [])
    grads = torch.autograd.grad((out * t(cot)).sum(), inputs)
    return out.detach().numpy(), [x.numpy() for x in grads]


def port_grads(*args, **kw):
    return port_vjp(*args, **kw)[1]


def jax_vjp(fn, guid, blur, sparse, cot, with_sparse, **kw):
    args = (jnp.asarray(guid), jnp.asarray(blur)) + (
        (jnp.asarray(sparse),) if with_sparse else ())
    out, vjp = jax.vjp(lambda *a: fn(*a, guidance_layout="NCHW",
                                     interpret=True, **kw), *args)
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(cot))]


def jax_grads(*args, **kw):
    return jax_vjp(*args, **kw)[1]


# (T, norm, sparse): T = 1 one round everywhere; T = 10 JAX's rounds 4, 4,
# 2 (halo 3 clamped up to 4) and the port's remainder round; T = 24 six
# rounds on both sides.
TILED_GRAD_CASES = [(num_iters, norm, with_sparse)
                    for num_iters in (1, 10, 24) for norm in NORMS
                    for with_sparse in (True, False)]


@pytest.mark.parametrize("num_iters,norm,with_sparse", TILED_GRAD_CASES)
def test_tiled_gradients_match_jax_tiled_vjp(monkeypatch, num_iters, norm,
                                             with_sparse):
    """CSPNFunction (K2, K3 on the raw inputs) against
    `_cspn_pallas_tiled` and its jax.vjp on 50x40: JAX in 16-row tiles (4
    tiles, H padded to 64); the value and the three gradients."""
    monkeypatch.setattr(jax_cp, "pick_tile_h_bwd", lambda h, w, k, **kw: 16)
    guid, blur, sparse, cot = problem(6, 2, 50, 40, with_sparse)
    kw = dict(num_iters=num_iters, norm_type=norm)
    out, got = port_vjp(guid, blur, sparse, cot, with_sparse, "auto", **kw)
    want_out, want = jax_vjp(cspn_propagate_pallas_tiled, guid, blur, sparse,
                             cot, with_sparse, halo_k=3, **kw)
    assert_close(out, want_out, FWD_TOL)
    assert len(got) == len(want) == 2 + with_sparse
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert_close(a, w, GRAD_TOL)


@pytest.mark.parametrize("with_sparse", [True, False])
def test_function_saves_jax_residuals_and_no_gates9(with_sparse):
    """JAX's `_tiled_fwd` keeps (guidance, blur, sparse, stash): the port's
    Function keeps the guidance, sparse and the stash, no (B, 9, H, W)
    gates9, and takes the inputs themselves (no plain normalization or
    anchor between them and it)."""
    guid, blur, sparse, _ = problem(11, 2, 13, 17, with_sparse)
    g, b = t(guid).requires_grad_(), t(blur).requires_grad_()
    s = t(sparse).requires_grad_() if with_sparse else None
    out = cspn_propagate(g, b, s, num_iters=5, norm_type="8sum_clamp",
                         impl="auto", guidance_layout="NCHW")
    assert type(out.grad_fn).__name__ == "CSPNFunctionBackward"
    saved = [tuple(x.shape) for x in out.grad_fn.saved_tensors
             if x is not None]
    want = [(2, 8, 13, 17), (2, 5, 13, 17)] + (
        [(2, 13, 17)] if with_sparse else [])
    assert sorted(saved) == sorted(want)
    assert not any(len(x) == 4 and x[1] == 9 for x in saved)
    leaves = [f for f, _ in out.grad_fn.next_functions if f is not None]
    assert len(leaves) == 2 + with_sparse
    assert all(type(f).__name__ == "AccumulateGrad" for f in leaves)


@pytest.mark.parametrize("norm", NORMS)
def test_zero_guidance_gradients_match_jax_whole_plane_vjp(norm):
    """A fresh model's head is zero. The port's K3 follows JAX's K3
    (sign(0) = 0), not JAX's tiled VJP, which gives ~1e9 under 8sum_abs
    there (d|g|/dg = +1 at 0)."""
    guid, blur, sparse, cot = problem(7, 1, 9, 11, zero_guidance=True)
    kw = dict(num_iters=3, norm_type=norm)
    got = port_grads(guid, blur, sparse, cot, True, "auto", **kw)
    want = jax_grads(cspn_propagate_pallas, guid, blur, sparse, cot, True,
                     **kw)
    plain = port_grads(guid, blur, sparse, cot, True, "torch", **kw)
    for a, w, p in zip(got, want, plain):
        assert np.isfinite(a).all()
        if np.abs(w).max() == 0:
            assert np.abs(a).max() == np.abs(p).max() == 0
        else:
            assert max_rel(a, w) <= GRAD_TOL
            assert max_rel(a, p) <= GRAD_TOL


def test_zero_iterations():
    """T = 0: the output is the anchored blur; d_blur and d_sparse split
    the cotangent by the mask; the guidance gets none."""
    guid, blur, sparse, cot = problem(8, 1, 8, 10)
    g, b, s = (t(x).requires_grad_() for x in (guid, blur, sparse))
    out = cspn_propagate(g, b, s, num_iters=0, norm_type="8sum_clamp",
                         impl="auto", guidance_layout="NCHW")
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.where(sparse > 0, sparse, blur))
    d_g, d_b, d_s = torch.autograd.grad((out * t(cot)).sum(), (g, b, s))
    assert torch.equal(d_g, torch.zeros_like(d_g))
    np.testing.assert_array_equal(d_b.numpy(), np.where(sparse > 0, 0, cot))
    np.testing.assert_array_equal(d_s.numpy(), np.where(sparse > 0, cot, 0))


# ------------------------------------------------------------ gates9 contract
@pytest.mark.parametrize("num_iters,with_sparse", [(5, True), (10, False)])
def test_tiled_bwd_plain_matches_jax_vjp_of_prenorm_ref(num_iters,
                                                        with_sparse):
    """The gates9 contract's plain adjoint (K9's): d_gates9, lam0 (dL/dd^0,
    no mask) and the per-iteration anchors' sum against jax.vjp of JAX's
    prenorm reference in gates9, d0, sparse."""
    guid, blur, sparse, cot = problem(9, 2, 13, 17, with_sparse)
    gates9 = np.array(_prenorm_gates9(jnp.asarray(guid), "8sum_clamp",
                                        True))
    d0 = np.where(sparse > 0, sparse, blur).astype(np.float32)
    sp = sparse if with_sparse else None
    args = [jnp.asarray(gates9), jnp.asarray(d0)] + (
        [jnp.asarray(sp)] if with_sparse else [])
    _, vjp = jax.vjp(lambda *a: jax_prenorm_ref(*a, num_iters=num_iters),
                     *args)
    want = vjp(jnp.asarray(cot))
    out, stash = cspn_prenorm_fwd_stash_plain(
        t(gates9), t(d0), None if sp is None else t(sp), num_iters=num_iters)
    assert stash.shape == (2, num_iters, 13, 17)
    np.testing.assert_array_equal(stash[:, 0].numpy(), d0)
    torch.testing.assert_close(out, cspn_prenorm_fwd_plain(
        t(gates9), t(d0), None if sp is None else t(sp),
        num_iters=num_iters), rtol=0, atol=0)
    got = cspn_prenorm_bwd_plain(t(gates9), None if sp is None else t(sp),
                                 stash, t(cot), num_iters=num_iters)
    assert got[0].shape == (2, 9, 13, 17)
    for a, w in zip(got, want):
        assert max_rel(a, w) <= GRAD_TOL
    if not with_sparse:
        assert torch.equal(got[2], torch.zeros_like(got[2]))


# ------------------------------------------------------------ one path
@pytest.mark.parametrize("hw", [(352, 1216), (228, 304), (13, 17),
                                (448, 448), (449, 449), (240, 1216)])
def test_every_size_takes_the_one_path(hw, monkeypatch):
    """NYU's and KITTI's sizes and others on both sides of JAX's VMEM
    budget (352x1216 and 240x1216 beyond it, where JAX takes its H-tiled
    kernels): without a gradient the operator cspn_fwd, with one the stash
    forward then the adjoint; the output is the plain loop's bit for
    bit."""
    calls = []
    for name in ("cspn_fwd", "cspn_fwd_stash", "cspn_bwd"):
        real = getattr(port_cspn, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(port_cspn, name, spy)
    guid, blur, sparse, _ = problem(10, 1, *hw)
    kw = dict(num_iters=2, norm_type="8sum_clamp")
    want = cspn_propagate_ref_nchw(t(guid), t(blur), t(sparse), **kw)
    got = cspn_propagate(t(guid), t(blur), t(sparse), guidance_layout="NCHW",
                         **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    g = t(guid).requires_grad_()
    out = cspn_propagate(g, t(blur), t(sparse), guidance_layout="NCHW", **kw)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    out.sum().backward()
    assert calls == ["cspn_fwd", "cspn_fwd_stash", "cspn_bwd"]
