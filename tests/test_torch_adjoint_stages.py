"""The plain versions of the adjoint kernels' stages (csrc/cspn_bwd.cu)
against the JAX package, on the CPU.

The adjoints K3 and K9 are composed of a gates9 stage (K3 only), the
lam sweep (`adjoint_sweep_plain`: lam^t = the forward's stencil on the
`transposed_gates` applied to lam_u = (1 - m) lam^{t+1}, every lam^{t+1}
written to an adjoint stash) and the sums pass (`adjoint_sums_plain`, the
gate sums over the forward's stash and that adjoint stash, with
`cspn_bwd_sums_plain` for K3). Inputs are made with numpy from a seed
and handed to both sides:
* the sweep's stash plane that holds lam^t (lam^0 for t = 0) against
  `jax.vjp` with respect to d^0 of JAX's `cspn_propagate_prenorm_ref` run
  for the last T - t iterations on the same gates9 and cotangent (lam is
  the unmasked adjoint, which is what that vjp gives): max-relative 1e-5;
* the sums pass, fed JAX's own stash and the sweep's lam stash, against
  JAX's interpret-mode adjoint kernels: `_cspn_pallas_bwd_impl` (K3, raw
  guidance, chain rule included) and `_cspn_prenorm_bwd_impl` (K9, the
  prenormalized contract): max-relative 1e-4, the reverse-mode
  sums of two different programs, as tests/test_torch_cspn_grad.py holds
  the whole adjoint;
* the transposed-gates stencil against the adjoint written as a gather
  over flipped offsets (bit for bit) and torch autograd of one forward
  step;
* the stage wrappers, which on CPU tensors run these plain stages and
  compose to the adjoints' own plain versions bit for bit.
Sizes as tests/test_torch_cspn_grad.py's (13x17, 57x76), T in {1, 5, 24},
all three norms, with and without sparse.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cspn_monodepth_tpu.ops.cspn_pallas import (
    _cspn_pallas_bwd_impl,
    _cspn_pallas_stash_fwd,
    _cspn_prenorm_bwd_impl,
    _cspn_prenorm_stash_fwd,
)
from cspn_monodepth_tpu.ops.cspn_ref import (
    cspn_propagate_prenorm_ref as jax_prenorm_ref,
)
from cspn_monodepth_tpu_torch.ops import cspn_cuda
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    NEIGHBOR_OFFSETS,
    _stencil,
    adjoint_sweep_plain,
    anchor,
    cspn_bwd_plain,
    cspn_bwd_sums_plain,
    cspn_fwd_stash_plain,
    cspn_prenorm_bwd_plain,
    cspn_prenorm_fwd_stash_plain,
    prenorm_gates9,
    transposed_gates,
)

SWEEP_TOL = 1e-5
GRAD_TOL = 1e-4
NORMS = ("8sum", "8sum_abs", "8sum_clamp")


def max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def problem(seed, b, h, w, norm, with_sparse=True):
    """Raw guidance (B, 8, H, W) N(0, 1) and its gates9 under `norm`, d0
    U(0.1, 10), ~10% anchors (zeros without) and a N(0, 1) cotangent."""
    rng = np.random.default_rng(seed)
    guid = rng.standard_normal((b, 8, h, w)).astype(np.float32)
    gates9 = prenorm_gates9(torch.from_numpy(guid), norm).numpy()
    d0 = rng.uniform(0.1, 10.0, (b, h, w)).astype(np.float32)
    sp = np.where(rng.random((b, h, w)) < 0.1,
                  rng.uniform(0.1, 10.0, (b, h, w)), 0.0).astype(np.float32)
    if not with_sparse:
        sp = np.zeros_like(sp)
    cot = rng.standard_normal((b, h, w)).astype(np.float32)
    return guid, gates9, d0, sp, cot


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.cache
def jax_lam(num_iters: int, with_sparse: bool):
    """d^0 -> jax.vjp of `num_iters` iterations of JAX's prenorm reference,
    jitted once per length (and shape)."""
    def lam(gates9, d0, sp, cot):
        _, vjp = jax.vjp(lambda d: jax_prenorm_ref(
            gates9, d, sp if with_sparse else None, num_iters=num_iters), d0)
        return vjp(cot)[0]
    return jax.jit(lam)


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("num_iters", [1, 5, 24])
@pytest.mark.parametrize("hw", [(13, 17), (57, 76)])
def test_sweep_planes_match_jax_vjp_of_prenorm_ref(hw, num_iters, norm,
                                                   with_sparse):
    _, gates9, d0, sp, cot = problem(1, 2, *hw, norm, with_sparse)
    lam_stash, lam0 = adjoint_sweep_plain(
        t(gates9), t(sp) if with_sparse else None, t(cot),
        num_iters=num_iters)
    assert lam_stash.shape == (2, num_iters, *hw)
    args = [jnp.asarray(a) for a in (gates9, d0, sp, cot)]
    for step in range(num_iters + 1):
        got = lam0 if step == 0 else lam_stash[:, step - 1]
        want = jax_lam(num_iters - step, with_sparse)(*args)
        assert max_rel(got, want) <= SWEEP_TOL, step
    # lam^T is the cotangent itself.
    assert torch.equal(lam_stash[:, -1], t(cot))


def jax_raw_adjoint(hw, num_iters, norm, with_sparse):
    """JAX's K2 stash (cropped to (h, w)) and K3 gradients, interpreted."""
    guid, _, d0, sp, cot = problem(2, 2, *hw, norm, with_sparse)
    _, stash = _cspn_pallas_stash_fwd(
        jnp.asarray(guid), jnp.asarray(d0), jnp.asarray(sp), num_iters,
        norm, with_sparse, True, True)
    grads = _cspn_pallas_bwd_impl(
        jnp.asarray(guid), jnp.asarray(sp), stash, jnp.asarray(cot),
        num_iters, norm, with_sparse, True, True)
    return (np.asarray(stash)[:, :, :hw[0], :hw[1]],
            [np.asarray(g) for g in grads])


SUMS_CASES = [((13, 17), 5, "8sum", True), ((13, 17), 5, "8sum_abs", True),
              ((13, 17), 5, "8sum_clamp", False),
              ((13, 17), 1, "8sum_abs", False),
              ((57, 76), 24, "8sum_clamp", True)]


@pytest.mark.parametrize("hw,num_iters,norm,with_sparse", SUMS_CASES)
def test_raw_sums_match_jax_adjoint_kernel(hw, num_iters, norm,
                                           with_sparse):
    """K3's sums pass (chain rule included) on JAX's stash and the sweep's
    lam stash against JAX's whole-plane adjoint kernel."""
    guid, gates9, _, sp, cot = problem(2, 2, *hw, norm, with_sparse)
    stash, want = jax_raw_adjoint(hw, num_iters, norm, with_sparse)
    sparse = t(sp) if with_sparse else None
    lam_stash, lam0 = adjoint_sweep_plain(t(gates9), sparse, t(cot),
                                          num_iters=num_iters)
    got = cspn_bwd_sums_plain(sparse, t(stash), lam_stash,
                              num_iters=num_iters, guidance=t(guid),
                              lam0=lam0, norm_type=norm)
    for name, g, w in zip(("d_guidance", "d_blur", "d_sparse"), got, want):
        assert g.shape == w.shape, name
        assert max_rel(g, w) <= GRAD_TOL, name
    if not with_sparse:
        assert not got[2].any()


def jax_prenorm_adjoint(hw, num_iters, norm, with_sparse):
    """JAX's K8 stash (cropped to (h, w)) and K9 gradients, interpreted."""
    _, gates9, d0, sp, cot = problem(3, 2, *hw, norm, with_sparse)
    args = (jnp.asarray(gates9), jnp.asarray(d0), jnp.asarray(sp))
    _, stash = _cspn_prenorm_stash_fwd(*args, num_iters, with_sparse, True)
    grads = _cspn_prenorm_bwd_impl(args[0], args[2], stash,
                                   jnp.asarray(cot), num_iters, with_sparse,
                                   True)
    return (np.asarray(stash)[..., :hw[0], :hw[1]],
            [np.asarray(g) for g in grads])


@pytest.mark.parametrize("hw,num_iters,norm,with_sparse", SUMS_CASES)
def test_prenorm_sums_match_jax_prenorm_adjoint_kernel(hw, num_iters, norm,
                                                       with_sparse):
    """K6's and K9's stages on JAX's stash against JAX's slab adjoint
    kernel: d_gates9 and the sparse sums from the sums pass, lam^0 from the
    sweep."""
    _, gates9, _, sp, cot = problem(3, 2, *hw, norm, with_sparse)
    stash, want = jax_prenorm_adjoint(hw, num_iters, norm, with_sparse)
    sparse = t(sp) if with_sparse else None
    lam_stash, lam0 = adjoint_sweep_plain(t(gates9), sparse, t(cot),
                                          num_iters=num_iters)
    d_gates9, d_sparse = cspn_bwd_sums_plain(sparse, t(stash), lam_stash,
                                             num_iters=num_iters)
    for name, g, w in zip(("d_gates9", "lam0", "d_sparse"),
                          (d_gates9, lam0, d_sparse), want):
        assert g.shape == w.shape, name
        assert max_rel(g, w) <= GRAD_TOL, name


def flipped_gather(gates9, lam_u):
    """The adjoint step as a gather over flipped offsets, the form of the
    fused adjoint: g0 lam_u + sum_k g_{k'}(j + off_k) lam_u(j + off_k),
    off_{k'} = -off_k, gates and lam_u zero outside the image."""
    h, w = lam_u.shape[-2:]
    gpad = F.pad(gates9[:, 1:], (1, 1, 1, 1))
    upad = F.pad(lam_u, (1, 1, 1, 1))
    new = gates9[:, 0] * lam_u
    for dy, dx in NEIGHBOR_OFFSETS:
        win = (slice(None), slice(1 + dy, 1 + dy + h),
               slice(1 + dx, 1 + dx + w))
        flip = NEIGHBOR_OFFSETS.index((-dy, -dx))
        new = new + gpad[:, flip][win] * upad[win]
    return new


@pytest.mark.parametrize("b,h,w", [(2, 13, 17), (1, 5, 3), (1, 1, 1),
                                   (3, 2, 9)])
def test_transposed_stencil_is_the_adjoint_of_the_forward_step(b, h, w):
    rng = np.random.default_rng(4)
    gates9 = t(rng.standard_normal((b, 9, h, w)).astype(np.float32))
    lam_u = t(rng.standard_normal((b, h, w)).astype(np.float32))
    gt = transposed_gates(gates9)
    got = _stencil(gt[:, 0], gt[:, 1:], lam_u)
    assert torch.equal(got, flipped_gather(gates9, lam_u))
    d = torch.zeros(b, h, w, requires_grad=True)
    step = _stencil(gates9[:, 0], gates9[:, 1:], d)
    (vjp,) = torch.autograd.grad(step, d, lam_u)
    torch.testing.assert_close(got, vjp, rtol=1e-6, atol=1e-6)
    # A transposed gate that would read from outside the image is 0.
    assert not gt[:, 1:4, 0].any() and not gt[:, 6:9, -1].any()


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm", NORMS)
def test_stage_wrappers_compose_to_the_adjoints_on_cpu(norm, with_sparse):
    """On CPU tensors each stage wrapper runs its plain stage: gates9,
    sweep and sums compose to K3's plain version, sweep and sums
    to K9's, bit for bit, as the C entries compose the stage kernels."""
    guid, _, d0, sp, cot = problem(5, 2, 13, 17, norm, with_sparse)
    guid, d0, cot = t(guid), t(d0), t(cot)
    sparse = t(sp) if with_sparse else None
    kw = dict(num_iters=5)
    _, stash = cspn_fwd_stash_plain(guid, d0, sparse, norm_type=norm, **kw)
    gates9 = cspn_cuda.cspn_gates9(guid, norm_type=norm)
    assert torch.equal(gates9, prenorm_gates9(guid, norm))
    lam_stash, lam0 = cspn_cuda.cspn_bwd_sweep(gates9, sparse, cot, **kw)
    got = cspn_cuda.cspn_bwd_sums(sparse, stash, lam_stash, guidance=guid,
                                  lam0=lam0, norm_type=norm, **kw)
    want = cspn_bwd_plain(guid, sparse, stash, cot, norm_type=norm, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    _, tstash = cspn_prenorm_fwd_stash_plain(gates9, anchor(d0, sparse),
                                             sparse, **kw)
    d_gates9, d_sparse = cspn_cuda.cspn_bwd_sums(
        sparse, tstash, cspn_cuda.cspn_bwd_sweep(gates9, sparse, cot,
                                                 **kw)[0], **kw)
    want = cspn_prenorm_bwd_plain(gates9, sparse, tstash, cot, **kw)
    assert torch.equal(d_gates9, want[0]) and torch.equal(d_sparse, want[2])
    assert torch.equal(lam0, want[1])


def test_zero_iterations_pass_the_cotangent_through():
    """T = 0: an empty adjoint stash, lam^0 = grad_out, no gate sums."""
    _, gates9, _, sp, cot = problem(6, 1, 8, 10, "8sum")
    lam_stash, lam0 = adjoint_sweep_plain(t(gates9), t(sp), t(cot),
                                          num_iters=0)
    assert lam_stash.shape == (1, 0, 8, 10) and torch.equal(lam0, t(cot))
    d_gates9, d_sparse = cspn_bwd_sums_plain(t(sp), lam_stash, lam_stash,
                                             num_iters=0)
    assert d_gates9.shape == (1, 9, 8, 10)
    assert not d_gates9.any() and not d_sparse.any()


def test_sums_wrapper_wants_guidance_lam0_and_norm_together():
    _, _, _, sp, cot = problem(7, 1, 6, 7, "8sum")
    stash = torch.zeros(1, 2, 6, 7)
    with pytest.raises(ValueError, match="go together"):
        cspn_cuda.cspn_bwd_sums(t(sp), stash, stash, num_iters=2,
                                lam0=t(cot))
