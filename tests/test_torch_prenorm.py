"""The plain versions of the spatial path's slab kernels K7-K9 and
`PrenormCSPNFunction` against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both sides, at a real
slab height (96 rows, KITTI's 88-row shard plus 2 x 4 halo rows) and a
narrow width (40). Gates are prenormalized random guidance under each norm;
d^0 is left unanchored, so that an anchor on entry (which the contract
forbids) would show.
* `cspn_prenorm_fwd_plain` (K7) against `_cspn_prenorm_fwd_impl`,
  `cspn_prenorm_fwd_stash_plain` (K8) against `_cspn_prenorm_stash_fwd`
  (the JAX stash, padded to 8-row and 128-lane multiples, cropped to
  (h, w)) and `cspn_prenorm_bwd_plain` (K9) against
  `_cspn_prenorm_bwd_impl`, all interpreted, for r in {1, 3, 4} iterations
  (the rounds of halo_k = 4 and their remainders), sparse on and off: the
  outputs max-relative 1e-5, the adjoint's 1e-4;
* `cspn_propagate_prenorm` (PrenormCSPNFunction, K8 forward and K9
  backward, on the CPU their plain versions) against
  `cspn_propagate_prenorm_ref` and its `jax.vjp`: forward 1e-5, the three
  gradients 1e-4, as ops/parity.py measures them (max|a - b| / max|b|);
  with d^0 anchored on load (`anchor_d0`, the slab route's first round)
  against the JAX reference on the anchored d^0 (`jnp.where`), its
  gradients through that anchor included;
* the slab route's normalization, `cspn_normalize` (`Gates9Function`:
  `cspn_gates9` forward, `cspn_gates9_bwd` backward, on the CPU their
  plain versions) against `_prenorm_gates9` and its `jax.vjp` away from
  zero guidance: 1e-6, the same f32 formulas; at zero guidance the
  gradient takes sign(0) = 0 under 8sum_abs (the JAX kernels' and the
  port's adjoints do; `jax.vjp` of `_prenorm_gates9` takes d|g|/dg = +1).
"""

import functools

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu_torch.ops import cspn_cuda
from cspn_monodepth_tpu_torch.ops.cspn import (
    cspn_normalize,
    cspn_propagate_prenorm,
)
from cspn_monodepth_tpu_torch.ops.cspn_cuda import (
    cspn_prenorm_bwd,
    cspn_prenorm_fwd,
    cspn_prenorm_fwd_stash,
)
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    cspn_prenorm_bwd_plain,
    cspn_prenorm_fwd_plain,
    cspn_prenorm_fwd_stash_plain,
    prenorm_gates9,
)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
PRENORM_TOL = 1e-6
NORMS = ("8sum", "8sum_abs", "8sum_clamp")
SLAB = (2, 96, 40)
# (iterations of the round, sparse map, norm of the gates)
CASES = [(1, True, "8sum_clamp"), (3, True, "8sum"), (4, True, "8sum_abs"),
         (1, False, "8sum_abs"), (3, False, "8sum_clamp"),
         (4, False, "8sum")]
IDS = [f"r{r}-{'sparse' if s else 'dense'}-{n}" for r, s, n in CASES]


def max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def problem(seed, b, h, w, norm, with_sparse):
    """gates9 of N(0, 1) guidance under `norm`, d0 U(0.1, 10) (not
    anchored), ~10% anchors (zeros without) and a N(0, 1) cotangent."""
    rng = np.random.default_rng(seed)
    guid = torch.from_numpy(rng.standard_normal((b, 8, h, w)).astype(
        np.float32))
    gates9 = prenorm_gates9(guid, norm).numpy()
    d0 = rng.uniform(0.1, 10.0, (b, h, w)).astype(np.float32)
    sp = np.where(rng.random((b, h, w)) < 0.1,
                  rng.uniform(0.1, 10.0, (b, h, w)), 0.0).astype(np.float32)
    if not with_sparse:
        sp = np.zeros_like(sp)
    cot = rng.standard_normal((b, h, w)).astype(np.float32)
    return gates9, d0, sp, cot


@functools.cache
def jax_kernels(case):
    """JAX's K7, K8 and K9 in interpret mode on the case's slab."""
    import jax.numpy as jnp

    from cspn_monodepth_tpu.ops import cspn_pallas as jax_cp

    r, with_sparse, norm = case
    b, h, w = SLAB
    gates9, d0, sp, cot = problem(r, b, h, w, norm, with_sparse)
    args = (jnp.asarray(gates9), jnp.asarray(d0), jnp.asarray(sp))
    out7 = jax_cp._cspn_prenorm_fwd_impl(*args, r, with_sparse, True)
    out8, stash = jax_cp._cspn_prenorm_stash_fwd(*args, r, with_sparse,
                                                 True)
    grads = jax_cp._cspn_prenorm_bwd_impl(args[0], args[2], stash,
                                          jnp.asarray(cot), r, with_sparse,
                                          True)
    return dict(out7=np.asarray(out7), out8=np.asarray(out8),
                stash=np.asarray(stash)[..., :h, :w],
                grads=[np.asarray(g) for g in grads])


def port_inputs(case):
    r, with_sparse, norm = case
    gates9, d0, sp, cot = problem(r, *SLAB, norm, with_sparse)
    return (torch.from_numpy(gates9), torch.from_numpy(d0),
            torch.from_numpy(sp) if with_sparse else None,
            torch.from_numpy(cot))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k7_plain_matches_jax(case):
    gates9, d0, sp, _ = port_inputs(case)
    r = case[0]
    got = cspn_prenorm_fwd_plain(gates9, d0, sp, num_iters=r)
    assert max_rel(got, jax_kernels(case)["out7"]) <= FWD_TOL
    # On a CPU tensor the wrapper runs the plain version.
    assert torch.equal(cspn_prenorm_fwd(gates9, d0, sp, num_iters=r), got)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k8_plain_and_its_stash_match_jax(case):
    gates9, d0, sp, _ = port_inputs(case)
    r = case[0]
    out, stash = cspn_prenorm_fwd_stash_plain(gates9, d0, sp, num_iters=r)
    want = jax_kernels(case)
    assert stash.shape == (*SLAB[:1], r, *SLAB[1:])
    assert max_rel(out, want["out8"]) <= FWD_TOL
    assert max_rel(stash, want["stash"]) <= FWD_TOL
    # d^0 is the stash's first plane, as given: no anchor on entry.
    assert torch.equal(stash[:, 0], d0)
    got_out, got_stash = cspn_prenorm_fwd_stash(gates9, d0, sp,
                                                num_iters=r)
    assert torch.equal(got_out, out) and torch.equal(got_stash, stash)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k9_plain_matches_jax(case):
    gates9, d0, sp, cot = port_inputs(case)
    r = case[0]
    _, stash = cspn_prenorm_fwd_stash_plain(gates9, d0, sp, num_iters=r)
    got = cspn_prenorm_bwd_plain(gates9, sp, stash, cot, num_iters=r)
    want = jax_kernels(case)["grads"]
    for name, g, w in zip(("d_gates9", "lam0", "d_sparse"), got, want):
        assert max_rel(g, w) <= GRAD_TOL, name
    if sp is None:
        assert not got[2].any()
    wrapped = cspn_prenorm_bwd(gates9, sp, stash, cot, num_iters=r)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm", ["8sum", "8sum_abs", "8sum_clamp"])
def test_prenorm_function_gradients_match_jax_vjp(norm, with_sparse):
    """PrenormCSPNFunction over T = 6 iterations against jax.vjp of the
    JAX prenorm reference, all three inputs, and at B = 1."""
    import jax
    import jax.numpy as jnp

    from cspn_monodepth_tpu.ops.cspn_ref import (
        cspn_propagate_prenorm_ref as jax_prenorm_ref,
    )

    for b in (2, 1):
        gates9, d0, sp, cot = problem(7, b, 24, 40, norm, True)
        sp_j = jnp.asarray(sp) if with_sparse else None

        def ref(g, d, s):
            return jax_prenorm_ref(g, d, s if with_sparse else None,
                                   num_iters=6)

        want, vjp = jax.vjp(ref, jnp.asarray(gates9), jnp.asarray(d0),
                            jnp.asarray(sp))
        want_grads = vjp(jnp.asarray(cot))
        inputs = [torch.from_numpy(gates9).requires_grad_(),
                  torch.from_numpy(d0).requires_grad_()]
        if sp_j is not None:
            inputs.append(torch.from_numpy(sp).requires_grad_())
        out = cspn_propagate_prenorm(*inputs[:2],
                                     inputs[2] if sp_j is not None else None,
                                     num_iters=6)
        assert out.grad_fn is not None
        assert type(out.grad_fn).__name__ == "PrenormCSPNFunctionBackward"
        assert max_rel(out.detach(), want) <= FWD_TOL
        grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                    inputs)
        for g, w in zip(grads, want_grads):
            assert max_rel(g, w) <= GRAD_TOL


def test_prenorm_routes():
    """Without a gradient "auto" is K7 (its plain version here); "torch"
    is the plain loop under autograd; anything else raises."""
    gates9, d0, sp, _ = port_inputs(CASES[2])
    with torch.no_grad():
        auto = cspn_propagate_prenorm(gates9, d0, sp, num_iters=4)
    assert torch.equal(auto, cspn_prenorm_fwd_plain(gates9, d0, sp,
                                                    num_iters=4))
    g = gates9.clone().requires_grad_()
    plain = cspn_propagate_prenorm(g, d0, sp, num_iters=4, impl="torch")
    assert type(plain.grad_fn).__name__ != "PrenormCSPNFunctionBackward"
    assert torch.allclose(plain, auto, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown impl"):
        cspn_propagate_prenorm(gates9, d0, sp, num_iters=4, impl="cuda")


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm", NORMS)
def test_anchor_on_load_matches_jax_vjp_of_the_anchored_reference(
        norm, with_sparse):
    """`cspn_propagate_prenorm(anchor_d0=True)` (K8/K9 with d^0 anchored
    on load; their plain versions here) against jax.vjp of the JAX prenorm
    reference on jnp.where(sparse > 0, sparse, d0): the value and the
    gradients of gates9, d0 and sparse through the anchor."""
    import jax
    import jax.numpy as jnp

    from cspn_monodepth_tpu.ops.cspn_ref import (
        cspn_propagate_prenorm_ref as jax_prenorm_ref,
    )

    gates9, d0, sp, cot = problem(13, 2, 24, 40, norm, True)

    def ref(g, d, s):
        if not with_sparse:
            return jax_prenorm_ref(g, d, None, num_iters=4)
        return jax_prenorm_ref(g, jnp.where(s > 0, s, d), s, num_iters=4)

    want, vjp = jax.vjp(ref, jnp.asarray(gates9), jnp.asarray(d0),
                        jnp.asarray(sp))
    want_grads = vjp(jnp.asarray(cot))
    inputs = [torch.from_numpy(gates9).requires_grad_(),
              torch.from_numpy(d0).requires_grad_()]
    if with_sparse:
        inputs.append(torch.from_numpy(sp).requires_grad_())
    out = cspn_propagate_prenorm(*inputs[:2],
                                 inputs[2] if with_sparse else None,
                                 num_iters=4, anchor_d0=True)
    assert type(out.grad_fn).__name__ == "PrenormCSPNFunctionBackward"
    assert max_rel(out.detach(), want) <= FWD_TOL
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), inputs)
    for g, w in zip(grads, want_grads):
        assert max_rel(g, w) <= GRAD_TOL
    with torch.no_grad():
        plain = cspn_propagate_prenorm(*inputs[:2],
                                       inputs[2] if with_sparse else None,
                                       num_iters=4, anchor_d0=True,
                                       impl="torch")
    assert max_rel(plain, want) <= FWD_TOL


def guidance(seed, shape, zero=False):
    """N(0, 1) guidance kept 0.1 away from zero (|g|'s kink), or zeros."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    g = np.where(g < 0, g - 0.1, g + 0.1).astype(np.float32)
    return np.zeros_like(g) if zero else g


@pytest.mark.parametrize("norm", NORMS)
def test_gates9_function_matches_jax_prenorm_vjp(norm):
    """cspn_normalize with a gradient wanted is Gates9Function; its value
    and the guidance's gradient against `_prenorm_gates9` and its jax.vjp;
    no wrapper launches a kernel on the CPU."""
    import jax
    import jax.numpy as jnp

    from cspn_monodepth_tpu.ops.cspn_pallas import _prenorm_gates9

    guid = guidance(21, (2, 8, 11, 13))
    cot = np.random.default_rng(22).standard_normal(
        (2, 9, 11, 13)).astype(np.float32)
    want, vjp = jax.vjp(lambda g: _prenorm_gates9(g, norm, True),
                        jnp.asarray(guid))
    (want_grad,) = vjp(jnp.asarray(cot))
    before = [w.launches for w in cspn_cuda.WRAPPERS]
    g = torch.from_numpy(guid).requires_grad_()
    got = cspn_normalize(g, norm_type=norm)
    assert type(got.grad_fn).__name__ == "Gates9FunctionBackward"
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), g)
    assert got.shape == (2, 9, 11, 13)
    assert max_rel(got.detach(), want) <= PRENORM_TOL
    assert max_rel(got_grad, want_grad) <= PRENORM_TOL
    with torch.no_grad():
        assert torch.equal(cspn_normalize(g, norm_type=norm), got.detach())
    assert torch.equal(cspn_normalize(g, norm_type=norm, impl="torch"),
                       got)
    assert [w.launches for w in cspn_cuda.WRAPPERS] == before


@pytest.mark.parametrize("norm", NORMS)
def test_gates9_function_takes_sign_zero_at_zero_guidance(norm):
    """A fresh model's head is zero. Under 8sum_abs the guidance's gradient
    there is 0 (sign(0) = 0, as the JAX adjoint kernels and K3 take it);
    jax.vjp of `_prenorm_gates9` takes d|g|/dg = +1 and gives ~1e8. The
    signed norms agree with jax.vjp: below the floor only the guidance's
    own gates carry a gradient."""
    import jax
    import jax.numpy as jnp

    from cspn_monodepth_tpu.ops.cspn_pallas import _prenorm_gates9

    guid = guidance(23, (1, 8, 9, 11), zero=True)
    cot = np.random.default_rng(24).standard_normal(
        (1, 9, 9, 11)).astype(np.float32)
    g = torch.from_numpy(guid).requires_grad_()
    got = cspn_normalize(g, norm_type=norm)
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), g)
    _, vjp = jax.vjp(lambda x: _prenorm_gates9(x, norm, True),
                     jnp.asarray(guid))
    (want_grad,) = vjp(jnp.asarray(cot))
    assert torch.isfinite(got_grad).all()
    assert torch.equal(
        got_grad, cspn_cuda.cspn_gates9_bwd(g.detach(), torch.from_numpy(cot),
                                            norm_type=norm))
    if norm == "8sum_abs":
        assert not got_grad.any()
        assert np.abs(np.asarray(want_grad)).max() > 1e6
    else:
        assert max_rel(got_grad, want_grad) <= PRENORM_TOL
