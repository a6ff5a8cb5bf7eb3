"""The port's parity checks (ops/parity.py) beside the JAX package's
(cspn_monodepth_tpu/ops/parity.py) at small shapes, B=1, T=4.

On the CPU the port's kernels run their plain versions, as
JAX's Pallas kernels run in interpret mode there; on the card the same
checks hold the CUDA kernels (chip_smoke.py's `parity` line). Both draw
their inputs from np.random.default_rng(0) in the same order, so the
plain references' output magnitudes agree: held to 1e-5 relative (float32
sums of T=4 iterations in two frameworks).
"""

import pytest

from cspn_monodepth_tpu.ops import parity as jax_parity
from cspn_monodepth_tpu.ops.cspn_pallas import cspn_propagate_pallas_tiled
from cspn_monodepth_tpu_torch.ops import cspn as port_cspn
from cspn_monodepth_tpu_torch.ops import parity

SHAPE = dict(batch=1, h=16, w=32, num_iters=4)
# KITTI's aspect, where JAX takes its H-tiled op.
WIDE = dict(batch=1, h=16, w=96, num_iters=4)
MAG_RTOL = 1e-5


def within_tolerances(res: dict) -> bool:
    return (res["fwd_maxrel"] < parity.FWD_TOL
            and res["grad_maxrel"] < parity.GRAD_TOL)


def test_tolerances_are_jax_s():
    assert (parity.FWD_TOL, parity.GRAD_TOL) == (jax_parity.FWD_TOL,
                                                 jax_parity.GRAD_TOL)


@pytest.mark.parametrize("shape,op", [(SHAPE, None),
                                      (WIDE, cspn_propagate_pallas_tiled)],
                         ids=["auto", "wide"])
def test_cspn_parity_check_passes_beside_jax(shape, op):
    """The port's one path (K1; K2/K3) at 16x32 beside JAX's default op,
    and at a wide plane beside JAX's cspn_propagate_pallas_tiled."""
    got = parity.cspn_parity_check(device="cpu", **shape)
    want = jax_parity.cspn_parity_check(op=op, **shape)
    assert list(got) == list(want) == ["8sum_clamp", "8sum", "8sum_abs"]
    for norm in got:
        assert set(got[norm]) == set(want[norm])
        assert within_tolerances(got[norm]) and within_tolerances(
            want[norm])
        assert got[norm]["out_mag"] == pytest.approx(
            want[norm]["out_mag"], rel=MAG_RTOL)


def test_prenorm_parity_check_passes_beside_jax():
    got = parity.prenorm_parity_check(device="cpu", **SHAPE)
    want = jax_parity.prenorm_parity_check(**SHAPE)
    assert set(got) == set(want)
    assert within_tolerances(got) and within_tolerances(want)
    assert got["out_mag"] == pytest.approx(want["out_mag"], rel=MAG_RTOL)


def test_cspn_parity_check_fails_a_wrong_forward(monkeypatch):
    """The check bites: a K1 1e-4 off its plain loop fails it."""
    real = port_cspn.cspn_fwd

    def off(*args, **kw):
        return real(*args, **kw) * (1.0 + 1e-4)

    monkeypatch.setattr(port_cspn, "cspn_fwd", off)
    with pytest.raises(AssertionError, match="forward max-rel"):
        parity.cspn_parity_check(norms=("8sum_abs",), impl="auto",
                                 device="cpu", **SHAPE)
