"""The port's parity checks (ops/parity.py) beside the JAX package's
(cspn_monodepth_tpu/ops/parity.py) at one small shape, B=1, 16x32, T=4.

On the CPU the port's kernel routes run the kernels' plain versions, as
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
MAG_RTOL = 1e-5


def within_tolerances(res: dict) -> bool:
    return (res["fwd_maxrel"] < parity.FWD_TOL
            and res["grad_maxrel"] < parity.GRAD_TOL)


def test_tolerances_are_jax_s():
    assert (parity.FWD_TOL, parity.GRAD_TOL) == (jax_parity.FWD_TOL,
                                                 jax_parity.GRAD_TOL)


@pytest.mark.parametrize("impl", ["auto", "cuda_tiled"])
def test_cspn_parity_check_passes_beside_jax(impl):
    """"auto" takes the whole-plane route at 16x32 (K1; K2/K3), as JAX's
    default op; "cuda_tiled" the H-tiled one (K4; K5/K6), as JAX's
    cspn_propagate_pallas_tiled."""
    assert port_cspn.route(SHAPE["h"], SHAPE["w"]) == "cuda"
    got = parity.cspn_parity_check(impl=impl, device="cpu", **SHAPE)
    op = cspn_propagate_pallas_tiled if impl == "cuda_tiled" else None
    want = jax_parity.cspn_parity_check(op=op, **SHAPE)
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
    """The check bites: a K1 route 1e-4 off its plain loop fails it."""
    real = port_cspn.cspn_fwd

    def off(*args, **kw):
        return real(*args, **kw) * (1.0 + 1e-4)

    monkeypatch.setattr(port_cspn, "cspn_fwd", off)
    with pytest.raises(AssertionError, match="forward max-rel"):
        parity.cspn_parity_check(norms=("8sum_abs",), impl="auto",
                                 device="cpu", **SHAPE)


def test_routing_check_passes():
    checks = parity.routing_check()
    assert checks and all(checks.values())
    assert {"nyu_whole_plane", "kitti_tiled", "kitti_slab_prenorm",
            "nyu_slab_prenorm"} <= set(checks)


def test_routing_check_fails_a_moved_route(monkeypatch):
    monkeypatch.setattr(parity, "route", lambda h, w: "cuda")
    with pytest.raises(AssertionError, match="kitti_tiled"):
        parity.routing_check()

