"""The port's profiling and debug utilities (utils/profiling.py,
utils/debug.py), mirroring the JAX package's tests/test_utils.py on the
CPU."""

import os

import pytest
import torch

from cspn_monodepth_tpu_torch.utils.debug import checkify_step, enable_debug
from cspn_monodepth_tpu_torch.utils.profiling import (
    HBM_BYTES_PER_S,
    StepTimer,
    kernel_roofline,
    marginal_chain,
    trace,
)


def test_step_timer_discards_warmup():
    t = StepTimer(warmup=2)
    for _ in range(5):
        with t:
            pass
    assert len(t.times) == 3
    assert t.mean() >= 0.0


def test_kernel_roofline_estimate():
    r = kernel_roofline(8, 228, 304, device_kind="NVIDIA H100 80GB HBM3")
    assert r["bytes"] == 4 * 8 * 228 * 304 * 11
    assert r["sol_seconds"] == r["bytes"] / HBM_BYTES_PER_S["H100 80GB HBM3"]
    assert r["hbm_gbps"] == 3350.0
    assert 0 < r["sol_seconds"] < 1e-3


def test_kernel_roofline_refuses_an_unknown_card():
    """No default rate: JAX's 819 GB/s default is a TPU v5e's."""
    with pytest.raises(ValueError, match="no device memory rate"):
        kernel_roofline(8, 228, 304, device_kind="TPU v5 lite")


def test_checkify_catches_nan():
    checked = checkify_step(torch.log)
    err, out = checked(torch.tensor([-1.0]))
    assert torch.isnan(out).all()
    assert "aten.log" in err.get()
    with pytest.raises(FloatingPointError, match="NaN in the output of "
                                                 "aten.log"):
        err.throw()

    err, out = checked(torch.tensor([1.0]))
    assert err.get() is None
    err.throw()  # no error


def test_checkify_names_the_first_op_and_division_by_zero():
    def step(x):
        y = x * 2.0
        return (y / x.sum()).exp()

    err, _ = checkify_step(step)(torch.zeros(3))
    assert err.get() == "NaN in the output of aten.div.Tensor"
    err, _ = checkify_step(lambda x: 1.0 / x)(torch.zeros(2))
    assert err.get().startswith("inf in the output of aten.")


def test_checkify_ignores_uninitialized_memory():
    def step(x):
        buf = torch.empty(64)
        buf.fill_(1.0)
        return x + buf.sum()

    err, _ = checkify_step(step)(torch.ones(2))
    assert err.get() is None


def test_enable_debug_sets_and_restores_flags():
    flags = ("benchmark", "deterministic", "allow_tf32")
    saved = ({f: getattr(torch.backends.cudnn, f) for f in flags},
             torch.backends.cuda.matmul.allow_tf32,
             torch.is_anomaly_enabled())
    try:
        enable_debug(nans=True, disable_opts=True)
        assert torch.is_anomaly_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        for f, v in saved[0].items():
            setattr(torch.backends.cudnn, f, v)
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.autograd.set_detect_anomaly(saved[2])


def test_profiler_trace_writes(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    found = []
    for _, _, files in os.walk(logdir):
        found += files
    assert found, "profiler produced no files"
    assert any(f.endswith(".pt.trace.json") for f in found)


def test_marginal_chain_positive_on_a_cpu_matmul_chain():
    a = torch.randn(96, 96) / 96 ** 0.5

    def step(c, p):
        return torch.tanh(c @ p)

    step_s, dispatch_s = marginal_chain(step, torch.randn(96, 96), a, n=20)
    assert step_s > 0 and dispatch_s >= 0
