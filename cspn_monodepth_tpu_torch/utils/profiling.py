"""Tracing and timing (the counterpart of cspn_monodepth_tpu/utils/profiling.py).

* `trace(logdir)`: `torch.profiler` over the host and, where the process
  has a card, the CUDA device; writes a trace that TensorBoard's profiler
  plugin and Chrome's trace viewer read, with every kernel by name (the
  CSPN kernels included).
* `StepTimer`: a wall-clock timer of steps that drops the warm-up steps and
  synchronizes the card at entry and exit, for steady-state step times.
* `marginal_chain`: the marginal time of one step of a serially dependent
  chain, the method the bench tools share.
* `kernel_roofline`: the least time of the CSPN forward on this card (it is
  bound by its bytes: bytes over the device memory's rate), to set beside
  measured times.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block's host and device activity into `logdir`."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates steady-state step times, discarding warmup steps. Entry
    and exit synchronize the current CUDA device when the process uses one,
    so a step's time is its device work's, not its enqueue's."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._n = 0
        self._t0 = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def _read_back(carry) -> float:
    """One scalar of the carry's first tensor, which waits for the chain."""
    return float(tree_leaves(carry)[0].reshape(-1)[:1].sum().item())


def marginal_chain(fn, carry, params=None, n=10, reps=2, max_retries=3):
    """Marginal per-step seconds of a `carry, params -> carry` function.

    Two chains of n and 5n serially dependent eager calls, each closed by
    reading one scalar back to the host; the step is (t_5n - t_n) / (4n)
    with the minimum over `reps` runs of each chain. Differencing cancels
    the fixed cost of a chain (the first launch, the read-back). PyTorch
    runs eagerly: there is no lax.scan to compile the chain into one
    program, so the host's launches of every step are part of what is
    timed. A non-positive difference is a MEASUREMENT FAILURE: retried with
    more repetitions, then raised, never clamped (a clamp would print an
    absurd rate).

    Returns (step_seconds, dispatch_seconds).
    """
    def chain(length):
        c = carry
        for _ in range(length):
            c = fn(c, params)
        _read_back(c)

    def run(length, r):
        chain(length)                       # warm
        best = float("inf")
        for _ in range(r):
            t0 = time.perf_counter()
            chain(length)
            best = min(best, time.perf_counter() - t0)
        return best

    t_short = t_long = 0.0
    for _attempt in range(max_retries):
        t_short, t_long = run(n, reps), run(5 * n, reps)
        if t_long > t_short:
            step = (t_long - t_short) / (4 * n)
            return step, max(t_short - n * step, 0.0)
        reps += 2
    raise RuntimeError(
        f"marginal-chain timing failed: t_5n={t_long:.4f}s <= "
        f"t_n={t_short:.4f}s after {max_retries} attempts - launch "
        f"latency noise exceeds the chain signal; increase n")


# Device memory rate in bytes/s by device name (torch.cuda.get_device_name),
# from NVIDIA's data sheet: the H100 SXM's HBM3 at its full 700 W limit.
HBM_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12}


def kernel_roofline(batch: int, h: int, w: int, device_kind: str | None = None
                    ) -> dict[str, float]:
    """Speed-of-light for the CSPN forward (K1): one read of the guidance
    (8 planes), blur and sparse and one write of the output, independent of
    the iteration count, over the device memory's rate. device_kind is the
    card's name (default: the current CUDA device's); a card not in
    HBM_BYTES_PER_S raises ValueError."""
    if device_kind is None:
        device_kind = torch.cuda.get_device_name()
    rate = next((v for k, v in HBM_BYTES_PER_S.items() if k in device_kind),
                None)
    if rate is None:
        raise ValueError(f"no device memory rate for {device_kind!r}; "
                         f"known: {sorted(HBM_BYTES_PER_S)}")
    bytes_total = 4.0 * batch * h * w * (8 + 1 + 1 + 1)
    return {
        "bytes": bytes_total,
        "hbm_gbps": rate / 1e9,
        "sol_seconds": bytes_total / rate,
    }
