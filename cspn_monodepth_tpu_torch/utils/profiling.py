"""Tracing and timing (the counterpart of cspn_monodepth_tpu/utils/profiling.py).

* `trace(logdir)`: `torch.profiler` over the host and, where the process
  has a card, the CUDA device; writes a trace that TensorBoard's profiler
  plugin and Chrome's trace viewer read, with every kernel by name (the
  CSPN kernels included).
* `StepTimer`: a wall-clock timer of steps that drops the warm-up steps and
  synchronizes the card at entry and exit, for steady-state step times.
* `marginal_chain`: the marginal time of one step of a serially dependent
  chain, the method the bench tools share.
* `device_profile` / `kernel_class`: one call under `torch.profiler`, its
  device time by kernel and by coarse class (convolution, BatchNorm,
  layout, CSPN, optimizer, copies, elementwise) against the host's wall
  time; `count_syncs`: the host-device synchronizations a call makes.
* `card`: the card's name and power limit as nvidia-smi reports them,
  written beside every time measured on it.
* `kernel_roofline`: the least time of the CSPN forward on this card (it is
  bound by its bytes: bytes over the device memory's rate), to set beside
  measured times.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
import warnings

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


def marginal_chain(fn, carry, params=None, n=10, reps=2, max_retries=3,
                   reset=None):
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

    Every chain starts from `carry`. Where fn also changes state in place
    (a train step's weights), `reset()` puts it back before every chain,
    outside the clock, as a JAX chain restarts from the same functional
    state.

    Returns (step_seconds, dispatch_seconds).
    """
    def chain(length):
        if reset is not None:
            reset()
            _sync()
        t0 = time.perf_counter()
        c = carry
        for _ in range(length):
            c = fn(c, params)
        _read_back(c)
        return time.perf_counter() - t0

    def run(length, r):
        chain(length)                       # warm
        return min(chain(length) for _ in range(r))

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


def kernel_class(name: str) -> str:
    """Coarse class of a profiler event by its name: a device kernel's, or
    on the CPU an aten operator's."""
    if "cspn_" in name or "adjoint_" in name:     # csrc/cspn_*.cu
        return "cspn"
    if "multi_tensor" in name or "foreach" in name:
        return "optimizer"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "layout"
    if "batch_norm" in name or "bn_fw" in name:
        return "batchnorm"
    if any(s in name for s in ("xmma", "gemm", "conv", "cudnn", "cutlass")):
        return "conv"
    return "elementwise"


def device_profile(fn, top: int = 12, device: str = "cuda") -> dict:
    """One call of fn under torch.profiler: the time of each kernel and
    their sum (`busy_ms`) against the host wall time of the call, by class
    (`kernel_class`) and the `top` kernels by time. On "cuda" the events
    are the device's (kernels, copies, memsets), and the times None where
    the profiler recorded none; on "cpu" they are the operators' self CPU
    times, which is what the CPU spends, not a device time."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if cuda:
        # Device-side events only: a host operator's row would count the
        # kernels it launched a second time.
        rows = ((e.key, e.self_device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    else:
        rows = ((e.key, e.self_cpu_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU)
    kernels = sorted(((k, ms) for k, ms in rows if ms > 0),
                     key=lambda kv: -kv[1])
    if not kernels:
        return dict(wall_ms=wall_ms, busy_ms=None, idle_share=None,
                    by_class=None, top=[])
    busy_ms = sum(ms for _, ms in kernels)
    by_class: dict[str, float] = {}
    for k, ms in kernels:
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0.0) + ms
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, by_class=by_class,
                top=[[k[:80], ms] for k, ms in kernels[:top]])


def count_syncs(fn) -> list[str]:
    """The messages of the host-device synchronizations that fn() makes on
    the card, as torch.cuda.set_sync_debug_mode("warn") reports them (one
    warning each; not the mode's own notice that it is a prototype); the
    mode is restored after."""
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(before)
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


def card() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (a card
    may be set below its maximum power and then runs slower under load)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]
