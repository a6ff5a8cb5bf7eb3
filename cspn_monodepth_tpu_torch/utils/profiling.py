"""Tracing and timing (the counterpart of cspn_monodepth_tpu/utils/profiling.py).

* `trace(logdir)`: `torch.profiler` over the host and, where the process
  has a card, the CUDA device; writes a trace that TensorBoard's profiler
  plugin and Chrome's trace viewer read, with every kernel by name (the
  CSPN kernels included), and the program's spans among the host's
  events.
* `span(name)`, `count(name, n)`, `next_call()`, `collected()`: the
  program's own spans and counters, live only while a `torch.profiler`
  records. A span is a `record_function` range of the profiler's trace
  and an entry of an in-memory collection: its name, the span enclosing it
  on its thread, the `train_step` or `predict_batch` call it ran in, its
  host ms and, on the card, its ms on the device's timeline (a pair of
  CUDA events). Each profiled stretch gets a fresh collection.
* `marginal_chain`: the marginal time of one step of a serially dependent
  chain, the method the bench tools share.
* `device_profile` / `kernel_class`: one call under `torch.profiler`, its
  device time by kernel and by coarse class (convolution, BatchNorm,
  layout, CSPN, optimizer, copies, elementwise) against the host's wall
  time; `count_syncs`: the host-device synchronizations a call makes.
* `card`: the card's name and power limit as nvidia-smi reports them,
  written beside every time measured on it.
"""

from __future__ import annotations

import contextlib
import subprocess
import threading
import time
import warnings

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block's host and device activity into `logdir`; yields
    the profiler, whose `events()` hold the trace once the block ends."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


# ------------------------------------------------------------------ spans

_OFF = contextlib.nullcontext()


class _Collection:
    """One profiled stretch: its spans in the order they opened, the CUDA
    events of those not yet resolved, its counters."""

    def __init__(self):
        self.spans: list[dict] = []
        self.events: list[tuple] = []
        self.counters: dict[str, float] = {}


class _SpanState:
    """The process's spans: the current (or last) stretch's collection,
    whether the last look found the profiler on, the call count, and each
    thread's stack of open span names."""

    def __init__(self):
        self.collection = _Collection()
        self.live = False
        self.call = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def look(self) -> bool:
        """Whether a profiler records. The first look that finds it on
        after one that found it off starts a fresh collection."""
        if not _autograd_profiler._is_profiler_enabled:
            self.live = False
            return False
        if not self.live:
            with self.lock:
                if not self.live:
                    self.collection = _Collection()
                    self.live = True
        return True

    def stack(self) -> list[str]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_SPANS = _SpanState()


class _Span:
    """A live span: a `record_function` range around the block, its entry
    in the collection, the host's clock and, on the card, a pair of timing
    events on the current stream."""

    __slots__ = ("name", "_range", "_coll", "_entry", "_stack", "_start",
                 "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _SPANS.look()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._stack = _SPANS.stack()
        self._entry = {"name": self.name,
                       "parent": self._stack[-1] if self._stack else None,
                       "call": _SPANS.call, "host_ms": None,
                       "device_ms": None}
        self._coll = _SPANS.collection
        self._coll.spans.append(self._entry)
        self._stack.append(self.name)
        self._start = None
        if torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._entry["host_ms"] = (time.perf_counter_ns() - self._t0) / 1e6
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._coll.events.append((self._entry, self._start, end))
        self._stack.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one phase of the program. While no
    profiler records it is one shared null context; while one does, a
    `record_function(name)` range of the same trace and an entry
    {name, parent, call, host_ms, device_ms} of the collection."""
    if not _autograd_profiler._is_profiler_enabled:
        _SPANS.live = False
        return _OFF
    return _Span(name)


def count(name: str, n: float) -> None:
    """Add n to the collection's counter `name`, while spans are live."""
    if _SPANS.look():
        with _SPANS.lock:
            counters = _SPANS.collection.counters
            counters[name] = counters.get(name, 0) + n


def next_call() -> None:
    """Count one call of a program entry (`Trainer.train_step`,
    `DepthPredictor.predict_batch`), while spans are live: the spans it
    opens, the autograd thread's included, carry its number as `call`."""
    if _SPANS.look():
        _SPANS.call += 1


def collected() -> dict:
    """{"spans": [...], "counters": {...}} of the current or last profiled
    stretch. Resolves the spans' CUDA events into device_ms (waiting for
    them, which the stretch's closing synchronize has already done);
    device_ms stays None for a span that ran off the card. Read after the
    stretch, it also closes it: the next span that finds a profiler on
    starts a fresh collection."""
    _SPANS.look()
    coll = _SPANS.collection
    with _SPANS.lock:
        events, coll.events = coll.events, []
    for entry, start, end in events:
        end.synchronize()
        entry["device_ms"] = start.elapsed_time(end)
    return {"spans": [dict(s) for s in coll.spans],
            "counters": dict(coll.counters)}


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


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


def event_times(averages, events, cuda: bool) -> list[tuple[str, float]]:
    """(name, ms) of each row of a profile's `key_averages()`: with `cuda`
    the device's events (a host operator's row would count the kernels it
    launched a second time) but the device timeline's copies of the
    program's spans (`record_function` ranges, user annotations among
    `events`), which are not device work; else the CPU's operators."""
    if not cuda:
        return [(e.key, e.self_cpu_time_total / 1e3) for e in averages
                if e.device_type == torch.autograd.DeviceType.CPU]
    spans = {e.name for e in events if e.is_user_annotation}
    return [(e.key, e.self_device_time_total / 1e3) for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in spans]


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
    kernels = sorted(((k, ms) for k, ms in
                      event_times(prof.key_averages(), prof.events(), cuda)
                      if ms > 0), key=lambda kv: -kv[1])
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
