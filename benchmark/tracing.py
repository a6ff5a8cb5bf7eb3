"""The traced stretch as plain data, and the reductions the per-layer
metrics share.

A traced run profiles a fixed count of steps or requests after its window
under `torch.profiler` and keeps a `record` (a dict of lists and numbers):

* "kernels": [name, start_us, end_us] of every device event (kernels,
  copies, memsets);
* "spans": [name, start_us, end_us] of the harness's own spans ("bm.*",
  `record_function` ranges around each call into the program);
* "ops": [name, start_us, end_us] of the host operators directly under a
  harness span;
* "stretch": [start_us, end_us] of the profiled stretch, "calls" the
  number of steps or requests in it;
* "window": the untraced window's "calls", "images", "seconds",
  "img_per_s" and "peak_bytes";
* "device_name", "batch", "counts" (the configuration's FLOPs and bytes).

The table of peaks and `kernel_class` live here too: a frozen copy of the
program's `utils/profiling.py:kernel_class`, so that a change of the
program cannot move the yardstick, which also names the normalization
pair's `gates9` kernels CSPN and cuDNN's `bn_bw` BatchNorm.
"""

from __future__ import annotations

import bisect

# NVIDIA's data sheet, H100 SXM5 at its 700 W limit: dense bf16 tensor-core
# FLOP/s and HBM3 bytes/s.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                                   "hbm_bytes_per_s": 3.35e12}}


def peak(record: dict, key: str) -> float | None:
    entry = PEAKS.get(record.get("device_name", ""))
    return None if entry is None else entry[key]


def kernel_class(name: str) -> str:
    """Coarse class of a device event by its name."""
    if "cspn_" in name or "adjoint_" in name or "gates9" in name:
        return "cspn"
    if "multi_tensor" in name or "foreach" in name:
        return "optimizer"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "layout"
    if "batch_norm" in name or "bn_fw" in name or "bn_bw" in name:
        return "batchnorm"
    if any(s in name for s in ("xmma", "gemm", "conv", "cudnn", "cutlass")):
        return "conv"
    return "elementwise"


def device_ms(record: dict, keep) -> float | None:
    """Summed ms of the device events whose name `keep` accepts, or None
    when the record holds no device event."""
    kernels = record.get("kernels") or []
    if not kernels:
        return None
    return sum(e - s for n, s, e in kernels if keep(n)) / 1e3


def busy_intervals(record: dict) -> list[tuple[float, float]]:
    """The union of the device events' intervals inside the stretch."""
    lo, hi = record["stretch"]
    merged: list[list[float]] = []
    for _, s, e in sorted(record.get("kernels") or [], key=lambda k: k[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_us(record: dict) -> float:
    return sum(e - s for s, e in busy_intervals(record))


def idle_share(record: dict) -> float | None:
    """Percent of the window in which the device was idle: one minus the
    device's busy time a call in the traced stretch (the union of its
    events' intervals over the stretch's calls) times the window's calls
    over the window's seconds. The profiler slows the host (a single NYU
    request 8.9 -> 16.9 ms on the H100) but not the device's work, so the
    busy time is read from the trace and the wall time from the untraced
    window. None when the record holds no device event."""
    if not record.get("kernels"):
        return None
    busy_s = busy_us(record) / 1e6 / record["calls"]
    window = record["window"]
    return 100.0 * (1.0 - busy_s * window["calls"] / window["seconds"])


def _open_at(starts: list, intervals: list, t: float) -> str | None:
    """The name of the interval of `intervals` (sequential, sorted by
    start; `starts` their starts) open at t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and intervals[i][1] <= t < intervals[i][2]:
        return intervals[i][0]
    return None


def idle_gaps(record: dict, top: int = 10) -> list[list]:
    """The `top` longest gaps between device events inside the stretch,
    [label, seconds], labelled by the harness span open at the gap's start
    and the host operator under it ("host" where none was)."""
    lo, hi = record["stretch"]
    busy = busy_intervals(record)
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    spans = sorted(record.get("spans") or [], key=lambda k: k[1])
    ops = sorted(record.get("ops") or [], key=lambda k: k[1])
    span_starts = [s for _, s, _ in spans]
    op_starts = [s for _, s, _ in ops]
    gaps = []
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            span = _open_at(span_starts, spans, s) or "outside"
            op = _open_at(op_starts, ops, s) or "host"
            gaps.append([f"{span}/{op}", (e - s) / 1e6])
    return sorted(gaps, key=lambda g: -g[1])[:top]


def device_ops(record: dict, top: int = 10) -> list[list]:
    """The `top` device operations by summed time, [class/name, seconds]."""
    totals: dict[str, float] = {}
    for name, s, e in record.get("kernels") or []:
        key = f"{kernel_class(name)}/{name[:96]}"
        totals[key] = totals.get(key, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def by_class(record: dict) -> dict[str, float]:
    """Device ms of each kernel class over the stretch."""
    out: dict[str, float] = {}
    for name, s, e in record.get("kernels") or []:
        c = kernel_class(name)
        out[c] = out.get(c, 0.0) + (e - s) / 1e3
    return out
