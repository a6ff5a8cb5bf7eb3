"""Percent of the traced device-busy time (the union of the device events'
intervals, tracing.busy_us) that the CSPN's kernels (class "cspn":
csrc/cspn_kxk.cu's cspn_kxk_* and the 3x3 branch's K5/K6) take in a
CSPN++ train step. None without device events."""

from benchmark.tracing import busy_us, device_ms, kernel_class


def read(record: dict):
    ms = device_ms(record, lambda n: kernel_class(n) == "cspn")
    busy = busy_us(record) / 1e3 if record.get("kernels") else 0.0
    if ms is None or not busy:
        return None
    return 100.0 * ms / busy
